"""Training, prefill and serving step functions — port of
``repro.train.step``.

The train state is ``{"params": model, "opt": {"m", "v", "step"}}`` (and
``"err"`` with gradient compression): the model's parameters and the
fp32 moments, all updated in place by the step.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.distributed import ctx as dctx
from repro_torch.distributed.sharding import DataRows, ShardLayout, block
from repro_torch.launch.mesh import _all_gather, _all_reduce, make_local_mesh
from repro_torch.models import decode as dec
from repro_torch.models import model as mdl
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptConfig, adamw_update, init_opt_state


def make_train_step(cfg: ModelConfig, opt: OptConfig, micro_steps: int = 1,
                    mesh=None):
    """→ train_step(state, batch) -> (state, metrics), run by every rank
    of ``mesh`` (a ("data", "model") ``launch.mesh.ShardMesh``; default
    the one-rank ``make_local_mesh()``, on which every collective below
    is the identity) with the same global ``batch`` on the rank's
    device, ``state`` sharded by ``init_train_state(mesh=)``:

    * ``micro_steps > 1`` splits the batch and accumulates the
      microbatch gradients in fp32 before the update, as the reference's
      scan does;
    * each microbatch's rows shard over the data axes (a batch that does
      not divide replicates, as ``batch_specs`` says);
    * the rank's loss is its share of the global one: its rows' token
      NLL over the whole microbatch's token count, plus its aux over the
      data shard count, so the shares sum to the reference's loss over
      the data axes; over "model" every rank holds the whole of its
      rows' loss (the vocab-parallel NLL and the MoE aux are summed or
      computed whole on each), so the "model" ranks' shares are equal,
      not parts;
    * the forward reads the sharded parameters through
      ``ShardLayout.view`` (FSDP gathers around each use; over "model"
      the attention, MLP, MoE experts, embedding, unembed and loss
      compute on the rank's shard), and the backward reduce-scatters
      the gradients over the data axes; leaves replicated over a data
      axis are summed over it after the backward;
    * with context parallelism asked for when the step is made
      (``distributed.ctx.set_context_parallel(True)`` with a mesh
      installed, as the reference's dry run sets it for train cells),
      a rank's layers run on its contiguous 1/m of the sequence over
      "model" (``ShardLayout(cp=True)``): the attention on its query
      rows against the whole sequence's K/V, every region entered
      through the sequence's all-gather and left through a
      reduce-scatter, and a leaf read outside a region summed over
      "model" too (``ShardLayout.grad_sum_axes``); the head still sees
      the whole sequence, so the loss keeps the form above;
    * AdamW runs on the rank's blocks, with the global norm and absmax.

    On more than one rank the data-parallel sums, the row-parallel
    out-projections and the vocab-parallel logsumexp add fp32 partial
    sums in another order than one device: not bitwise."""
    # the step reads only the mesh's axes; the caller's tensors say where
    # it computes
    mesh = make_local_mesh(device="meta") if mesh is None else mesh
    layout = ShardLayout(cfg, mesh, cp=dctx.cp_enabled())
    nd = math.prod(mesh.shape[a] for a in layout.data)

    def shard_loss(view, mb):
        # a microbatch that does not divide by the data shards replicates:
        # every data rank then takes all of it, at 1 / nd of the weight
        copies = nd if mb["labels"].shape[0] % nd else 1
        local = mb if copies > 1 else {k: block(t, (layout.data,), mesh)
                                       for k, t in mb.items()}
        total = mb["loss_mask"].sum() if "loss_mask" in mb else \
            torch.tensor(float(mb["labels"].numel()),
                         device=mb["labels"].device)
        nll_sum, _, aux = mdl.nll_terms(view, cfg, local)
        nll = nll_sum / (total.clamp(min=1.0) * copies)
        aux = aux / nd
        return nll + 0.01 * aux, torch.stack([nll.detach(), aux.detach()])

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        model = state["params"]
        params = dict(model.named_parameters())
        view = layout.view(model)
        n = next(iter(batch.values())).shape[0] // micro_steps
        parts_sum, grads = None, None
        for i in range(micro_steps):
            mb = {k: t[i * n:(i + 1) * n] for k, t in batch.items()}
            loss_r, parts = shard_loss(view, mb)
            g_i = torch.autograd.grad(loss_r, list(params.values()))
            if micro_steps == 1:
                grads = dict(zip(params, g_i))
            else:
                if grads is None:
                    grads = {name: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device)
                             for name, p in params.items()}
                for name, g in zip(params, g_i):
                    grads[name] += g
            parts_sum = parts if parts_sum is None else parts_sum + parts
        if micro_steps > 1:
            grads = {name: g / micro_steps for name, g in grads.items()}
        # leaves replicated over a data axis (and under context
        # parallelism over "model", outside a region): sum their
        # gradients over it (one flat fp32 all-reduce per set of axes)
        by_axes: Dict[tuple, list] = {}
        for name in grads:
            axes = layout.grad_sum_axes(name)
            if axes:
                by_axes.setdefault(axes, []).append(name)
        for axes, names in by_axes.items():
            flat = _all_reduce(torch.cat([grads[n].float().reshape(-1)
                                          for n in names]), mesh, axes)
            for name, g in zip(names, flat.split(
                    [grads[n].numel() for n in names])):
                grads[name] = g.reshape(grads[name].shape)
        nll, aux = _all_reduce(parts_sum, mesh, layout.data) / micro_steps
        loss = nll + 0.01 * aux
        _, opt_state, err, om = adamw_update(
            opt, params, grads, state["opt"], state.get("err"), mesh=mesh,
            specs=layout.specs)
        state["opt"] = opt_state
        if err is not None:
            state["err"] = err
        parts = {"nll": nll, "aux": aux} if micro_steps == 1 else \
            {"nll": loss, "aux": torch.zeros((), device=loss.device)}
        return state, {"loss": loss, **parts, **om}

    train_step.layout = layout
    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """Forward only: last-position logits (B, V) fp32 for a full batch.

    Run by every rank of ``mesh`` (default the one-rank
    ``make_local_mesh()``, on which every collective below is the
    identity) with the same global ``batch`` and its shard of the model,
    as ``make_train_step``: the forward reads the sharded parameters
    through ``ShardLayout.view``, the batch rows shard over the data
    axes (a batch that does not divide replicates), and the rank's
    last-position logits are gathered into the global (B, V): over
    "model" where the vocabulary is split, then over the data axes.
    Under context parallelism (as ``make_train_step``) the layers run
    on the rank's rows and the vocab-parallel head on the gathered
    sequence, whose last row every rank holds; without a vocab region
    the head runs on the rank's rows, and the last row is gathered
    from the rank that holds it."""
    # the step reads only the mesh's axes; the caller's tensors say where
    # it computes
    mesh = make_local_mesh(device="meta") if mesh is None else mesh
    layout = ShardLayout(cfg, mesh, cp=dctx.cp_enabled())
    nd = math.prod(mesh.shape[a] for a in layout.data)

    def prefill_step(model, batch):
        rows = next(iter(batch.values())).shape[0]
        split = rows % nd == 0
        local = {k: block(t, (layout.data,), mesh) for k, t in batch.items()} \
            if split else batch
        view = layout.view(model)
        with torch.no_grad():
            logits, _ = mdl.forward(view, cfg, local)
            if view["embed"].tp is not None:
                last = _all_gather(logits[:, -1, :], mesh, 1, "model")
            elif layout.seq is not None:
                last = _all_gather(logits[:, -1:], mesh, 1, "model")[:, -1]
            else:
                last = logits[:, -1, :]
            return _all_gather(last, mesh, 0, layout.data) if split else last

    prefill_step.layout = layout
    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None, mode: str = "train"):
    """One-token decode against a serving cache (the decode shapes):
    ``serve_step(model, cache, tokens, pos)`` → (logits (B, 1, V) fp32,
    the cache, updated in place).

    Run by every rank of ``mesh`` (default the one-rank
    ``make_local_mesh()``, on which every collective below is the
    identity and the step is ``models.decode.serve_step`` itself) with
    the same global ``tokens`` (B, 1) and ``pos`` (a scalar or (B,)),
    ``model`` sharded under ``mode``'s specs (``init_train_state(mesh=,
    mode=)``: "train" or "infer_tp") and ``cache`` the rank's blocks of
    the serving cache (``ShardLayout.block_cache``): the step reads the
    sharded parameters through ``ShardLayout.view``, takes the rank's
    rows of ``tokens`` and ``pos`` (a batch that does not divide by the
    data shards replicates, as ``batch_specs`` says, and so does the
    cache's batch dim), runs the decode layers on the rank's heads
    where a region holds them, updates the rank's cache blocks in
    place, and returns the global logits: gathered over "model" where
    the vocabulary is split, then over the data axes.  A MoE layer
    routes the batch gathered over the data axes where a rank's rows do
    not fill whole groups (``moe_apply``), as one device groups them.

    The cache's layout is the layout's (``ShardLayout.cache_specs``).
    Under ``distributed.sharding.CACHE_SEQ_SHARD`` (the default, as it
    stands when the step is made) it is the reference's: a rank holds
    its contiguous 1/m of every slot's keys over "model" (self-attention
    and, where m divides it, the context), its plan on its key blocks;
    each attention layer plans and attends over the rank's keys, one
    top-k threshold bisected over the whole row, and the ranks' partial
    outputs combine (context-parallel decode,
    ``models.attention.attention_decode``).  It takes the contiguous
    cache and the exact re-plan every step only (a paged cache, and
    every other plan mode, raise).  With the flag False, the head
    layout: the KV heads and plan rows over "model" where a region
    reads them.

    On more than one rank the row-parallel out-projections, the
    vocab-parallel sums and the softmax's combine add fp32 partial sums
    in another order than one device: not bitwise."""
    mesh = make_local_mesh(device="meta") if mesh is None else mesh
    layout = ShardLayout(cfg, mesh, mode=mode)
    rows = DataRows(mesh, layout.data)

    def serve_step(model, cache, tokens, pos):
        split = tokens.shape[0] % rows.n == 0
        if split:
            tokens = rows.take(tokens)
            if getattr(pos, "ndim", 0) == 1:
                pos = rows.take(torch.as_tensor(pos))
        view = layout.view(model, rows=rows if split and rows.n > 1
                           else None)
        logits, cache = dec.serve_step(view, cfg, cache, tokens, pos)
        with torch.no_grad():
            if view["embed"].tp is not None:
                logits = _all_gather(logits, mesh, 2, "model")
            if split:
                logits = rows.gather(logits)
        return logits, cache

    serve_step.layout = layout
    return serve_step


def init_train_state(cfg: ModelConfig, opt: OptConfig, *, seed: int = 0,
                     device="cuda", model=None, mesh=None,
                     mode: str = "train") -> Dict[str, Any]:
    """A fresh train state: ``model`` or the family's ``Model`` with random
    weights from ``seed`` on ``device`` (default ``"cuda"``; raises
    without a GPU), zero fp32 moments, and zero error-feedback buffers
    with ``opt.compress_grads``.  On a ``mesh`` every rank builds the
    same global model and keeps its block of each parameter under
    ``mode``'s specs (``ShardLayout.shard_``; the whole of it on one
    rank; "infer_tp" for a decode step that keeps the weights whole over
    the data axes); moments and error buffers are made from the blocks,
    so they shard like their parameters."""
    dev = resolve_device(device)
    if model is None:
        model = mdl.Model(cfg, device=dev, seed=seed)
    if mesh is not None:
        ShardLayout(cfg, mesh, mode=mode).shard_(model)
    params = dict(model.named_parameters())
    state = {"params": model, "opt": init_opt_state(params)}
    if opt.compress_grads:
        state["err"] = {n: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                        for n, p in params.items()}
    return state
