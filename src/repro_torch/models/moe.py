"""Mixture-of-Experts FFN — port of ``repro.models.moe``: GShard-style
grouped dense dispatch.

Token-choice top-k routing with per-group expert capacity: tokens are
blocked into groups of ``moe_group_size``; inside a group each expert
accepts at most ``C = ceil(group·top_k/E · capacity_factor)`` tokens,
by position in expert (a cumulative count in (token, k-slot) order);
overflow drops, as in GShard.  The top-k gates are renormalised, and
the Switch load-balancing loss is returned beside the output.

``moe_apply`` dispatches and combines by index: a kept (token, k-slot)
writes its token into its (expert, position) slot (a dropped one into a
sink row that is cut away, so every shape is static and the model
traces on meta tensors), every expert runs
one batched product over its (group × capacity) slots, and a token sums
its k slots' outputs in k-slot order, with no atomics, so a launch is
deterministic.  ``moe_apply_ref`` is the reference's own math, one-hot
dispatch and combine einsums, in plain PyTorch: the CPU tests and
``chip_smoke.py`` hold the index form to it.  Neither holds a custom
kernel: the reference's expert products are plain einsums too.

On a mesh (``distributed.sharding.ExpertParallel``) every "model" rank
routes the same tokens; a rank dispatches only the slots of its own
experts (``expert_shard="expert"``) or runs every expert on its d_ff
block (``"tensor"``), and its partial combine is summed over the ranks
in fp32 before the cast.  The capacity and drops are the routing's,
computed whole on every rank.  A data rank routes its own rows where
they fill whole groups of the batch, and the gathered batch where they
do not (the serving step's ``DataRows``).  Under context parallelism
the router sees the whole sequence, gathered from the ranks' rows, and
the rank keeps its rows of the summed combine.

The router runs in fp32 and never in TF32 (``_full_fp32``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamModule, argsort_descending


class MoE(ParamModule):
    """``router`` (d, E) fp32; ``wi``/``wg`` (E, d, f) and ``wo``
    (E, f, d) in the model dtype, each normal × 1/√d_in (the
    reference's ``moe_init``)."""

    def __init__(self, cfg, init):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = init.dense(d, e, dtype=torch.float32)
        self.wi = init.experts(e, d, f)
        self.wg = init.experts(e, d, f)
        self.wo = init.experts(e, f, d)


@contextlib.contextmanager
def _full_fp32():
    """fp32 products in full fp32 on the card, whatever the caller set."""
    m = torch.backends.cuda.matmul
    prev = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = prev


def _capacity(cfg, group: int) -> int:
    return max(1, int(math.ceil(group * cfg.experts_per_token
                                / cfg.n_experts * cfg.capacity_factor)))


def _groups(cfg, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) → (n_groups, group, D).  A token count that is not a
    multiple of the group raises the reference's reshape error."""
    b, s, d = x.shape
    t = b * s
    gsz = min(cfg.moe_group_size, t)
    n = t // gsz
    if n * gsz != t:
        raise TypeError(f"cannot reshape array of shape {(t, d)} (size "
                        f"{t * d}) into shape {(n, gsz, d)} (size "
                        f"{n * gsz * d})")
    return x.reshape(n, gsz, d)


@dataclasses.dataclass
class Route:
    """One call's routing, per (group, token, k-slot): ``expert_ids``
    int32, renormalised ``gates`` fp32, ``keep`` (the expert had room)
    and ``pie`` (position in expert, 0 where dropped); ``probs`` (G, T,
    E) fp32 and the capacity ``cap``."""
    probs: torch.Tensor
    expert_ids: torch.Tensor
    gates: torch.Tensor
    keep: torch.Tensor
    pie: torch.Tensor
    cap: int


def _gates(probs: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The top-k probabilities, renormalised over the k slots."""
    gates = torch.gather(probs, -1, ids.long())
    return gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(ids, n)`` (int64) as one comparison with ``arange``:
    the same ops on every device.  ``F.one_hot`` itself checks its
    range on the CPU (a host sync), scatters on the card and compares on
    meta tensors, so the dry run's counted work would depend on the
    device."""
    return (ids.long()[..., None] == torch.arange(n, device=ids.device)
            ).long()


def route(p, cfg, tokens: torch.Tensor) -> Route:
    """Top-k token-choice routing of ``tokens`` (G, T, D) with capacity."""
    e, k = cfg.n_experts, cfg.experts_per_token
    ng, gsz = tokens.shape[:2]
    cap = _capacity(cfg, gsz)
    with _full_fp32():
        logits = torch.einsum("gtd,de->gte", tokens.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    ids = argsort_descending(probs)[..., :k]                  # (G, T, k)
    gates = _gates(probs, ids)
    # position in expert: earlier (token, k-slot) pairs on the same expert
    onehot = _one_hot(ids, e).reshape(ng, gsz * k, e)
    before = (torch.cumsum(onehot, dim=1) - onehot).reshape(ng, gsz, k, e)
    pie = torch.gather(before, -1, ids.long()[..., None])[..., 0]
    keep = pie < cap
    return Route(probs, ids, gates, keep, torch.where(keep, pie, 0), cap)


def _aux_loss(cfg, r: Route) -> torch.Tensor:
    """Switch-style load balancing: density · router mean · E² / k."""
    e, k = cfg.n_experts, cfg.experts_per_token
    counts = _one_hot(r.expert_ids, e).sum(dim=(1, 2))           # (G, E)
    density = counts.float() / r.expert_ids.shape[1]
    router_mean = r.probs.mean(dim=1)
    return (density * router_mean).sum(-1).mean() * (e ** 2) / k


def _experts(p, xin: torch.Tensor, partial: bool = False) -> torch.Tensor:
    """(E, N, D) slots through every expert's SwiGLU: (E, N, D).
    ``partial``: the experts hold their d_ff block, and the output is
    the block's fp32 share of the product, for the sum over ranks."""
    h = torch.bmm(xin, p["wi"])
    hg = torch.bmm(xin, p["wg"])
    if partial:
        return torch.bmm((F.silu(hg) * h).float(), p["wo"].float())
    return torch.bmm(F.silu(hg) * h, p["wo"])


def moe_apply(p, cfg, x: torch.Tensor):
    """x: (B, S, D) → (out (B, S, D), aux_loss fp32).  A ``p`` view with
    an ``ExpertParallel`` region (``p.tp``) runs the rank's share.  A
    view whose ``rows`` (``distributed.sharding.DataRows``) says ``x``
    is the rank's rows of a batch split over the data axes routes the
    gathered batch, and keeps the rank's rows of the output, wherever
    the rank's tokens do not fill whole groups of the batch (decode:
    S = 1): the groups, capacity and drops are then one device's."""
    rows = getattr(p, "rows", None)
    t = x.shape[0] * x.shape[1]
    if rows is not None and t % min(cfg.moe_group_size, t * rows.n):
        y, aux = _moe(p, cfg, rows.gather(x))
        return rows.take(y), aux
    seq = getattr(p, "seq", None)
    if seq is not None and getattr(p, "tp", None) is None:
        # context parallelism without a region: the whole sequence
        # routed as one device groups it, the rank's rows kept.  Every
        # rank's gradient is its rows' share, the aux loss's too: it
        # counts 1 / m of its gradient on each rank, all of its value
        y, aux = _moe(p, cfg, seq.gather(x))
        return seq.take(y), aux / seq.n + (aux - aux / seq.n).detach()
    return _moe(p, cfg, x)


def _moe(p, cfg, x: torch.Tensor):
    tp = getattr(p, "tp", None)
    if tp is not None:
        x = tp.tokens(x)
    b, s, d = x.shape
    tokens = _groups(cfg, x)
    r = route(p, cfg, tokens)
    e, k, cap = cfg.n_experts, cfg.experts_per_token, r.cap
    ids, gates, keep = r.expert_ids, r.gates, r.keep
    if tp is not None:
        # the routing and the aux loss stay whole on every rank; the
        # gates and the dispatched tokens enter the region, so their
        # gradients sum the ranks' shares of the combine
        e0, e = tp.experts(e)
        gates = _gates(tp.enter(r.probs), ids)
        tokens = tp.enter(tokens)
        keep = keep & (ids >= e0) & (ids < e0 + e)
        ids = (ids - e0).clamp(0, e - 1)
    ng, gsz = tokens.shape[:2]
    g_idx = torch.arange(ng, device=x.device)[:, None, None]
    slot = ((g_idx * e + ids) * cap + r.pie).reshape(-1)
    n_slots = ng * e * cap
    # dispatch: each kept (token, k-slot) owns its slot; empty slots are
    # 0.  A dropped pair writes to a sink row past the slots, cut away
    # after: the write has one shape whatever the routing
    sink = torch.where(keep.reshape(-1), slot, n_slots)
    src = tokens[:, :, None].expand(ng, gsz, k, d).reshape(-1, d)
    xin = tokens.new_zeros((n_slots + 1, d)).index_put((sink,), src)
    xin = xin[:n_slots].view(ng, e, cap, d).transpose(0, 1).reshape(
        e, ng * cap, d)
    out = _experts(p, xin, partial=tp is not None and tp.mode == "tensor")
    out = out.view(e, ng, cap, d).transpose(0, 1)
    got = out.reshape(ng * e * cap, d)[slot].view(ng, gsz, k, d)
    # combine: the gate in the activation dtype (the reference's
    # combine.astype(x.dtype)), summed in k-slot order in fp32
    w = torch.where(keep, gates, 0.0).to(x.dtype).float()
    y = w[..., 0, None] * got[:, :, 0].float()
    for j in range(1, k):
        y = y + w[..., j, None] * got[:, :, j].float()
    y = y.reshape(b, s, d)
    if tp is not None:
        y = tp.reduce(y)
    return y.to(x.dtype), _aux_loss(cfg, r)


def moe_apply_ref(p, cfg, x: torch.Tensor):
    """The reference's math literally: one-hot position in expert in
    fp32, (G, T, E, C) dispatch and combine tensors and einsums.
    → (out, aux, expert_ids (G, T, k), keep (G, T, k))."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    tokens = _groups(cfg, x)
    ng, gsz = tokens.shape[:2]
    cap = _capacity(cfg, gsz)
    with _full_fp32():
        logits = torch.einsum("gtd,de->gte", tokens.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    ids = argsort_descending(probs)[..., :k]
    gate = torch.gather(probs, -1, ids.long())
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    onehot = F.one_hot(ids.long(), e).float()                 # (G,T,k,E)
    flat = onehot.reshape(ng, gsz * k, e)
    pie = (torch.cumsum(flat, dim=1) - flat).reshape(ng, gsz, k, e)
    keep = (pie < cap) & (onehot > 0)
    pie = torch.where(keep, pie, 0.0)
    slot = F.one_hot(pie.long(), cap).float() * keep[..., None].float()
    dispatch = (onehot[..., None] * slot).sum(dim=2)          # (G,T,E,C)
    combine = (gate[..., None, None] * onehot[..., None] * slot).sum(dim=2)
    dt = x.dtype
    xin = torch.einsum("gtd,gtec->gecd", tokens, dispatch.to(dt))
    h = torch.einsum("gecd,edf->gecf", xin, p["wi"])
    hg = torch.einsum("gecd,edf->gecf", xin, p["wg"])
    out = torch.einsum("gecf,efd->gecd", F.silu(hg) * h, p["wo"])
    y = torch.einsum("gecd,gtec->gtd", out, combine.to(dt))
    density = onehot.sum(dim=2).mean(dim=1)
    aux = (density * probs.mean(dim=1)).sum(-1).mean() * (e ** 2) / k
    return y.reshape(b, s, d), aux, ids, keep.any(-1)
