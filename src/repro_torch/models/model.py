"""Dense- and moe-family decoder as ``nn.Module``s — port of the
dense/moe part of ``repro.models.model``: the parameters, ``forward``
and ``loss_fn``.

Weights keep the reference's (in, out) layout, so every projection is
``x @ w`` on both sides and ``params_from_jax`` is a plain copy.  The
modules read by key (``ParamModule``), so the layer functions take them
where the reference takes its params dicts.  The parameters are
trainable; serving runs under ``torch.inference_mode()``, which records
no graph.
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamModule, _dtype, apply_norm,
                                       embed_apply, mlp_apply,
                                       unembed_apply)
from repro_torch.models.moe import MoE, moe_apply


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


class _Init:
    """Seeded weight factory on the target device: normal × 1/√d_in
    (the reference's ``dense_init`` and ``moe_init``), cast to the model
    dtype unless another is asked for."""

    def __init__(self, cfg: ModelConfig, device, generator):
        self.dt, self.dev, self.gen = _dtype(cfg), device, generator

    def _normal(self, shape, scale: float, dtype):
        w = torch.randn(shape, generator=self.gen, device=self.dev,
                        dtype=torch.float32)
        return _param((w * scale).to(dtype or self.dt))

    def dense(self, d_in: int, d_out: int, scale: Optional[float] = None,
              dtype: Optional[torch.dtype] = None):
        s = scale if scale is not None else 1.0 / np.sqrt(d_in)
        return self._normal((d_in, d_out), s, dtype)

    def experts(self, e: int, d_in: int, d_out: int):
        return self._normal((e, d_in, d_out), 1.0 / np.sqrt(d_in), None)

    def ones(self, n: int):
        return _param(torch.ones(n, dtype=torch.float32, device=self.dev))

    def zeros(self, n: int):
        return _param(torch.zeros(n, dtype=torch.float32, device=self.dev))


class Norm(ParamModule):
    """rmsnorm: ``scale``; layernorm: ``scale`` and ``bias``;
    nonparam_ln (OLMo): no parameters."""

    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        if cfg.norm_type not in ("rmsnorm", "layernorm", "nonparam_ln"):
            raise ValueError(cfg.norm_type)
        if cfg.norm_type != "nonparam_ln":
            self.scale = init.ones(cfg.d_model)
        if cfg.norm_type == "layernorm":
            self.bias = init.zeros(cfg.d_model)


class Attention(ParamModule):
    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        self.wq = init.dense(d, cfg.n_heads * hd)
        self.wk = init.dense(d, cfg.n_kv_heads * hd)
        self.wv = init.dense(d, cfg.n_kv_heads * hd)
        self.wo = init.dense(cfg.n_heads * hd, d)
        if cfg.qk_norm:
            self.q_scale = init.ones(hd)
            self.k_scale = init.ones(hd)


class MLP(ParamModule):
    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        if cfg.mlp_variant != "swiglu":
            raise NotImplementedError(
                f"mlp_variant={cfg.mlp_variant!r}: the port runs SwiGLU; "
                f"GELU comes with the audio family (ROADMAP queue A "
                f"item 4)")
        self.wi = init.dense(cfg.d_model, cfg.d_ff)
        self.wg = init.dense(cfg.d_model, cfg.d_ff)
        self.wo = init.dense(cfg.d_ff, cfg.d_model)


class DecoderLayer(ParamModule):
    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        self.ln1 = Norm(cfg, init)
        self.attn = Attention(cfg, init)
        self.ln2 = Norm(cfg, init)
        if cfg.moe:
            self.moe = MoE(cfg, init)
        else:
            self.mlp = MLP(cfg, init)


class Embed(ParamModule):
    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        self.embedding = init.dense(cfg.vocab_size, cfg.d_model, scale=0.02)
        if not cfg.tie_embeddings:
            self.unembed = init.dense(cfg.d_model, cfg.vocab_size)


class DenseModel(ParamModule):
    """Pre-norm decoder (attention + SwiGLU MLP, or the MoE FFN when
    ``cfg.moe``) with a ``ModuleList`` of layers — the dense family
    (qwen3-4b, olmo-1b and kin) and the moe family
    (qwen3-moe-235b-a22b, grok-1-314b).  ``forward`` /
    ``loss_fn`` train it; the serving functions (``models.decode``) run
    it layer by layer against the KV cache.  ``params["layers"][i]``
    reads like the reference's stacked params sliced at layer i.
    ``device`` defaults to ``"cuda"`` and raises without a GPU."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_family(cfg)
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":   # meta: shapes only
            generator = torch.Generator(device=dev).manual_seed(seed)
        init = _Init(cfg, dev, generator)
        self.embed = Embed(cfg, init)
        self.final_ln = Norm(cfg, init)
        self.layers = nn.ModuleList(DecoderLayer(cfg, init)
                                    for _ in range(cfg.n_layers))


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r}: the PyTorch port runs the dense and "
            f"moe families; vlm, audio, hybrid and ssm are ROADMAP queue A "
            f"item 4")


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: upcast is exact
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # owning copy


def params_from_jax(np_params: Mapping, cfg: ModelConfig,
                    device="cuda") -> DenseModel:
    """Build the port's model from the reference's parameter pytree
    (``repro.models.model.init_params`` output with leaves converted to
    numpy by the caller; ``params["layers"]`` stacked on a leading layer
    axis), so both sides compute with identical weights."""
    dev = resolve_device(device)
    model = DenseModel(cfg, device="meta")
    loaded = {}

    def put(path: str, a):
        loaded[path] = _param(_to_tensor(a, dev))

    for group in ("embed", "final_ln"):
        for name, a in np_params[group].items():
            put(f"{group}.{name}", a)
    for group, leaves in np_params["layers"].items():
        for name, a in leaves.items():
            a = np.asarray(a)
            for i in range(cfg.n_layers):
                put(f"layers.{i}.{group}.{name}", a[i])
    missing = set(model.state_dict()) - set(loaded)
    extra = set(loaded) - set(model.state_dict())
    if missing or extra:
        raise ValueError(f"params_from_jax: missing {sorted(missing)}, "
                         f"unexpected {sorted(extra)}")
    model.load_state_dict(loaded, assign=True)
    return model


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def _decoder_block_apply(p, cfg: ModelConfig, x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (x, the layer's aux loss: the router's, 0 for a dense layer)."""
    h = apply_norm(p["ln1"], cfg, x)
    x = x + attn.attention_apply(p["attn"], cfg, h)
    h = apply_norm(p["ln2"], cfg, x)
    if cfg.moe:
        y, aux = moe_apply(p["moe"], cfg, h)
        return x + y, aux
    return (x + mlp_apply(p["mlp"], cfg, h),
            torch.zeros((), dtype=torch.float32, device=x.device))


# remat="dots" (the reference's checkpoint_dots_with_no_batch_dims): the
# products with no batch dimension, which are these ops under autograd
# (a projection or MLP matmul of a (tokens, d) operand folds to mm); the
# batched ones (bmm: attention scores, the experts) and everything
# elementwise are recomputed
_SAVED_BY_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _remat(cfg: ModelConfig, fn):
    """``"full"``: recompute the whole layer in the backward
    (``torch.utils.checkpoint``, non-reentrant); ``"dots"``: the same,
    but the outputs of ``_SAVED_BY_DOTS`` are kept from the forward;
    ``"none"``: keep its activations."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat={cfg.remat!r}")
    kw = {} if cfg.remat == "full" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _SAVED_BY_DOTS)}

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def forward(model: DenseModel, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logits fp32 (B, S, V), aux_loss: the layers' router losses
    summed in layer order, 0 for the dense family)."""
    _check_family(cfg)
    x = embed_apply(model["embed"], batch["tokens"]).to(_dtype(cfg))
    block = _remat(cfg, lambda p, h: _decoder_block_apply(p, cfg, h))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in model["layers"]:
        x, a = block(p, x)
        aux = aux + a
    x = apply_norm(model["final_ln"], cfg, x)
    return unembed_apply(model["embed"], cfg, x), aux


def loss_fn(model: DenseModel, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (labels pre-shifted by the pipeline)."""
    logits, aux = forward(model, cfg, batch)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask
    loss = (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return loss + 0.01 * aux, {"nll": loss, "aux": aux}
