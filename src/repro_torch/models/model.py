"""Dense-family decoder as ``nn.Module``s — port of the dense part of
``repro.models.model``: the parameters, ``forward`` and ``loss_fn``.

Weights keep the reference's (in, out) layout, so every projection is
``x @ w`` on both sides and ``params_from_jax`` is a plain copy.  The
modules read by key (``ParamModule``), so the layer functions take them
where the reference takes its params dicts.  The parameters are
trainable; serving runs under ``torch.inference_mode()``, which records
no graph.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamModule, _dtype, apply_norm,
                                       embed_apply, mlp_apply,
                                       unembed_apply)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


class _Init:
    """Seeded weight factory on the target device: normal × 1/√d_in
    (the reference's ``dense_init``), cast to the model dtype."""

    def __init__(self, cfg: ModelConfig, device, generator):
        self.dt, self.dev, self.gen = _dtype(cfg), device, generator

    def dense(self, d_in: int, d_out: int, scale: Optional[float] = None):
        s = scale if scale is not None else 1.0 / np.sqrt(d_in)
        w = torch.randn((d_in, d_out), generator=self.gen, device=self.dev,
                        dtype=torch.float32)
        return _param((w * s).to(self.dt))

    def ones(self, n: int):
        return _param(torch.ones(n, dtype=torch.float32, device=self.dev))


class Norm(ParamModule):
    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        if cfg.norm_type != "rmsnorm":
            raise NotImplementedError(
                f"norm_type={cfg.norm_type!r}: the port's slice 1 serves "
                f"the rmsnorm dense family; other families are slice 4")
        self.scale = init.ones(cfg.d_model)


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
                f"mlp_variant={cfg.mlp_variant!r}: slice 1 serves the "
                f"SwiGLU dense family; other families are slice 4")
        self.wi = init.dense(cfg.d_model, cfg.d_ff)
        self.wg = init.dense(cfg.d_model, cfg.d_ff)
        self.wo = init.dense(cfg.d_ff, cfg.d_model)


class DecoderLayer(ParamModule):
    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        self.ln1 = Norm(cfg, init)
        self.attn = Attention(cfg, init)
        self.ln2 = Norm(cfg, init)
        self.mlp = MLP(cfg, init)


class Embed(ParamModule):
    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        self.embedding = init.dense(cfg.vocab_size, cfg.d_model, scale=0.02)
        if not cfg.tie_embeddings:
            self.unembed = init.dense(cfg.d_model, cfg.vocab_size)


class DenseModel(ParamModule):
    """Pre-norm decoder (attention + SwiGLU MLP) with a ``ModuleList`` of
    layers — the dense family (qwen3-4b and kin).  ``forward`` /
    ``loss_fn`` train it; the serving functions (``models.decode``) run
    it layer by layer against the KV cache.  ``params["layers"][i]``
    reads like the reference's stacked params sliced at layer i.
    ``device`` defaults to ``"cuda"`` and raises without a GPU."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != "dense" or cfg.moe:
            raise NotImplementedError(
                f"family {cfg.family!r}: slice 1 of the PyTorch port "
                f"serves the dense family; moe and the others are slice 4")
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":   # meta: shapes only
            generator = torch.Generator(device=dev).manual_seed(seed)
        init = _Init(cfg, dev, generator)
        self.embed = Embed(cfg, init)
        self.final_ln = Norm(cfg, init)
        self.layers = nn.ModuleList(DecoderLayer(cfg, init)
                                    for _ in range(cfg.n_layers))


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

    for name, a in np_params["embed"].items():
        put(f"embed.{name}", a)
    put("final_ln.scale", np_params["final_ln"]["scale"])
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
                         ) -> torch.Tensor:
    h = apply_norm(p["ln1"], cfg, x)
    x = x + attn.attention_apply(p["attn"], cfg, h)
    h = apply_norm(p["ln2"], cfg, x)
    return x + mlp_apply(p["mlp"], cfg, h)


def _remat(cfg: ModelConfig, fn):
    """``"full"``: recompute the whole layer in the backward
    (``torch.utils.checkpoint``, non-reentrant); ``"none"``: keep its
    activations.  ``"dots"`` (save matmul outputs only) is not ported."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        def run(*args):
            if not torch.is_grad_enabled():
                return fn(*args)
            return checkpoint(fn, *args, use_reentrant=False)
        return run
    raise NotImplementedError(
        f"remat={cfg.remat!r}: only 'full' and 'none' are ported; the "
        f"'dots' policy is queued on the PyTorch port's ROADMAP")


def forward(model: DenseModel, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logits fp32 (B, S, V), aux_loss).  Dense family only, whose
    aux loss is 0 (the moe router's load-balancing term is slice 4)."""
    if cfg.family != "dense" or cfg.moe:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port's forward covers the dense "
            f"family; moe and the others are slice 4")
    x = embed_apply(model["embed"], batch["tokens"]).to(_dtype(cfg))
    block = _remat(cfg, lambda p, h: _decoder_block_apply(p, cfg, h))
    for p in model["layers"]:
        x = block(p, x)
    x = apply_norm(model["final_ln"], cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
