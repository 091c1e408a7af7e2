"""The six model families as ``nn.Module``s — port of
``repro.models.model``: the parameters, ``forward`` and ``loss_fn``.

The vlm family (llama-3.2-vision) runs a gated cross-attention layer
over the image context after every ``n_self // n_cross`` self layers;
the port keeps the self layers in one flat ``ModuleList`` (the
reference nests them as (n_cross, per_group)).  The audio family
(whisper) runs an encoder of decoder blocks without the causal mask
over the frame embeddings, then decoder layers with self- and
cross-attention.  The hybrid family (zamba2) runs a Mamba2 backbone
with one *shared* decoder block after every ``hybrid_period`` layers,
applied to ``concat(h, x0) @ shared_in`` (x0: the token embeddings),
of which only the block's delta feeds back; the ssm family (rwkv6) a
stack of RWKV6 time-mix + channel-mix layers.

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
from repro_torch.models.mamba2 import Mamba2, mamba2_apply
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.rwkv6 import (RWKV6, rwkv6_channel_mix,
                                      rwkv6_time_mix)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


class _Init:
    """Seeded weight factory on the target device: normal × 1/√d_in
    (the reference's ``dense_init`` and ``moe_init``), cast to the model
    dtype unless another is asked for."""

    def __init__(self, cfg: ModelConfig, device, generator):
        self.dt, self.dev, self.gen = _dtype(cfg), device, generator

    def normal(self, shape, scale: float,
               dtype: Optional[torch.dtype] = None):
        w = torch.randn(shape, generator=self.gen, device=self.dev,
                        dtype=torch.float32)
        return _param((w * scale).to(dtype or self.dt))

    def dense(self, d_in: int, d_out: int, scale: Optional[float] = None,
              dtype: Optional[torch.dtype] = None):
        s = scale if scale is not None else 1.0 / np.sqrt(d_in)
        return self.normal((d_in, d_out), s, dtype)

    def experts(self, e: int, d_in: int, d_out: int):
        return self.normal((e, d_in, d_out), 1.0 / np.sqrt(d_in))

    def ones(self, n: int):
        return self.full(n, 1.0)

    def full(self, n: int, value: float):
        return _param(torch.full((n,), value, dtype=torch.float32,
                                 device=self.dev))

    def zeros(self, *shape: int):
        return _param(torch.zeros(shape, dtype=torch.float32,
                                  device=self.dev))

    def fixed(self, t: torch.Tensor):
        """A parameter with a fixed fp32 initial value (no draw)."""
        return _param(t.to(device=self.dev, dtype=torch.float32))


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
    """SwiGLU (``wi``, ``wg``, ``wo``) or tanh-GELU (``wi``, ``wo``)."""

    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        if cfg.mlp_variant not in ("swiglu", "gelu"):
            raise ValueError(cfg.mlp_variant)
        self.wi = init.dense(cfg.d_model, cfg.d_ff)
        if cfg.mlp_variant == "swiglu":
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


class CrossLayer(ParamModule):
    """vlm gated cross-attention layer (llama-3.2-vision): attention over
    the image context and an MLP, each scaled by ``tanh`` of its gate,
    which starts at 0 (closed)."""

    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        self.ln1 = Norm(cfg, init)
        self.attn = Attention(cfg, init)
        self.gate = init.zeros()
        self.ln2 = Norm(cfg, init)
        self.mlp = MLP(cfg, init)
        self.gate_mlp = init.zeros()


class EncDecLayer(ParamModule):
    """audio decoder layer (whisper): self-attention, cross-attention
    over the encoder output, MLP."""

    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        self.ln1 = Norm(cfg, init)
        self.attn = Attention(cfg, init)
        self.lnx = Norm(cfg, init)
        self.attn_cross = Attention(cfg, init)
        self.ln2 = Norm(cfg, init)
        self.mlp = MLP(cfg, init)


class MambaLayer(ParamModule):
    """hybrid backbone layer (zamba2): pre-norm Mamba2 mixer."""

    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        self.ln = Norm(cfg, init)
        self.mixer = Mamba2(cfg, init)


class RwkvLayer(ParamModule):
    """ssm layer (rwkv6): time mix after ``ln1``, channel mix after
    ``ln2``; both read the one ``tmix`` leaf group, as in the
    reference."""

    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        self.ln1 = Norm(cfg, init)
        self.tmix = RWKV6(cfg, init)
        self.ln2 = Norm(cfg, init)


class Embed(ParamModule):
    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        self.embedding = init.dense(cfg.vocab_size, cfg.d_model, scale=0.02)
        if not cfg.tie_embeddings:
            self.unembed = init.dense(cfg.d_model, cfg.vocab_size)


def vlm_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """vlm: (cross layers, self layers per group) — a cross layer follows
    every group of self layers."""
    n_cross = cfg.n_layers // cfg.cross_attn_period
    return n_cross, (cfg.n_layers - n_cross) // n_cross


class Model(ParamModule):
    """The family's stack with ``ModuleList``s of layers:

    * dense / moe: pre-norm decoder layers (attention + SwiGLU MLP, or
      the MoE FFN when ``cfg.moe``) — qwen3-4b, olmo-1b, qwen3-moe;
    * vlm: ``layers`` (the n_self self layers, flat) and
      ``cross_layers`` (one ``CrossLayer`` per group);
    * audio: ``enc_layers`` and ``enc_ln`` (the encoder), and ``layers``
      of ``EncDecLayer``;
    * hybrid: ``layers`` of ``MambaLayer``, one ``shared_attn``
      (``DecoderLayer``) and ``shared_in`` (2·d_model, d_model);
    * ssm: ``layers`` of ``RwkvLayer``.

    ``forward`` / ``loss_fn`` train it; the serving functions
    (``models.decode``) run it layer by layer against the KV cache.
    ``params["layers"][i]`` reads like the reference's stacked params
    sliced at layer i.  ``device`` defaults to ``"cuda"`` and raises
    without a GPU."""

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
        if cfg.family == "vlm":
            n_cross, per_group = vlm_groups(cfg)
            self.layers = nn.ModuleList(DecoderLayer(cfg, init)
                                        for _ in range(n_cross * per_group))
            self.cross_layers = nn.ModuleList(CrossLayer(cfg, init)
                                              for _ in range(n_cross))
        elif cfg.family == "audio":
            self.enc_layers = nn.ModuleList(
                DecoderLayer(cfg, init) for _ in range(cfg.encoder_layers))
            self.enc_ln = Norm(cfg, init)
            self.layers = nn.ModuleList(EncDecLayer(cfg, init)
                                        for _ in range(cfg.n_layers))
        elif cfg.family == "hybrid":
            self.layers = nn.ModuleList(MambaLayer(cfg, init)
                                        for _ in range(cfg.n_layers))
            self.shared_attn = DecoderLayer(cfg, init)
            self.shared_in = init.dense(2 * cfg.d_model, cfg.d_model)
        elif cfg.family == "ssm":
            self.layers = nn.ModuleList(RwkvLayer(cfg, init)
                                        for _ in range(cfg.n_layers))
        else:
            self.layers = nn.ModuleList(DecoderLayer(cfg, init)
                                        for _ in range(cfg.n_layers))


# the name the dense-family slices gave the model; it builds every family
DenseModel = Model

def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm", "audio", "hybrid", "ssm"):
        raise ValueError(cfg.family)


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: upcast is exact
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # owning copy


def _flat_leaves(tree: Mapping, prefix: str = ""):
    """(dotted path, array) of a nested params dict."""
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _flat_leaves(sub, f"{prefix}{name}.")
        else:
            yield prefix + name, sub


def params_from_jax(np_params: Mapping, cfg: ModelConfig,
                    device="cuda") -> Model:
    """Build the port's model from the reference's parameter pytree
    (``repro.models.model.init_params`` output with leaves converted to
    numpy by the caller), so both sides compute with identical weights.
    The stacked groups (``layers``, and ``cross_layers`` / ``enc_layers``)
    carry a leading layer axis; vlm's ``layers`` carry two, (n_cross,
    per_group), flattened here in that order.  hybrid's ``shared_attn``
    and ``shared_in`` are one block, not stacked.  A missing or
    unexpected leaf raises."""
    dev = resolve_device(device)
    model = Model(cfg, device="meta")
    loaded = {}
    for group, tree in np_params.items():
        stacked = group in ("layers", "cross_layers", "enc_layers")
        lead = 2 if (group == "layers" and cfg.family == "vlm") else 1
        leaves = (_flat_leaves(tree) if isinstance(tree, Mapping)
                  else [("", tree)])
        for path, a in leaves:
            if not stacked:
                name = f"{group}.{path}" if path else group
                loaded[name] = _param(_to_tensor(a, dev))
                continue
            a = np.asarray(a)
            a = a.reshape((-1,) + a.shape[lead:])
            for i in range(a.shape[0]):
                loaded[f"{group}.{i}.{path}"] = _param(_to_tensor(a[i], dev))
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

def _decoder_block_apply(p, cfg: ModelConfig, x: torch.Tensor,
                         causal: Optional[bool] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (x, the layer's aux loss: the router's, 0 for a dense layer).
    ``causal=False`` is the audio encoder's block."""
    h = apply_norm(p["ln1"], cfg, x)
    x = x + attn.attention_apply(p["attn"], cfg, h, causal=causal)
    h = apply_norm(p["ln2"], cfg, x)
    if cfg.moe:
        y, aux = moe_apply(p["moe"], cfg, h)
        return x + y, aux
    return (x + mlp_apply(p["mlp"], cfg, h),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _cross_block_apply(p, cfg: ModelConfig, x: torch.Tensor,
                       context: torch.Tensor) -> torch.Tensor:
    """vlm gated cross-attention layer over the image context."""
    h = apply_norm(p["ln1"], cfg, x)
    y = attn.attention_apply(p["attn"], cfg, h, kv_src=context)
    x = x + torch.tanh(p["gate"]).to(x.dtype) * y
    h = apply_norm(p["ln2"], cfg, x)
    return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * mlp_apply(
        p["mlp"], cfg, h)


def _encdec_dec_block_apply(p, cfg: ModelConfig, x: torch.Tensor,
                            context: torch.Tensor) -> torch.Tensor:
    """audio decoder layer: self-attention, cross-attention over the
    encoder output, MLP."""
    h = apply_norm(p["ln1"], cfg, x)
    x = x + attn.attention_apply(p["attn"], cfg, h)
    h = apply_norm(p["lnx"], cfg, x)
    x = x + attn.attention_apply(p["attn_cross"], cfg, h, kv_src=context)
    h = apply_norm(p["ln2"], cfg, x)
    return x + mlp_apply(p["mlp"], cfg, h)


def _mamba_block_apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x + mamba2_apply(p["mixer"], cfg, apply_norm(p["ln"], cfg, x))


def _rwkv_block_apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    y, _, _ = rwkv6_time_mix(p["tmix"], cfg, apply_norm(p["ln1"], cfg, x))
    x = x + y
    y, _ = rwkv6_channel_mix(p["tmix"], cfg, apply_norm(p["ln2"], cfg, x))
    return x + y


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


def _run_encoder(model: Model, cfg: ModelConfig,
                 audio_embeds: torch.Tensor) -> torch.Tensor:
    """The audio encoder: decoder blocks without the causal mask over the
    frame embeddings, then ``enc_ln``.  Where a context-parallel view
    splits the frames (``seq`` of its layers) the encoder runs on the
    rank's frames and the context is gathered whole."""
    block = _remat(cfg, lambda p, h: _decoder_block_apply(p, cfg, h,
                                                          causal=False)[0])
    seq = getattr(model["enc_ln"], "seq", None)
    x = audio_embeds if seq is None else seq.take(audio_embeds)
    for p in model["enc_layers"]:
        x = block(p, x)
    x = apply_norm(model["enc_ln"], cfg, x)
    return x if seq is None else seq.gather(x)


def forward(model: Model, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logits fp32 (B, S, V), aux_loss: the layers' router losses
    summed in layer order, 0 without moe).  A sharded view whose
    ``embed`` is vocab-parallel gives the rank's (B, S, V / m).  vlm reads
    ``batch["image_embeds"]`` (B, n_image_tokens, d_model), audio
    ``batch["audio_embeds"]`` (B, encoder_len, d_model).  hybrid runs
    the shared block after every ``hybrid_period`` mamba layers, outside
    the layers' remat, as the reference's outer scan does.

    A context-parallel view (its ``seq``, ``distributed.sharding``)
    takes the whole sequence's ``batch`` and hands the layers the
    rank's rows: the vocab-parallel lookup is reduce-scattered to them
    (without a vocab region the rank looks up its rows' tokens), and
    the head gathers the sequence again, so the logits are the whole
    sequence's (B, S, V / m), or the rank's rows' (B, S / m, V) without
    a vocab region."""
    _check_family(cfg)
    dt = _dtype(cfg)
    tokens = batch["tokens"]
    seq = getattr(model, "seq", None)
    if seq is not None and model["embed"].tp is None:
        tokens = seq.take(tokens)
    x = embed_apply(model["embed"], tokens).to(dt)
    block = _remat(cfg, lambda p, h: _decoder_block_apply(p, cfg, h))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "vlm":
        context = batch["image_embeds"].to(dt)
        cross = _remat(cfg, lambda p, h: _cross_block_apply(p, cfg, h,
                                                            context))
        per_group = len(model["layers"]) // len(model["cross_layers"])
        for i, p in enumerate(model["layers"]):
            x, a = block(p, x)
            aux = aux + a
            if (i + 1) % per_group == 0:
                x = cross(model["cross_layers"][i // per_group], x)
    elif cfg.family == "audio":
        context = _run_encoder(model, cfg, batch["audio_embeds"].to(dt))
        dec = _remat(cfg, lambda p, h: _encdec_dec_block_apply(p, cfg, h,
                                                               context))
        for p in model["layers"]:
            x = dec(p, x)
    elif cfg.family == "hybrid":
        x0 = x
        mamba = _remat(cfg, lambda p, h: _mamba_block_apply(p, cfg, h))
        for i, p in enumerate(model["layers"]):
            x = mamba(p, x)
            if (i + 1) % cfg.hybrid_period == 0:
                # only the shared block's delta feeds back (zamba2)
                cat = torch.cat([x, x0], dim=-1) @ model["shared_in"]
                y, a = _decoder_block_apply(model["shared_attn"], cfg, cat)
                x = x + (y - cat)
                aux = aux + a
    elif cfg.family == "ssm":
        rwkv = _remat(cfg, lambda p, h: _rwkv_block_apply(p, cfg, h))
        for p in model["layers"]:
            x = rwkv(p, x)
    else:
        for p in model["layers"]:
            x, a = block(p, x)
            aux = aux + a
    x = apply_norm(model["final_ln"], cfg, x)
    return unembed_apply(model["embed"], cfg, x), aux


def nll_terms(model: Model, cfg: ModelConfig,
              batch: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``loss_fn``'s parts before the mean: (the masked token NLL summed
    over ``batch``, the mask's sum, the aux loss).  ``train.step`` weighs
    a data-parallel rank's rows by the whole batch's token count.  On a
    context-parallel view every "model" rank holds the whole sequence's
    NLL and aux loss (``forward``)."""
    logits, aux = forward(model, cfg, batch)
    labels = batch["labels"].long()
    vocab = getattr(model["embed"], "tp", None)
    seq = getattr(model, "seq", None)
    if vocab is not None:            # the rank's logits: a sharded softmax
        nll = vocab.nll(logits, labels)
    else:
        if seq is not None:          # the rank's rows' logits
            labels = seq.take(labels)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        nll = logz - gold
        if seq is not None:
            # every rank holds the whole sequence's loss, as with a
            # vocab region: its gradient is each rank's, of which the
            # rank keeps its rows'
            nll = seq.gather(nll, shares=False)
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask
    return (nll * mask).sum(), mask.sum(), aux


def loss_fn(model: Model, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (labels pre-shifted by the pipeline)."""
    nll_sum, n, aux = nll_terms(model, cfg, batch)
    loss = nll_sum / n.clamp(min=1.0)
    return loss + 0.01 * aux, {"nll": loss, "aux": aux}
