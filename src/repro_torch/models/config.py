"""Model configuration — the port's own copy of ``repro.models.config``
(nested frozen dataclasses, so ``cfg.sata.decode.block`` reads the same
on both sides).  The reference's legacy flat spellings come along as
its deprecation shims: ``ModelConfig(..., sata_block=64)`` and
``dataclasses.replace(cfg, sata_decode="on")`` fold into the nested
groups (flat values win), and ``cfg.sata_block`` reads
``cfg.sata.kernel.block``; each flat name warns once per process.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class SataKernelConfig:
    """Prefill-side SATA: chunked selection + compacted-grid kernel."""
    s_f: int = 128
    use: bool = False
    block: int = 128
    schedule: str = "compact"
    selection: str = "auto"
    max_kv_blocks: Optional[int] = None
    bound_fallback: str = "dense"


@dataclasses.dataclass(frozen=True)
class SataDecodeConfig:
    """Decode-side SATA: the incremental KV-block plan + gather kernel."""
    mode: str = "auto"                   # auto | on | off
    block: Optional[int] = None          # decode k-block edge
                                         # (default: sata.kernel.block)
    blocks: Optional[int] = None         # plan width P (None = full nkb)
    replan: Union[int, str] = 1          # full re-plan every N steps
    churn: float = 0.25
    summary: str = "fp32"                # fp32 | int8
    replan_mode: str = "exact"           # exact | sketch
    sketch_factor: int = 4


@dataclasses.dataclass(frozen=True)
class QosConfig:
    """Per-slot degradation ladder (overload regime)."""
    ladder: bool = False
    clear_steps: int = 4


@dataclasses.dataclass(frozen=True)
class RetireConfig:
    """Cascade token retirement → mid-stream page reclaim."""
    mode: str = "off"
    decay: float = 0.9
    watermark: float = 0.75
    keep: float = 0.5


@dataclasses.dataclass(frozen=True)
class SataConfig:
    """All SATA knobs, grouped by the subsystem that reads them."""
    kernel: SataKernelConfig = SataKernelConfig()
    decode: SataDecodeConfig = SataDecodeConfig()
    qos: QosConfig = QosConfig()
    retire: RetireConfig = RetireConfig()


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Serving KV-cache layout."""
    layout: str = "contiguous"           # contiguous | paged
    page_size: int = 0                   # 0 = the decode k-block edge
    pool_pages: int = 0                  # 0 = slots·max_pages + 1
    prefix_cache: bool = False
    lazy_cow: bool = False

    def __post_init__(self):
        if self.layout not in ("contiguous", "paged"):
            raise ValueError(f"kv.layout must be 'contiguous' or 'paged', "
                             f"got {self.layout!r}")
        if self.page_size < 0 or self.pool_pages < 0:
            raise ValueError("kv.page_size / kv.pool_pages must be >= 0")

    def check_decode_block(self, decode_block: Optional[int]) -> None:
        """Paged SATA decode needs the page size to equal the decode
        k-block edge (plan blocks ARE pages) when both are explicit."""
        if (self.layout == "paged" and self.page_size
                and decode_block and decode_block != self.page_size):
            raise ValueError(
                f"paged SATA decode needs kv.page_size == the decode "
                f"k-block edge, got kv.page_size={self.page_size} vs "
                f"sata.decode.block={decode_block}")


# flat legacy spelling -> (top-level field, *nested path)
_FLAT_MAP = {
    "sata_s_f": ("sata", "kernel", "s_f"),
    "use_sata_kernel": ("sata", "kernel", "use"),
    "sata_block": ("sata", "kernel", "block"),
    "sata_schedule": ("sata", "kernel", "schedule"),
    "sata_selection": ("sata", "kernel", "selection"),
    "sata_max_kv_blocks": ("sata", "kernel", "max_kv_blocks"),
    "sata_bound_fallback": ("sata", "kernel", "bound_fallback"),
    "sata_decode": ("sata", "decode", "mode"),
    "sata_decode_block": ("sata", "decode", "block"),
    "sata_decode_blocks": ("sata", "decode", "blocks"),
    "sata_decode_replan": ("sata", "decode", "replan"),
    "sata_decode_churn": ("sata", "decode", "churn"),
    "sata_summary": ("sata", "decode", "summary"),
    "sata_replan_mode": ("sata", "decode", "replan_mode"),
    "sata_sketch_factor": ("sata", "decode", "sketch_factor"),
    "sata_qos_ladder": ("sata", "qos", "ladder"),
    "sata_qos_clear_steps": ("sata", "qos", "clear_steps"),
    "sata_retire": ("sata", "retire", "mode"),
    "sata_retire_decay": ("sata", "retire", "decay"),
    "sata_retire_watermark": ("sata", "retire", "watermark"),
    "sata_retire_keep": ("sata", "retire", "keep"),
    "kv_cache_layout": ("kv", "layout"),
    "kv_page_size": ("kv", "page_size"),
    "kv_pool_pages": ("kv", "pool_pages"),
    "kv_prefix_cache": ("kv", "prefix_cache"),
    "kv_lazy_cow": ("kv", "lazy_cow"),
}

# flat names already warned about: one DeprecationWarning per flat name
# per process, construction and attribute reads alike
_warned_flat: set = set()


def _warn_flat(name: str, how: str) -> None:
    if name in _warned_flat:
        return
    _warned_flat.add(name)
    path = ".".join(_FLAT_MAP[name])
    warnings.warn(
        f"flat config knob '{name}' ({how}) is deprecated; use the "
        f"nested 'cfg.{path}' (construction accepts "
        f"'{path.split('.')[0]}=...' groups)",
        DeprecationWarning, stacklevel=3)


def _fold_flat(kw: dict) -> dict:
    """Fold the flat kwargs in ``kw`` into the nested ``sata`` / ``kv``
    groups; a flat value wins over its group's (that is what
    ``dataclasses.replace(cfg, sata_decode="on")`` means)."""
    flat = {k: kw.pop(k) for k in list(kw) if k in _FLAT_MAP}
    if not flat:
        return kw
    for name in flat:
        _warn_flat(name, "constructor kwarg")
    groups = {"sata": kw.get("sata", SataConfig()),
              "kv": kw.get("kv", KVCacheConfig())}
    for name, val in flat.items():
        top, *inner = _FLAT_MAP[name]
        node = groups[top]
        if len(inner) == 2:                   # sata.<group>.<field>
            sub = dataclasses.replace(getattr(node, inner[0]),
                                      **{inner[1]: val})
            node = dataclasses.replace(node, **{inner[0]: sub})
        else:                                 # kv.<field>
            node = dataclasses.replace(node, **{inner[0]: val})
        groups[top] = node
    kw.update(groups)
    return kw


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | vlm | hybrid | audio | moe | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    attention_variant: str = "topk"           # "dense" | "topk" (SATA)
    topk_k: int = 64
    topk_impl: str = "auto"                   # sort | bisect | auto
    topk_blocks: int = 0

    sata: SataConfig = SataConfig()
    kv: KVCacheConfig = KVCacheConfig()

    qk_norm: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    q_chunk: int = 1024

    norm_type: str = "rmsnorm"                # rmsnorm | layernorm | nonparam_ln
    mlp_variant: str = "swiglu"               # swiglu | gelu
    tie_embeddings: bool = False

    moe: bool = False
    n_experts: int = 0
    experts_per_token: int = 0
    moe_group_size: int = 128
    capacity_factor: float = 1.25
    expert_shard: str = "expert"

    ssm: bool = False
    ssm_state: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    hybrid_period: int = 0

    rwkv: bool = False
    rwkv_head_dim: int = 64

    encoder_layers: int = 0
    encoder_len: int = 1500

    cross_attn_period: int = 0
    n_image_tokens: int = 0

    dtype: str = "bfloat16"
    remat: str = "full"
    scan_layers: bool = True
    micro_steps: int = 1
    rwkv_chunk: int = 256

    def __post_init__(self):
        self.kv.check_decode_block(self.sata.decode.block)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:                 # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Total parameters N (for MODEL_FLOPS = 6·N·D roofline term): the
        reference's arithmetic, approximations included (rwkv's decay
        LoRA and the hybrid's one shared block)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.rwkv:
            att = d * (4 * d) + d * d            # r,k,v,g (+w lora-ish) + out
            ffn = 2 * d * self.d_ff + self.d_ff * d
            per_layer = att + ffn
            return emb + self.n_layers * per_layer
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.moe:
            ffn = self.n_experts * (3 * d * self.d_ff) + d * self.n_experts
        else:
            ffn = 3 * d * self.d_ff if self.mlp_variant == "swiglu" \
                else 2 * d * self.d_ff
        if self.ssm:
            # mamba2 block: in_proj (z,x,B,C,dt) + conv + out_proj
            di, ns = self.d_inner, self.ssm_state
            proj_in = d * (2 * di + 2 * ns * 1 + self.ssm_heads)
            mamba = proj_in + di * self.ssm_conv + di * d
            n_attn = (self.n_layers // self.hybrid_period
                      if self.hybrid_period else 0)
            return (emb + self.n_layers * (mamba + ffn // 1)
                    + (attn + 3 * d * self.d_ff) * (1 if n_attn else 0))
        n_cross = (self.n_layers // self.cross_attn_period
                   if self.cross_attn_period else 0)
        total = emb + self.n_layers * (attn + ffn) + n_cross * attn
        if self.encoder_layers:
            total += self.encoder_layers * (attn + ffn) \
                + self.n_layers * attn               # decoder cross-attn
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        dense_ffn = self.n_experts * (3 * d * self.d_ff)
        active_ffn = self.experts_per_token * (3 * d * self.d_ff)
        return self.param_count() - self.n_layers * (dense_ffn - active_ffn)


# the flat-kwarg constructor shim: ``dataclasses.replace`` hands unknown
# keys straight to ``cls(**merged)``, so wrapping ``__init__`` folds both
# ``ModelConfig(..., sata_block=64)`` and
# ``dataclasses.replace(cfg, sata_decode="on")``
_generated_init = ModelConfig.__init__


def _compat_init(self, *args, **kw):
    _generated_init(self, *args, **_fold_flat(kw))


_compat_init.__wrapped__ = _generated_init
ModelConfig.__init__ = _compat_init


def _make_flat_property(flat_name: str, path: Tuple[str, ...]):
    def _get(self):
        _warn_flat(flat_name, "attribute read")
        node = self
        for p in path:
            node = getattr(node, p)
        return node
    _get.__name__ = flat_name
    _get.__doc__ = f"Deprecated flat alias for ``cfg.{'.'.join(path)}``."
    return property(_get)


for _name, _path in _FLAT_MAP.items():
    setattr(ModelConfig, _name, _make_flat_property(_name, _path))
del _name, _path
