"""Model configuration — the port's own copy of ``repro.models.config``
(nested frozen dataclasses, so ``cfg.sata.decode.block`` reads the same
on both sides).  The legacy flat-kwarg shim of the reference is not
carried over: the port only speaks the nested spelling.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union


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
