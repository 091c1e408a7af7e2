"""The assigned architectures (+ reduced smoke variants) — the port's own
copy of ``repro.configs.archs``.  ``SMOKE[id]`` is a same-family
reduced config for CPU tests; ``ARCHS[id]`` is the published width.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    "phi4-mini-3.8b": ModelConfig(
        name="phi4-mini-3.8b", family="dense", n_layers=32, d_model=3072,
        n_heads=24, n_kv_heads=8, d_ff=8192, vocab_size=200064,
        attention_variant="topk", topk_k=64, micro_steps=4),
    "deepseek-67b": ModelConfig(
        name="deepseek-67b", family="dense", n_layers=95, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=22016, vocab_size=102400,
        attention_variant="topk", topk_k=64, micro_steps=16),
    "qwen3-4b": ModelConfig(
        name="qwen3-4b", family="dense", n_layers=36, d_model=2560,
        n_heads=32, n_kv_heads=8, d_ff=9728, vocab_size=151936,
        qk_norm=True, head_dim=128, attention_variant="topk", topk_k=64,
        micro_steps=4),
    "olmo-1b": ModelConfig(
        name="olmo-1b", family="dense", n_layers=16, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=8192, vocab_size=50304,
        norm_type="nonparam_ln", attention_variant="topk", topk_k=64),
    "llama-3.2-vision-90b": ModelConfig(
        name="llama-3.2-vision-90b", family="vlm", n_layers=100,
        d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
        vocab_size=128256, cross_attn_period=5, n_image_tokens=1600,
        attention_variant="topk", topk_k=64, micro_steps=16),
    "zamba2-2.7b": ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, d_ff=10240, vocab_size=32000,
        ssm=True, ssm_state=64, hybrid_period=6,
        attention_variant="topk", topk_k=64, micro_steps=4),
    "whisper-base": ModelConfig(
        name="whisper-base", family="audio", n_layers=6, d_model=512,
        n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=51865,
        encoder_layers=6, encoder_len=1500, norm_type="layernorm",
        mlp_variant="gelu", rope_theta=10000.0,
        attention_variant="topk", topk_k=64),
    "qwen3-moe-235b-a22b": ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe", n_layers=94,
        d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
        vocab_size=151936, head_dim=128, qk_norm=True,
        moe=True, n_experts=128, experts_per_token=8,
        expert_shard="expert", attention_variant="topk", topk_k=64,
        micro_steps=8),
    "grok-1-314b": ModelConfig(
        name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=32768, vocab_size=131072,
        moe=True, n_experts=8, experts_per_token=2,
        expert_shard="tensor", attention_variant="topk", topk_k=64,
        micro_steps=16),
    "rwkv6-1.6b": ModelConfig(
        name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=7168, vocab_size=65536,
        rwkv=True, attention_variant="dense",
        micro_steps=4),
}


def _smoke(full: ModelConfig) -> ModelConfig:
    """Reduced same-family config: small widths, few layers, tiny vocab."""
    kw = dict(
        name=full.name + "-smoke", family=full.family,
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=min(4, full.n_kv_heads),
        d_ff=128, vocab_size=256, head_dim=16,
        attention_variant=full.attention_variant, topk_k=4,
        qk_norm=full.qk_norm, norm_type=full.norm_type,
        mlp_variant=full.mlp_variant, q_chunk=8,
        dtype="float32", remat="none",
    )
    if full.moe:
        kw.update(moe=True, n_experts=4, experts_per_token=2,
                  moe_group_size=16, expert_shard=full.expert_shard)
    if full.family == "hybrid":
        kw.update(ssm=True, ssm_state=8, ssm_expand=2, ssm_head_dim=8,
                  ssm_chunk=8, hybrid_period=2, n_kv_heads=4)
    if full.family == "ssm":
        kw.update(rwkv=True, rwkv_head_dim=8, attention_variant="dense")
    if full.family == "audio":
        kw.update(encoder_layers=2, encoder_len=16, n_layers=2)
    if full.family == "vlm":
        kw.update(cross_attn_period=2, n_image_tokens=8)
    return ModelConfig(**kw)


SMOKE: Dict[str, ModelConfig] = {k: _smoke(v) for k, v in ARCHS.items()}
