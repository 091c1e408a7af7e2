"""Serving path, dense family — port of ``repro.models.decode``: cache
init, slot reset/release, page-table pushes, the prompt prefill →
decode handoff, and the single-token ``serve_step``.

The serving cache stacks every field over layers (``(L, ...)``, as the
reference's scanned cache does); each layer's decode step gets a dict
of views into it and updates them in place, so a step never copies the
cache.  Host-side bookkeeping (slot claim, allocation) stays in
``launch/serve.py``.  Serving never trains: the model's parameters are
trainable, and these functions run without autograd.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.decode_plan import (plan_from_prefill,
                                          release_plan_slot, reset_plan_slot)
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_dtype, apply_norm, apply_rope,
                                       embed_apply, mlp_apply, unembed_apply)

_SEED_FIELDS = ("k_min", "k_max", "kv_indices", "kv_counts", "step", "churn")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.moe:
        raise NotImplementedError(
            f"family {cfg.family!r}: slice 1 of the PyTorch port serves the "
            f"dense family; moe and the others are slice 4")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Dict[str, Any]:
    """Layer-stacked (L, ...) serving cache: ``{"kv": {...}}`` holding
    contiguous ``k``/``v`` or the paged pool + ``page_table``, and the
    SATA decode ``plan`` when routing is on (``attn.init_kv_cache``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    one = attn.init_kv_cache(cfg, batch, max_len, _dtype(cfg), device=dev)

    def stack(t):
        return t.expand(cfg.n_layers, *t.shape).clone()

    kv = {k: ({n: stack(t) for n, t in v.items()} if isinstance(v, dict)
              else stack(v)) for k, v in one.items()}
    return {"kv": kv}


def _layer_view(kvc: Dict, layer: int) -> Dict:
    """One layer's cache as views into the stacked tensors: in-place
    updates through it land in the stacked cache."""
    return {k: ({n: t[layer] for n, t in v.items()} if isinstance(v, dict)
                else v[layer]) for k, v in kvc.items()}


def reset_slot(cfg: ModelConfig, cache: Dict, slot: int) -> Dict:
    """Clear one slot's decode plan across all layers (in place) for a
    newly claimed request.  The K/V rows need no zeroing: every read
    path masks key positions ``<= pos``, and the new request rewrites
    each position before it becomes readable."""
    if "plan" in cache["kv"]:
        reset_plan_slot(cache["kv"]["plan"], slot, batch_axis=1)
    return cache


def release_slot(cfg: ModelConfig, cache: Dict, slot: int) -> Dict:
    """Mark a slot's plan inactive (in place) when its request completes
    or is preempted: an empty slot must not age onto re-plan beats or
    count re-plans.  The next claim re-activates it (``reset_slot``)."""
    if "plan" in cache["kv"]:
        release_plan_slot(cache["kv"]["plan"], slot, batch_axis=1)
    return cache


def set_page_table(cfg: ModelConfig, cache: Dict, table) -> Dict:
    """Push the host allocator's page table (B, max_pages) into the
    device cache, in place, for every layer (all layers of a slot grow
    in lockstep)."""
    pt = cache["kv"]["page_table"]
    tbl = torch.as_tensor(np.asarray(table), dtype=torch.int32)
    pt.copy_(tbl.to(pt.device).expand_as(pt))
    return cache


def _dec_mlp(p, cfg, x):
    return x + mlp_apply(p["mlp"], cfg, apply_norm(p["ln2"], cfg, x))


@torch.no_grad()
def prefill_prompt(model, cfg: ModelConfig, tokens: torch.Tensor,
                   max_len: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence prompt prefill for serving.  Runs the decoder over
    the whole (B, S_p) prompt and returns the last position's logits
    (B, V) fp32 plus the state ``install_prefill`` places into a slot:
    ``k``/``v`` (L, B, S_p, KV, hd) and, with SATA decode on, a seeded
    per-layer ``plan`` (``plan_from_prefill``: summaries over the
    written keys, the prompt tail's selected blocks, ``step`` off the
    re-plan beat).  Attention is the dense top-k reference
    (``attn._attend``), the same selection decode uses."""
    _check_family(cfg)
    b, sp = tokens.shape
    # strictly less: the first decode step writes at pos == sp
    assert sp < max_len, (sp, max_len)
    dt = _dtype(cfg)
    kvh, hd = cfg.n_kv_heads, cfg.hd
    g = cfg.n_heads // kvh
    seed_plan = attn.sata_decode_on(cfg, max_len)
    blk = attn.decode_block_size(cfg, max_len)
    dev = tokens.device
    positions = torch.arange(sp, device=dev)
    x = embed_apply(model["embed"], tokens).to(dt)
    ks, vs, seeds = [], [], []
    for p in model["layers"]:
        hn = apply_norm(p["ln1"], cfg, x)
        q, k, v = attn._project_qkv(p["attn"], cfg, hn)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        out = attn._attend(q, k, v, cfg, positions, positions, causal=True)
        y = out.reshape(b, sp, cfg.n_heads * hd) @ p["attn"]["wo"]
        x = _dec_mlp(p, cfg, x + y)
        ks.append(k.to(dt))
        vs.append(v.to(dt))
        if seed_plan:
            # seed from the WRITTEN keys, padded to the logical length
            k_pad = torch.zeros((b, max_len, kvh, hd), dtype=dt, device=dev)
            k_pad[:, :sp] = k.to(dt)
            seeds.append(plan_from_prefill(
                k_pad, q[:, -1].reshape(b, kvh, g, hd),
                torch.full((b,), sp - 1, dtype=torch.int32, device=dev),
                topk_k=cfg.topk_k, k_block=blk,
                plan_blocks=cfg.sata.decode.blocks,
                summary=cfg.sata.decode.summary))
    x = apply_norm(model["final_ln"], cfg, x[:, -1:])
    logits = unembed_apply(model["embed"], cfg, x)
    state = {"k": torch.stack(ks), "v": torch.stack(vs)}
    if seed_plan:
        state["plan"] = {n: torch.stack([s[n] for s in seeds])
                         for n in seeds[0]}
    return logits[:, 0], state


def install_prefill(cfg: ModelConfig, cache: Dict, slot: int,
                    state: Dict[str, Any], phys_pages=None) -> Dict:
    """Place one prefilled request (``prefill_prompt`` output, B=1) into
    serving slot ``slot``, in place: the prompt K/V rows into the slot's
    contiguous region or, paged, scattered through ``phys_pages`` (the
    slot's mapped pages in logical order), and the seeded plan rows into
    the slot's plan state."""
    ks, vs = state["k"], state["v"]                   # (L, 1, S_p, KV, hd)
    sp = ks.shape[2]
    kv = cache["kv"]
    if "k_pages" in kv:
        assert phys_pages is not None, "paged install needs the pages"
        page = kv["k_pages"].shape[2]
        row = np.asarray(phys_pages).reshape(-1)
        assert row.shape[0] * page >= sp, (row.shape[0], page, sp)
        tok = np.arange(sp)
        dev = kv["k_pages"].device
        phys_w = torch.as_tensor(row[tok // page], dtype=torch.long,
                                 device=dev)
        off_w = torch.as_tensor(tok % page, dtype=torch.long, device=dev)
        kv["k_pages"][:, phys_w, off_w] = ks[:, 0].to(kv["k_pages"].dtype)
        kv["v_pages"][:, phys_w, off_w] = vs[:, 0].to(kv["v_pages"].dtype)
    else:
        kv["k"][:, slot, :sp] = ks[:, 0].to(kv["k"].dtype)
        kv["v"][:, slot, :sp] = vs[:, 0].to(kv["v"].dtype)
    if "plan" in state and "plan" in kv:
        for name in _SEED_FIELDS:
            kv["plan"][name][:, slot] = state["plan"][name][:, 0]
    return cache


@torch.no_grad()
def serve_step(model, cfg: ModelConfig, cache: Dict, tokens: torch.Tensor,
               pos) -> Tuple[torch.Tensor, Dict]:
    """tokens: (B, 1) current token ids; pos: scalar or (B,) per-slot
    positions.  → (logits (B, 1, V) fp32, cache updated in place)."""
    _check_family(cfg)
    x = embed_apply(model["embed"], tokens).to(_dtype(cfg))
    for i, p in enumerate(model["layers"]):
        hn = apply_norm(p["ln1"], cfg, x)
        y, _ = attn.attention_decode(p["attn"], cfg, hn,
                                     _layer_view(cache["kv"], i), pos)
        x = _dec_mlp(p, cfg, x + y)
    x = apply_norm(model["final_ln"], cfg, x)
    return unembed_apply(model["embed"], cfg, x), cache
