"""Attention, decode half — port of ``repro.models.attention``: GQA with
RoPE and qk-norm, the dense top-k reference (``_attend``, used by the
prompt prefill), and single-token decode over the contiguous or paged
KV cache through the incremental SATA plan + the decode gather kernel.

Heads are kv-major: query head ``h`` belongs to KV head ``h // G``.
The decode step updates the cache in place (the per-layer cache dict
holds views into the layer-stacked serving cache, so an in-place write
is the whole update — no per-step copy of the cache).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.selection import NEG_INF, topk_mask_bisect
from repro_torch.models.layers import apply_rope, rms_head_norm

BISECT_AUTO_MIN_S = 8192     # "auto" switches sort → bisect at this row len


def _project_qkv(params, cfg, x: torch.Tensor):
    b, s = x.shape[:2]
    hd = cfg.hd
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ params["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_head_norm(q, params["q_scale"])
        k = rms_head_norm(k, params["k_scale"])
    return q, k, v


def _use_bisect_impl(impl: str, n: int) -> bool:
    return impl == "bisect" or (impl == "auto" and n >= BISECT_AUTO_MIN_S)


def topk_threshold_mask(scores: torch.Tensor, k: int,
                        impl: str = "auto") -> torch.Tensor:
    """Keep entries >= the k-th largest per row (== top-k up to ties).
    impl: "sort" (exact), "bisect" (the SATA predicate), or "auto"
    (bisect for rows of ``BISECT_AUTO_MIN_S`` and longer)."""
    n = scores.shape[-1]
    if k >= n:
        return torch.ones_like(scores, dtype=torch.bool)
    if _use_bisect_impl(impl, n):
        return topk_mask_bisect(scores, k)
    kth = torch.sort(scores, dim=-1).values[..., n - k:n - k + 1]
    return scores >= kth


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg,
            q_pos: torch.Tensor, k_pos: torch.Tensor,
            valid_k: Optional[torch.Tensor] = None,
            causal: bool = True) -> torch.Tensor:
    """Grouped-query attention with the dense top-k mask.
    q: (B, Q, H, hd); k/v: (B, S, KV, hd).  Scores laid out
    (B, KV, G, Q, S) in fp32 — no repeat-materialization of K."""
    b, nq, h, hd = q.shape
    kv = cfg.n_kv_heads
    g = h // kv
    qg = q.reshape(b, nq, kv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores * (1.0 / np.sqrt(hd))
    mask = torch.ones((1,) + scores.shape[-2:], dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = mask & (k_pos[None, None, :] <= q_pos[None, :, None])
    if valid_k is not None:
        vk = valid_k if valid_k.dim() == 2 else valid_k[None]
        mask = mask & vk[:, None, :]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    if cfg.attention_variant == "topk":
        sel = topk_threshold_mask(scores, cfg.topk_k, impl=cfg.topk_impl)
        scores = torch.where(sel, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.float(),
                       v.float()).to(v.dtype)
    return out.reshape(b, nq, h, hd)


def decode_block_size(cfg, max_len: int) -> int:
    """Decode k-block edge (``sata.decode.block`` or the kernel block),
    clamped so at least one block tiles the cache."""
    return min(cfg.sata.decode.block or cfg.sata.kernel.block, max_len)


def paged_kv_on(cfg) -> bool:
    return cfg.kv.layout == "paged"


def kv_page_size(cfg, max_len: int) -> int:
    """Tokens per page: ``kv.page_size`` or the decode k-block edge."""
    page = cfg.kv.page_size or decode_block_size(cfg, max_len)
    return min(int(page), max_len)


def sata_decode_on(cfg, max_len: int) -> bool:
    """Route single-token decode through the incremental KV-block plan
    + gather kernel?  "on"/"off" force; "auto" follows the bisect
    decision at the cache length."""
    mode = cfg.sata.decode.mode
    if mode == "off" or cfg.attention_variant != "topk":
        return False
    blk = decode_block_size(cfg, max_len)
    if max_len % blk != 0:
        if mode == "on":
            raise ValueError(
                f"sata.decode.mode='on' needs the cache length ({max_len}) "
                f"to tile by the decode block ({blk})")
        return False
    if mode == "on":
        return True
    return _use_bisect_impl(cfg.topk_impl, max_len)


def _resolve_replan(cfg) -> int:
    rp = cfg.sata.decode.replan
    if rp == "auto":
        raise NotImplementedError(
            "sata.decode.replan='auto' (churn-adaptive trigger) is not "
            "ported yet: slice 3 of the PyTorch port (serving features)")
    return int(rp)


def init_kv_cache(cfg, batch: int, max_len: int, dtype, *, device) -> Dict:
    """Serving self-attention cache for one layer: contiguous per-slot
    ``k``/``v`` (B, max_len, KV, hd), or (``kv.layout="paged"``) a
    ``k_pages``/``v_pages`` pool (n_pages, page, KV, hd) plus a per-slot
    ``page_table`` (B, max_pages).  A SATA decode ``plan`` rides along
    when routing is on; paged, its block edge must equal the page."""
    from repro_torch.core.decode_plan import init_decode_plan
    hd = cfg.hd
    sata = sata_decode_on(cfg, max_len)
    if cfg.kv.prefix_cache:
        raise NotImplementedError(
            "kv.prefix_cache is not ported yet: slice 3 of the PyTorch "
            "port (serving features)")
    if paged_kv_on(cfg):
        from repro_torch.core.paging import OVERFLOW_PAGE
        page = kv_page_size(cfg, max_len)
        if max_len % page:
            raise ValueError(f"max_len ({max_len}) must tile by the page "
                             f"size ({page})")
        max_pages = max_len // page
        n_pages = cfg.kv.pool_pages or batch * max_pages + 1
        shape = (n_pages, page, cfg.n_kv_heads, hd)
        cache = {
            "k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device),
            "page_table": torch.full((batch, max_pages), OVERFLOW_PAGE,
                                     dtype=torch.int32, device=device),
        }
        if sata and decode_block_size(cfg, max_len) != page:
            raise ValueError(
                f"paged SATA decode needs the page size == the decode "
                f"k-block edge ({page} != "
                f"{decode_block_size(cfg, max_len)})")
    else:
        shape = (batch, max_len, cfg.n_kv_heads, hd)
        cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
    if sata:
        if cfg.sata.qos.ladder or cfg.sata.retire.mode == "on":
            raise NotImplementedError(
                "the QoS ladder and token retirement are not ported yet: "
                "slice 3 of the PyTorch port (serving features)")
        _resolve_replan(cfg)
        cache["plan"] = init_decode_plan(
            batch, cfg.n_kv_heads, max_len, hd,
            decode_block_size(cfg, max_len), cfg.sata.decode.blocks,
            summary=cfg.sata.decode.summary, device=device)
    return cache


def _per_slot_positions(pos, batch: int, device) -> torch.Tensor:
    """``pos`` as per-slot (B,) int32 (a scalar broadcasts)."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return pos.expand(batch).contiguous() if pos.dim() == 0 else pos


def _attend_sata_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_new: torch.Tensor, cfg, pos: torch.Tensor,
                        plan: Dict, *, k_block: int,
                        page_table: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Dict]:
    """Decode attention through the incremental plan + gather kernel.
    q: (B, 1, H, hd); k/v: the updated cache (contiguous (B, S, KV, hd)
    or the pool with ``page_table``); k_new: (B, 1, KV, hd) the key row
    just written; pos: (B,).  Returns ((B, 1, H, hd), plan) with the
    plan updated in place."""
    from repro_torch.core.decode_plan import (decode_plan_update,
                                              update_block_summaries)
    from repro_torch.kernels.ops import sata_decode_attention
    b, _, h, hd = q.shape
    kv = k.shape[2]
    qg = q[:, 0].reshape(b, kv, h // kv, hd)
    # summarize the value actually WRITTEN to the cache (same dtype cast)
    update_block_summaries(plan, k_new.to(k.dtype), pos, k_block=k_block)
    plan, thr = decode_plan_update(
        plan, qg, k, pos, topk_k=cfg.topk_k, k_block=k_block,
        replan_interval=_resolve_replan(cfg), page_table=page_table,
        replan_mode=cfg.sata.decode.replan_mode)
    out = sata_decode_attention(qg, k, v, plan["kv_indices"],
                                plan["kv_counts"], thr, pos,
                                k_block=k_block, page_table=page_table)
    return out.reshape(b, 1, h, hd), plan


def _dense_decode(q, k, v, cfg, pos):
    k_pos = torch.arange(k.shape[1], device=q.device)
    valid = k_pos[None, :] <= pos[:, None]                   # (B, S)
    return _attend(q, k, v, cfg, torch.zeros((1,), dtype=torch.int32,
                                             device=q.device),
                   k_pos, valid_k=valid, causal=False)


def attention_decode(params, cfg, x: torch.Tensor, cache: Dict, pos,
                     use_rope: bool = True) -> Tuple[torch.Tensor, Dict]:
    """One-token decode: write the new K/V row at ``pos`` (in place),
    attend over the prefix.  x: (B, 1, D); cache: one layer's
    ``init_kv_cache`` dict; pos: scalar or (B,) per-slot positions.
    With a ``plan`` in the cache, attention runs through the SATA plan
    + gather kernel; without one, densely over the prefix."""
    b = x.shape[0]
    pos = _per_slot_positions(pos, b, x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x)
    if use_rope:
        posv = pos[:, None]
        q = apply_rope(q, posv, cfg.rope_theta)
        k_new = apply_rope(k_new, posv, cfg.rope_theta)
    if "k_pages" in cache:
        return _paged_decode_step(params, cfg, cache, q, k_new, v_new, pos)
    k, v = cache["k"], cache["v"]
    # in-place row write; an out-of-range position clamps to the last
    # row, as the reference's dynamic_update_slice does
    bi = torch.arange(b, device=x.device)
    wp = pos.long().clamp(max=k.shape[1] - 1)
    k[bi, wp] = k_new[:, 0].to(k.dtype)
    v[bi, wp] = v_new[:, 0].to(v.dtype)
    if "plan" in cache:
        blk = decode_block_size(cfg, k.shape[1])
        out, _ = _attend_sata_decode(q, k, v, k_new, cfg, pos, cache["plan"],
                                     k_block=blk)
    else:
        out = _dense_decode(q, k, v, cfg, pos)
    y = out.reshape(b, 1, cfg.n_heads * cfg.hd) @ params["wo"]
    return y, cache


def _paged_decode_step(params, cfg, cache: Dict, q: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       pos: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against the paged pool: scatter the new K/V row
    into each slot's current page (``page_table[b, pos // page]``, in
    place), then attend through the paged plan + gather kernel, or
    densely over the gathered logical view without a plan.  A slot
    whose current page is unmapped writes to the overflow page; the
    serving driver discards that step's output and re-feeds."""
    from repro_torch.core.paging import logical_kv_view
    b = q.shape[0]
    kp, vp, tbl = cache["k_pages"], cache["v_pages"], cache["page_table"]
    page = kp.shape[1]
    lp = (pos.long() // page).clamp(max=tbl.shape[1] - 1)
    phys = torch.gather(tbl.long(), 1, lp[:, None])[:, 0]
    off = pos.long() % page
    kp[phys, off] = k_new[:, 0].to(kp.dtype)
    vp[phys, off] = v_new[:, 0].to(vp.dtype)
    if "plan" in cache:
        out, _ = _attend_sata_decode(q, kp, vp, k_new, cfg, pos,
                                     cache["plan"], k_block=page,
                                     page_table=tbl)
    else:
        out = _dense_decode(q, logical_kv_view(kp, tbl),
                            logical_kv_view(vp, tbl), cfg, pos)
    y = out.reshape(b, 1, cfg.n_heads * cfg.hd) @ params["wo"]
    return y, cache
