"""Attention — port of ``repro.models.attention``: GQA with RoPE and
qk-norm, the dense top-k reference (``_attend``), full-sequence
attention for training and prefill (``attention_apply``) through the
SATA block-sparse kernels, and single-token decode over the contiguous
or paged KV cache through the incremental SATA plan + the decode gather
kernel.

Heads are kv-major: query head ``h`` belongs to KV head ``h // G``.

The kernel route (``_attend_sata_kernel``) has two selection routes.
Chunked (``topk_impl="bisect"``): per-row thresholds and the block map
come from streamed score tiles, and the compacted-grid kernel re-derives
the mask per tile.  Dense: a full (B·H, S, S) top-k mask goes through
the SATA plan (key sort, query order) to the compacted or dense-grid
kernel.  Neither kernel has a backward: each route is a
``torch.autograd.Function`` whose backward recomputes attention in plain
PyTorch from the same selection (``_selective_ref`` /
``_selective_ref_chunked``), with zero gradient for the selection.

The decode step updates the cache in place (the per-layer cache dict
holds views into the layer-stacked serving cache, so an in-place write
is the whole update — no per-step copy of the cache).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blockmap import (bisect_select, resolve_sel_chunk,
                                       stream_score_chunks)
from repro_torch.core.selection import (NEG_INF, select_thresholds_chunked,
                                        topk_mask_bisect)
from repro_torch.kernels.sata_attention import MAX_BLOCK, MAX_D
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


@torch.no_grad()
def topk_threshold_mask(scores: torch.Tensor, k: int,
                        impl: str = "auto") -> torch.Tensor:
    """Keep entries >= the k-th largest per row (== top-k up to ties).
    impl: "sort" (exact), "bisect" (the SATA predicate), or "auto"
    (bisect for rows of ``BISECT_AUTO_MIN_S`` and longer).  The mask is
    a discrete decision: no gradient flows through it, so gradients
    reach only the kept logits."""
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


def _select_chunked(qf: torch.Tensor, kf: torch.Tensor, k_sel: int, *,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    chunk: Optional[int] = None, q_block: int = 128,
                    k_block: int = 128
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked selection, pass 1 fused with pass 2: per streamed
    ``chunk × Sk`` score tile, each row's bisect threshold and the tile
    occupancy.  qf (BH, Sq, D); kf (BH, Sk, D); q_pos (Sq,) / k_pos
    (Sk,).  Returns ``(thresholds (BH, Sq, 1) fp32, block_map
    (BH, nqb, nkb))``."""
    return select_thresholds_chunked(qf, kf, k_sel, q_pos=q_pos,
                                     k_pos=k_pos, causal=causal,
                                     sm_scale=sm_scale, chunk=chunk,
                                     q_block=q_block, k_block=k_block)


def _selective_ref(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
                   sel: torch.Tensor) -> torch.Tensor:
    """Exact selective attention over flattened heads in plain PyTorch —
    the kernel's math, used as its differentiation rule."""
    d = qf.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", qf.float(), kf.float()) * (
        1.0 / np.sqrt(d))
    s = torch.where(sel, s, NEG_INF)
    any_key = sel.any(dim=-1, keepdim=True)
    p = torch.where(any_key, torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bqk,bkd->bqd", p, vf.float()).to(qf.dtype)


def _selective_ref_chunked(qf, kf, vf, thr, q_pos, k_pos, *, causal: bool,
                           chunk: int) -> torch.Tensor:
    """Exact selective attention re-derived from the per-row threshold,
    one (BH, chunk, Sk) score tile at a time under
    ``torch.utils.checkpoint`` — the chunked route's differentiation
    rule, whose backward recomputes one tile at a time."""
    bh, s, d = qf.shape
    vf32 = vf.float()

    def _fn(sc, adm, t_c):
        sel = bisect_select(sc, t_c) & adm
        sc = torch.where(sel, sc, NEG_INF)
        any_key = sel.any(dim=-1, keepdim=True)
        p = torch.where(any_key, torch.softmax(sc, dim=-1), 0.0)
        return torch.einsum("bqk,bkd->bqd", p, vf32)

    out = stream_score_chunks(qf, kf, _fn, chunk=chunk, causal=causal,
                              q_pos=q_pos, k_pos=k_pos, extras=(thr,),
                              remat=True)
    return out.transpose(0, 1).reshape(bh, s, d).to(qf.dtype)


def _check_bwd_untruncated(max_kv_blocks, nkb: int,
                           on_exceed: str = "truncate") -> None:
    """A truncating ``max_kv_blocks`` drops occupied tiles in the forward
    kernel while the recompute differentiates the full selected set:
    refuse to train through it.  The ``"dense"`` overflow fallback is
    loss-free and exempt."""
    if max_kv_blocks is not None and max_kv_blocks < nkb \
            and on_exceed != "dense":
        raise NotImplementedError(
            f"backward through a truncating max_kv_blocks "
            f"({max_kv_blocks} < nkb={nkb}) would differentiate a "
            f"different function than the forward computes — unset "
            f"sata.kernel.max_kv_blocks (or use the full nkb, or "
            f"sata.kernel.bound_fallback='dense') for training")


def _grad_of(fn, inputs, g):
    """Gradients of ``fn(*inputs)`` against ``g`` w.r.t. ``inputs``,
    recomputed with autograd on."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        return torch.autograd.grad(out, leaves, g)


class _SataKernelFn(torch.autograd.Function):
    """Dense-selection route: forward through the kernel, backward
    through ``_selective_ref`` from the saved ``sel`` mask."""

    @staticmethod
    def forward(ctx, qf, kf, vf, sel, blk, schedule, max_kv_blocks):
        from repro_torch.kernels.ops import sata_attention
        out, _ = sata_attention(qf, kf, vf, sel, q_block=blk, k_block=blk,
                                exact=True, schedule=schedule,
                                max_kv_blocks=max_kv_blocks)
        ctx.save_for_backward(qf, kf, vf, sel)
        ctx.blk, ctx.max_kv_blocks = blk, max_kv_blocks
        return out

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, sel = ctx.saved_tensors
        _check_bwd_untruncated(ctx.max_kv_blocks, sel.shape[-1] // ctx.blk)
        dq, dk, dv = _grad_of(lambda q, k, v: _selective_ref(q, k, v, sel),
                              (qf, kf, vf), g)
        return dq, dk, dv, None, None, None, None


def _sata_kernel_call(qf, kf, vf, sel, blk: int, schedule: str,
                      max_kv_blocks: Optional[int]) -> torch.Tensor:
    """Kernel forward + plain-recompute backward of the dense route; the
    residual holds the full (BH, Sq, Sk) ``sel`` mask."""
    return _SataKernelFn.apply(qf, kf, vf, sel, blk, schedule,
                               max_kv_blocks)


class _SataKernelChunkedFn(torch.autograd.Function):
    """Chunked route: forward through the threshold-mode kernel, backward
    through ``_selective_ref_chunked`` from the saved thresholds (O(Sq)
    selection state); the threshold gets zero gradient."""

    @staticmethod
    def forward(ctx, qf, kf, vf, thr, bm, q_pos, k_pos, blk, causal, chunk,
                max_kv_blocks, on_exceed):
        from repro_torch.kernels.ops import sata_attention
        out, _ = sata_attention(
            qf, kf, vf, None, q_block=blk, k_block=blk, exact=True,
            schedule="compact", selection="chunked", causal=causal,
            sel_chunk=chunk, max_kv_blocks=max_kv_blocks, thresholds=thr,
            block_map=bm, q_pos=q_pos, k_pos=k_pos, on_exceed=on_exceed)
        ctx.save_for_backward(qf, kf, vf, thr, bm, q_pos, k_pos)
        ctx.causal, ctx.chunk = causal, chunk
        ctx.max_kv_blocks, ctx.on_exceed = max_kv_blocks, on_exceed
        return out

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, thr, bm, q_pos, k_pos = ctx.saved_tensors
        _check_bwd_untruncated(ctx.max_kv_blocks, bm.shape[-1],
                               ctx.on_exceed)
        dq, dk, dv = _grad_of(
            lambda q, k, v: _selective_ref_chunked(
                q, k, v, thr, q_pos, k_pos, causal=ctx.causal,
                chunk=ctx.chunk), (qf, kf, vf), g)
        return (dq, dk, dv, torch.zeros_like(thr), None, None, None, None,
                None, None, None, None)


def _sata_kernel_chunked_call(qf, kf, vf, thr, bm, q_pos, k_pos, blk: int,
                              causal: bool, chunk: int,
                              max_kv_blocks: Optional[int],
                              on_exceed: str = "truncate") -> torch.Tensor:
    """Threshold-mode kernel forward + chunked plain-recompute backward;
    the residual is (q, k, v, thr, bm, q_pos, k_pos)."""
    return _SataKernelChunkedFn.apply(qf, kf, vf, thr, bm, q_pos, k_pos,
                                      blk, causal, chunk, max_kv_blocks,
                                      on_exceed)


def _chunked_selection_on(cfg, s: int) -> bool:
    """Route top-k selection through the chunked (mask-free) pipeline?
    ``sata.kernel.selection`` "chunked"/"dense" force a route; "auto"
    goes chunked exactly when ``topk_threshold_mask`` would bisect
    anyway.  The chunked route exists only on the compact grid."""
    mode = cfg.sata.kernel.selection
    schedule = cfg.sata.kernel.schedule
    if mode == "chunked":
        if schedule != "compact":
            raise ValueError(
                "sata.kernel.selection='chunked' requires "
                "sata.kernel.schedule='compact' (the dense grid has no "
                "threshold mode)")
        return True
    if mode == "dense" or schedule != "compact":
        return False
    return _use_bisect_impl(cfg.topk_impl, s)


def _attend_sata_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        cfg, q_pos: torch.Tensor, k_pos: torch.Tensor,
                        causal: bool) -> torch.Tensor:
    """Top-k attention through the SATA kernels.  q: (B, S, H, hd); k/v:
    (B, S, KV, hd); KV heads are repeated to the G query heads each
    serves and flattened to (B·H, S, hd).  Chunked selection
    (``_chunked_selection_on``) or the dense (B·H, S, S) mask through
    the SATA plan; selection runs without autograd."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    kq = k.repeat_interleave(g, dim=2) if g > 1 else k
    vq = v.repeat_interleave(g, dim=2) if g > 1 else v
    qf = q.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    kf = kq.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    vf = vq.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    blk = cfg.sata.kernel.block
    mkb = cfg.sata.kernel.max_kv_blocks
    if _chunked_selection_on(cfg, s):
        chunk = resolve_sel_chunk(min(cfg.q_chunk, s), s, blk)
        qp = q_pos.to(torch.int32)
        kp = k_pos.to(torch.int32)
        thr, bm = _select_chunked(qf, kf, cfg.topk_k, q_pos=qp, k_pos=kp,
                                  causal=causal, chunk=chunk, q_block=blk,
                                  k_block=blk)
        out = _sata_kernel_chunked_call(qf, kf, vf, thr, bm, qp, kp, blk,
                                        causal, chunk, mkb,
                                        cfg.sata.kernel.bound_fallback)
    else:
        with torch.no_grad():
            scores = torch.einsum("bqd,bkd->bqk", qf.float(), kf.float())
            scores = scores * (1.0 / np.sqrt(hd))
            admissible = torch.ones((s, s), dtype=torch.bool,
                                    device=q.device)
            if causal:
                admissible = admissible & (k_pos[None, :] <= q_pos[:, None])
            scores = torch.where(admissible[None], scores, NEG_INF)
            sel = topk_threshold_mask(scores, cfg.topk_k,
                                      impl=cfg.topk_impl)
            sel = sel & admissible[None]
            del scores
        out = _sata_kernel_call(qf, kf, vf, sel, blk,
                                cfg.sata.kernel.schedule, mkb)
    return out.reshape(b, h, s, hd).transpose(1, 2)


def _sata_kernel_ok(cfg, s: int, cross: bool) -> bool:
    """Static routing decision for the kernel route, from ``cfg`` and the
    shapes only (never the device, so the CPU tests take the route the
    card takes): the sequence must tile by ``sata.kernel.block``, and
    the block edge and head dim must lie inside the CUDA kernel's limits
    (``MAX_BLOCK``, ``MAX_D``).  Anything else takes ``_attend``."""
    if not cfg.sata.kernel.use or cross or cfg.attention_variant != "topk":
        return False
    blk = cfg.sata.kernel.block
    return s % blk == 0 and blk <= MAX_BLOCK and cfg.hd <= MAX_D


def attention_apply(params, cfg, x: torch.Tensor,
                    positions: Optional[torch.Tensor] = None,
                    kv_src: Optional[torch.Tensor] = None,
                    causal: Optional[bool] = None,
                    use_rope: bool = True) -> torch.Tensor:
    """Full-sequence self-attention (training / prefill), x: (B, S, D).
    Through the SATA kernels when ``_sata_kernel_ok``, else the dense
    top-k reference per query chunk of ``cfg.q_chunk`` rows."""
    if kv_src is not None:
        raise NotImplementedError(
            "cross-attention (kv_src) belongs to the vlm and audio "
            "families: slice 4 of the PyTorch port")
    b, s, _ = x.shape
    causal = cfg.causal if causal is None else causal
    q, k, v = _project_qkv(params, cfg, x)
    q_pos = torch.arange(s, device=x.device) if positions is None \
        else positions
    k_pos = torch.arange(s, device=x.device)
    if use_rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, k_pos, cfg.rope_theta)
    qc = min(cfg.q_chunk, s)
    if s % qc != 0:
        qc = s                                       # fallback: single chunk
    if _sata_kernel_ok(cfg, s, cross=False):
        out = _attend_sata_kernel(q, k, v, cfg, q_pos, k_pos, causal)
    else:
        out = torch.cat([_attend(q[:, i:i + qc], k, v, cfg, q_pos[i:i + qc],
                                 k_pos, causal=causal)
                         for i in range(0, s, qc)], dim=1)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ params["wo"]


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
