"""Public kernel entry points of the port — port of ``repro.kernels.ops``:
SATA planning (sort → permute → block map, or chunked selection) and the
block-sparse attention kernels end to end, and the decode gather kernel.

``schedule`` selects the kernel: ``"compact"`` (the compacted grid walks
each row's occupied k-blocks only) or ``"dense"`` (the dense-grid
baseline visits every k-block and computes where the map is set).
``selection`` picks how the top-k set reaches it: ``"dense"`` takes a
(BH, Sq, Sk) mask through the full SATA plan; ``"chunked"`` streams
score tiles to per-row thresholds and a block plan, and the kernel
re-derives the mask per tile.

Dispatch follows the device of the tensors: CPU tensors take the plain
PyTorch version, CUDA tensors take the hand-written kernel (a build or
launch failure raises), and meta tensors take a shape-only stand-in
that returns an output of the kernel's shape and dtype and launches
nothing (a meta tensor has no data for either version to compute on:
the dry run, ``launch.dryrun``, traces the model on them).  Any other
device raises.  Nothing falls back.

Each kernel call's work is counted from its static shapes alone, the
same on every device: while a work counter is installed
(``launch.dryrun.WorkCounter`` sets ``_WORK``), a call adds its FLOPs
and bytes (``block_attention_work``, ``decode_attention_work``) and one
call of its name, and runs with the counter paused, so neither the
plain version's own ops nor the CUDA wrapper's are counted again.  The
launch counters (``<wrapper>.launches``) count CUDA launches only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blockmap import (compact_kv_plan, identity_block_plan,
                                       occupancy_from_scores_chunked,
                                       resolve_sel_chunk, sata_block_plan)
from repro_torch.core.decode_plan import sketch_geometry, summary_bytes
from repro_torch.core.selection import select_thresholds_chunked
from repro_torch.kernels import sata_attention as sa
from repro_torch.kernels.ref import ref_block_attention
from repro_torch.kernels.sata_decode import (
    sata_decode_attention_kernel, sata_decode_attention_paged_kernel,
    sata_decode_attention_ref)


# the installed work counter (``launch.dryrun.WorkCounter``), or None
_WORK = None


def block_attention_work(q: torch.Tensor, k: torch.Tensor, slots: int, *,
                         q_block: int, k_block: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one prefill kernel call from static shapes: every
    (bh, q-block) row visits ``slots`` k-blocks (the compacted grid's
    plan capacity P, ``kv_indices``' last dim; the dense grid's nkb),
    each tile Q Kᵀ and P V, 4·q_block·k_block·D FLOPs; it reads Q and
    one K and one V tile a visit, and writes the output."""
    bh, sq, d = q.shape
    tiles = bh * (sq // q_block) * slots
    flops = 4 * q_block * k_block * d * tiles
    nbytes = q.element_size() * (2 * bh * sq * d + 2 * tiles * k_block * d)
    return flops, nbytes


def decode_attention_work(q: torch.Tensor, kv_indices: torch.Tensor, *,
                          k_block: int, partial: bool = False
                          ) -> Tuple[int, int]:
    """(FLOPs, bytes) of one decode kernel call from static shapes: each
    (slot, KV head) row walks its P planned k-blocks at capacity
    (``kv_indices``' last dim), scoring and summing the G grouped heads,
    4·G·k_block·D FLOPs a block; it reads q and one K and one V block a
    step, and writes the output (``partial``: in fp32, and the fp32
    lse of every head)."""
    b, kv, g, d = q.shape
    blocks = b * kv * kv_indices.shape[-1]
    flops = 4 * g * k_block * d * blocks
    es = q.element_size()
    nbytes = es * (b * kv * g * d + 2 * blocks * k_block * d) + (
        4 * b * kv * g * (d + 1) if partial else es * b * kv * g * d)
    return flops, nbytes


def _meta_out(q: torch.Tensor, *args, partial: bool = False, **kw):
    """The shape-only stand-in of every kernel: its output's shape and
    dtype are q's (the decode kernel's partial mode: fp32, and its
    (B, KV, G, 1) fp32 lse)."""
    if partial:
        return (torch.empty(q.shape, dtype=torch.float32, device=q.device),
                torch.empty(q.shape[:-1] + (1,), dtype=torch.float32,
                            device=q.device))
    return torch.empty_like(q)


def _route(q: torch.Tensor, plain, kernel):
    """The version of a kernel for q's device: the plain version on the
    CPU, the CUDA kernel on the card, the stand-in on meta."""
    kind = q.device.type
    if kind == "cpu":
        return plain
    if kind == "cuda":
        return kernel
    if kind == "meta":
        return _meta_out
    raise ValueError(f"no SATA kernel for tensors on {q.device} (cpu, "
                     f"cuda or meta)")


def _counted(name: str, work, fn, *args, **kw):
    """``fn(*args, **kw)``, its ``work()`` added to the installed counter
    (if any) with the counter paused inside."""
    counter = _WORK
    if counter is None:
        return fn(*args, **kw)
    with counter.kernel(name, *work()):
        return fn(*args, **kw)


def _block_attention_compact(q, k, v, kv_indices, *args, **kw
                             ) -> torch.Tensor:
    """The compacted-grid kernel (B3) for q's device (``_route``)."""
    fn = _route(q, sa.sata_block_attention_compact_ref,
                sa.sata_block_attention_compact)
    return _counted(
        "sata_block_attention_compact",
        lambda: block_attention_work(
            q, k, kv_indices.shape[-1], q_block=kw.get("q_block", 128),
            k_block=kw.get("k_block", 128)),
        fn, q, k, v, kv_indices, *args, **kw)


def _block_attention_dense(q, k, v, block_map, *args, **kw) -> torch.Tensor:
    """The dense-grid kernel (B4) for q's device (``_route``)."""
    fn = _route(q, sa.sata_block_attention_ref, sa.sata_block_attention)
    return _counted(
        "sata_block_attention",
        lambda: block_attention_work(
            q, k, block_map.shape[-1], q_block=kw.get("q_block", 128),
            k_block=kw.get("k_block", 128)),
        fn, q, k, v, block_map, *args, **kw)


def _take_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """x (BH, S, ...) with its rows permuted per batch entry by order
    (BH, S) — ``take_along_axis`` on axis 1."""
    idx = order.long().reshape(order.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(order.shape + x.shape[2:]))


def sata_attention(q: torch.Tensor, k_: torch.Tensor, v: torch.Tensor,
                   scores_mask: Optional[torch.Tensor] = None, *,
                   q_block: int = 128, k_block: int = 128,
                   use_sata: bool = True, exact: bool = True,
                   schedule: str = "compact",
                   max_kv_blocks: Optional[int] = None,
                   selection: str = "dense",
                   topk_k: Optional[int] = None,
                   causal: bool = False,
                   sel_chunk: Optional[int] = None,
                   thresholds: Optional[torch.Tensor] = None,
                   block_map: Optional[torch.Tensor] = None,
                   q_pos: Optional[torch.Tensor] = None,
                   k_pos: Optional[torch.Tensor] = None,
                   on_exceed: str = "truncate",
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k selective attention through the SATA plan + kernel.

    q/k_/v: (BH, S, D).  Returns (output in the ORIGINAL query order,
    block_map).

    ``selection="dense"``: the caller hands in ``scores_mask``
    (BH, Sq, Sk) bool; the SATA plan (key sort → query order → tile
    occupancy, or identity orders without ``use_sata``) permutes q/k/v
    and, in exact mode, the mask; the kernel runs in mask mode
    (``exact``) or block mode, and the output is scattered back.
    ``selection="chunked"``: mask-free — thresholds and the block plan
    come from ``select_thresholds_chunked`` (or are passed in), keys stay
    in their order, and the compacted-grid kernel runs in threshold mode.

    ``max_kv_blocks`` (compact schedule) narrows each row's slot list;
    below the true occupancy, ``on_exceed`` decides on the chunked route
    (the dense route truncates): ``"truncate"`` keeps each row's first
    blocks, ``"dense"`` runs the full-width plan whenever any row
    overflows (decided on the host from the concrete counts)."""
    if schedule not in ("compact", "dense"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if selection not in ("dense", "chunked"):
        raise ValueError(f"unknown selection {selection!r}")
    if on_exceed not in ("truncate", "dense"):
        raise ValueError(f"unknown on_exceed {on_exceed!r}")
    if selection == "chunked":
        if schedule != "compact":
            raise ValueError("chunked selection requires the compact "
                             "schedule (the dense grid has no threshold "
                             "mode)")
        return _sata_attention_chunked(
            q, k_, v, topk_k=topk_k, q_block=q_block, k_block=k_block,
            exact=exact, causal=causal, max_kv_blocks=max_kv_blocks,
            sel_chunk=sel_chunk, thresholds=thresholds, block_map=block_map,
            q_pos=q_pos, k_pos=k_pos, on_exceed=on_exceed)
    if scores_mask is None:
        raise ValueError("selection='dense' needs scores_mask")
    if causal or any(a is not None for a in
                     (topk_k, thresholds, block_map, q_pos, k_pos,
                      sel_chunk)):
        # on this path the mask IS the selection, causality included: a
        # chunked-only argument would otherwise be silently ignored
        raise ValueError(
            "selection='dense' takes its selection (causality included) "
            "entirely from scores_mask; causal/topk_k/thresholds/"
            "block_map/q_pos/k_pos/sel_chunk are chunked-only arguments")
    plan_fn = sata_block_plan if use_sata else identity_block_plan
    kv_order, q_order, block_map = plan_fn(scores_mask, q_block, k_block)
    kp = _take_rows(k_, kv_order)
    vp = _take_rows(v, kv_order)
    qp = _take_rows(q, q_order)
    mask_p = None
    if exact:         # block mode needs no element mask
        mask_p = _take_rows(torch.gather(
            scores_mask, 2,
            kv_order.long()[:, None, :].expand_as(scores_mask)), q_order)
    if schedule == "compact":
        # a bound below the occupancy keeps each row's first blocks, as
        # the reference's jitted call does (its counts are traced there)
        kv_indices, kv_counts = compact_kv_plan(block_map,
                                                pad_to=max_kv_blocks,
                                                truncate=True)
        out_p = _block_attention_compact(qp, kp, vp, kv_indices, kv_counts,
                                         mask=mask_p, q_block=q_block,
                                         k_block=k_block)
    else:
        out_p = _block_attention_dense(qp, kp, vp, block_map, mask=mask_p,
                                       q_block=q_block, k_block=k_block)
    # scatter back to the original query order
    out = torch.empty_like(out_p)
    out.scatter_(1, q_order.long()[..., None].expand_as(out_p), out_p)
    return out, block_map


def _sata_attention_chunked(q, k_, v, *, topk_k, q_block, k_block, exact,
                            causal, max_kv_blocks, sel_chunk, thresholds,
                            block_map, q_pos, k_pos, on_exceed="truncate"):
    """Mask-free selection → plan → threshold-mode kernel (see
    ``sata_attention``).  Keys keep their order: no permutation."""
    bh, sq, d = q.shape
    sk = k_.shape[1]
    if sq % q_block or sk % k_block:
        raise ValueError(f"S must tile by the block edge: {(sq, sk)} "
                         f"vs {(q_block, k_block)}")
    sm_scale = 1.0 / np.sqrt(d)
    chunk = resolve_sel_chunk(sel_chunk, sq, q_block)
    dev = q.device
    q_pos = (torch.arange(sq, dtype=torch.int32, device=dev) if q_pos is None
             else q_pos.to(torch.int32))
    k_pos = (torch.arange(sk, dtype=torch.int32, device=dev) if k_pos is None
             else k_pos.to(torch.int32))
    if thresholds is None:
        if topk_k is None:
            raise ValueError("selection='chunked' needs topk_k (or "
                             "precomputed thresholds)")
        thresholds, bm = select_thresholds_chunked(
            q, k_, topk_k, q_pos=q_pos, k_pos=k_pos, causal=causal,
            sm_scale=sm_scale, chunk=chunk, q_block=q_block,
            k_block=k_block)
        if block_map is None:
            block_map = bm
    if block_map is None:
        with torch.no_grad():
            block_map = occupancy_from_scores_chunked(
                q, k_, thresholds, q_block=q_block, k_block=k_block,
                sm_scale=sm_scale, causal=causal, q_pos=q_pos, k_pos=k_pos,
                chunk=chunk)
    pos_q = q_pos[None, :, None].expand(bh, sq, 1)
    pos_k = k_pos[None, :, None].expand(bh, sk, 1)
    nkb = sk // k_block
    if max_kv_blocks is not None and max_kv_blocks < nkb \
            and on_exceed == "dense" \
            and bool((block_map.sum(-1) > max_kv_blocks).any()):
        # a row overflows the bound: run the full-width plan (loss-free)
        kv_indices, kv_counts = compact_kv_plan(block_map)
    else:
        kv_indices, kv_counts = compact_kv_plan(block_map,
                                                pad_to=max_kv_blocks,
                                                truncate=True)
    out = _block_attention_compact(
        q, k_, v, kv_indices, kv_counts,
        thresholds=thresholds if exact else None, q_pos=pos_q, k_pos=pos_k,
        causal=causal, q_block=q_block, k_block=k_block)
    return out, block_map


def sata_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_indices: torch.Tensor, kv_counts: torch.Tensor,
                          thresholds: torch.Tensor, pos: torch.Tensor, *,
                          k_block: int = 128,
                          page_table: Optional[torch.Tensor] = None,
                          partial: bool = False):
    """Decode-path selective attention: fetch only the planned k-blocks
    of the KV cache for one generated token per slot.

    q: (B, KV, G, D) — the G = H//KV query heads grouped per KV head;
    k/v: (B, S, KV, D) serving cache; kv_indices/kv_counts: the per-slot
    plan from ``core.decode_plan``; thresholds: (B, KV, G, 1) fp32;
    pos: (B,).  Returns (B, KV, G, D).  With ``page_table``
    (B, max_pages) given, k/v are the pool (n_pages, page, KV, D) and
    page must equal ``k_block``.  ``partial`` (contiguous only: a rank's
    share of the keys under context-parallel decode) returns the
    kernel's partial mode, (out fp32, lse (B, KV, G, 1) fp32)."""
    if partial and page_table is not None:
        raise ValueError("the decode kernel's partial mode reads the "
                         "contiguous cache only")
    if page_table is not None:
        # the plan's logical block edge must BE the page size, or the
        # kernel would dereference block-granular indices as page ids
        assert k.shape[1] == k_block, (
            f"paged decode needs k_block == page size "
            f"({k_block} != {k.shape[1]})")
    paged = page_table is not None
    name = "sata_decode_attention_paged_kernel" if paged \
        else "sata_decode_attention_kernel"
    fn = _route(q, sata_decode_attention_ref, _decode_kernel_call)
    # passed in the partial mode only: a probe that replaces a wrapper
    # (chip_smoke.py's ``KernelProbe``) takes the default signature
    extra = {"partial": True} if partial else {}
    return _counted(
        name, lambda: decode_attention_work(q, kv_indices, k_block=k_block,
                                            partial=partial),
        fn, q, k, v, kv_indices, kv_counts, thresholds, pos,
        k_block=k_block, page_table=page_table, **extra)


def _decode_kernel_call(q, k, v, kv_indices, kv_counts, thresholds, pos, *,
                        k_block, page_table, **partial):
    """The paged (B1) or contiguous (B2) decode kernel in the plain
    version's argument order.  The module attributes are read at the
    call, so a probe that replaces one sees the call."""
    if page_table is not None:
        return sata_decode_attention_paged_kernel(
            q, k, v, page_table, kv_indices, kv_counts, thresholds, pos)
    return sata_decode_attention_kernel(q, k, v, kv_indices, kv_counts,
                                        thresholds, pos, k_block=k_block,
                                        **partial)


def decode_fetch_stats(kv_counts, pos, *, k_block: int, d: int,
                       dtype_bytes: int = 4, replan=None,
                       nkb: Optional[int] = None, summary: str = "fp32",
                       replan_mode: str = "exact", sketch_factor: int = 4,
                       plan_blocks=None, quant=None, sketch=None,
                       live_blocks=None) -> Dict:
    """Per-step K/V fetch accounting for the decode route (numpy, a copy
    of the reference's).  kv_counts: (..., B, KV) int; pos: (B,)
    per-slot positions.

    Kernel side: dense decode streams every valid block of the prefix
    per (slot, kv head); the planned kernel fetches ``kv_counts`` tiles.
    Plan side (``replan`` given — the fraction of this step's layer
    plans that re-planned, a scalar or a (B,) vector): an exact re-plan
    streams all valid cached K; a sketch re-plan
    (``replan_mode="sketch"``) reads the summaries plus the
    ``sketch_geometry`` candidate blocks' keys (``plan_blocks`` is P);
    an incremental step reads the block summaries (``nkb`` and
    ``summary`` size them) plus the planned blocks' keys.

    QoS rungs: ``plan_blocks`` may be a (B,) vector (a degraded slot's
    sketch geometry prices at its own budget); ``quant`` (B,) bool
    prices flagged slots' summary reads at the int8 code size, and
    ``sketch`` (B,) bool prices flagged slots' re-plans hierarchically
    even under the exact mode.  Retirement: ``live_blocks`` (B,) prices
    each slot's summary reads at its live block count and its re-plan
    key stream at ``min(valid, live)`` blocks.  Scalars and ``None``
    keep the plain accounting."""
    cnt = np.asarray(kv_counts)
    pos = np.asarray(pos).reshape(-1)
    b = pos.shape[0]
    kv = cnt.shape[-1]
    valid_blocks = (pos + 1 + k_block - 1) // k_block          # (B,)
    dense_tiles = int(valid_blocks.sum()) * kv * (cnt.size // (b * kv))
    plan_tiles = int(cnt.sum())
    tile_bytes = 2 * k_block * d * dtype_bytes                 # K + V tile
    out = {
        "kv_fetch_tiles_dense": dense_tiles,
        "kv_fetch_tiles_plan": plan_tiles,
        "kv_fetch_bytes_dense": dense_tiles * tile_bytes,
        "kv_fetch_bytes_plan": plan_tiles * tile_bytes,
        "fetch_reduction": dense_tiles / max(plan_tiles, 1),
    }
    if replan is not None:
        k_tile_bytes = k_block * d * dtype_bytes               # K only
        layers = cnt.size // (b * kv)
        live = None
        if live_blocks is not None:
            live = np.asarray(live_blocks, np.int64).reshape(-1)
            assert live.size == b, (live.size, b)
        qn = None
        if quant is not None:
            qn = np.asarray(quant, bool).reshape(-1)
            assert qn.size == b, (qn.size, b)
        # summary bytes per (slot, head): live blocks after retirement,
        # int8 codes on the quant rung
        if nkb is None:
            sum_head_slot = np.zeros(b, np.int64)
        else:
            n_blk = np.full(b, nkb, np.int64) if live is None else live
            sum_head_slot = np.array(
                [summary_bytes(int(n), d, summary) for n in n_blk],
                np.int64)
            if qn is not None:
                sum_head_slot = np.where(qn, np.array(
                    [summary_bytes(int(n), d, "int8") for n in n_blk],
                    np.int64), sum_head_slot)
        summaries_b = int(sum_head_slot.sum()) * kv * layers
        skt = None if sketch is None else \
            np.asarray(sketch, bool).reshape(-1)
        vb = valid_blocks if live is None else \
            np.minimum(live, valid_blocks)
        exact_slot = vb * kv * layers * k_tile_bytes
        if nkb is not None and (replan_mode == "sketch" or skt is not None):
            pb_slot = np.full(b, nkb, np.int64)
            if plan_blocks is not None:
                pb_arr = np.asarray(plan_blocks).reshape(-1)
                assert pb_arr.size in (1, b), (pb_arr.size, b)
                pb_slot = np.minimum(
                    np.broadcast_to(pb_arr, (b,)).astype(np.int64), nkb)
            cand_slot = np.array(
                [min(int(vb[i]), sketch_geometry(nkb, int(pb_slot[i]),
                                                 sketch_factor)[3])
                 for i in range(b)], np.int64)
            sketch_slot = (cand_slot * kv * layers * k_tile_bytes
                           + sum_head_slot * kv * layers)
            if replan_mode == "sketch":
                full_slot = sketch_slot
            else:
                assert skt.size == b, (skt.size, b)
                full_slot = np.where(skt, sketch_slot, exact_slot)
        else:
            full_slot = exact_slot
        full_b = int(full_slot.sum())
        incr_b = summaries_b + plan_tiles * k_tile_bytes
        rep = np.asarray(replan, np.float64).reshape(-1)
        if rep.size == 1:
            step_b = int(round(float(rep[0]) * full_b
                               + (1.0 - float(rep[0])) * incr_b))
        else:
            assert rep.size == b, (rep.size, b)
            cnt_slot = cnt.reshape(-1, b, kv).sum(axis=(0, 2))  # (B,)
            incr_slot = sum_head_slot * kv * layers + cnt_slot * k_tile_bytes
            step_b = int(round(float(
                (rep * full_slot + (1.0 - rep) * incr_slot).sum())))
        out["plan_fetch_bytes_full"] = full_b
        out["plan_fetch_bytes_incremental"] = incr_b
        out["plan_fetch_bytes_step"] = step_b
        out["step_bytes_plan_route"] = (out["kv_fetch_bytes_plan"]
                                        + out["plan_fetch_bytes_step"])
        out["step_bytes_dense_route"] = out["kv_fetch_bytes_dense"]
    return out


def sata_attention_reference(q, k_, v, scores_mask) -> torch.Tensor:
    """Oracle: exact top-k selective attention, no planning/permutation."""
    bm = torch.ones((q.shape[0], 1, 1), dtype=torch.bool, device=q.device)
    return ref_block_attention(q, k_, v, bm, mask=scores_mask,
                               q_block=q.shape[1], k_block=k_.shape[1])


def kernel_fetch_stats(block_map, *, q_block: int, k_block: int, d: int,
                       dtype_bytes: int = 4,
                       max_kv_blocks: Optional[int] = None) -> Dict:
    """Tile-visit and K/V fetch-byte accounting, dense vs compacted grid
    (numpy, a copy of the reference's).  The dense grid visits every
    (bh, q-row, k-block) tile; the compacted grid visits ``nqb × P``
    slots (P = ``max_kv_blocks`` or nkb) and fetches one K+V tile per
    occupied slot."""
    if isinstance(block_map, torch.Tensor):
        block_map = block_map.cpu().numpy()
    bm = np.asarray(block_map).astype(bool)
    bh, nqb, nkb = bm.shape
    counts = bm.sum(-1)                                   # (bh, nqb)
    p = int(max_kv_blocks) if max_kv_blocks is not None else nkb
    tile_bytes = 2 * k_block * d * dtype_bytes            # one K + one V tile
    dense_visits = bh * nqb * nkb
    compact_visits = bh * nqb * p
    dense_fetch_tiles = bh * nqb * nkb
    compact_fetch_tiles = int(counts.sum())
    return {
        "grid_dense": [bh, nqb, nkb],
        "grid_compact": [bh, nqb, p],
        "tile_visits_dense": dense_visits,
        "tile_visits_compact": compact_visits,
        "kv_fetch_tiles_dense": dense_fetch_tiles,
        "kv_fetch_tiles_compact": compact_fetch_tiles,
        "kv_fetch_bytes_dense": dense_fetch_tiles * tile_bytes,
        "kv_fetch_bytes_compact": compact_fetch_tiles * tile_bytes,
        "visit_reduction": dense_visits / max(compact_visits, 1),
        "fetch_reduction": dense_fetch_tiles / max(compact_fetch_tiles, 1),
        "block_skip_fraction": float(1.0 - bm.mean()),
    }
