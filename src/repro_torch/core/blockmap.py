"""Block-granular selection plans — port of ``repro.core.blockmap``.

The one selection predicate (``bisect_select``); the SATA plan of the
dense-selection route (``sata_block_plan``: key sort → query order →
tile occupancy); the compact per-row schedule the kernels walk
(``compact_kv_plan``); and the plan-from-chunks constructors of the
chunked route, which stream ``chunk × Sk`` score tiles so that no
(BH, Sq, Sk) score tensor or mask is ever held
(``stream_score_chunks`` and its consumers).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sorting import sort_keys


def bisect_select(scores: torch.Tensor, threshold: torch.Tensor
                  ) -> torch.Tensor:
    """THE selection predicate: ``bf16(score) >= bf16(threshold)``
    (round-to-nearest-even on both sides) — the compare the bisect's
    counting pass runs, so its ``count >= k`` invariant transfers to
    every consumer (planner, mask construction, decode kernel)."""
    return scores.to(torch.bfloat16) >= threshold.to(torch.bfloat16)


def compact_kv_plan(block_map: torch.Tensor, pad_to: Optional[int] = None,
                    truncate: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact each (…, q_block) row of ``block_map`` (…, nqb, nkb) to
    its ascending list of occupied k-block indices plus a count:
    ``(kv_indices (…, nqb, P) int32, kv_counts (…, nqb) int32)`` with
    ``P = pad_to or nkb``.

    Padding slots (``j >= count``) follow the reference's fill rules so
    the two layouts agree entry for entry: a non-empty row repeats its
    last occupied index, an empty row inherits the last occupied index
    of the nearest preceding non-empty row, leading empty rows take the
    first occupied index of the first non-empty row, and an all-empty
    map falls back to 0.  The CUDA decode kernel never visits padding
    slots (it loops to ``count``), so the fill only matters for parity.

    ``pad_to`` below the true maximum count raises unless
    ``truncate=True``, which keeps each row's first ``pad_to`` blocks."""
    bm = block_map.bool()
    nqb, nkb = bm.shape[-2:]
    counts = bm.sum(-1).to(torch.int32)
    if pad_to is not None:
        if not truncate and counts.numel() and pad_to < int(counts.max()):
            raise ValueError(
                f"pad_to={pad_to} < max occupancy {int(counts.max())}: "
                f"occupied tiles would be silently dropped (pass "
                f"truncate=True to opt in)")
        counts = counts.clamp(max=pad_to)
    # stable sort of (not occupied) → occupied indices first, ascending
    order = torch.argsort((~bm).to(torch.int32), dim=-1, stable=True)
    last = torch.gather(order, -1, (counts.long() - 1).clamp(min=0)[..., None]
                        )[..., 0]
    valid = counts > 0
    ar = torch.arange(nqb, device=bm.device)
    rowid = torch.where(valid, ar, -1)
    prev_valid = torch.cummax(rowid, dim=-1).values
    first_valid = torch.argmax(valid.to(torch.int32), dim=-1)[..., None]
    fill_fwd = torch.gather(last, -1, prev_valid.clamp(min=0))
    fill_bwd = torch.gather(order[..., 0], -1, first_valid)
    fill = torch.where(prev_valid >= 0, fill_fwd, fill_bwd)
    fill = torch.where(valid.any(-1, keepdim=True), fill, 0)
    slot = torch.arange(nkb, device=bm.device)
    kv_indices = torch.where(slot < counts[..., None], order, fill[..., None])
    if pad_to is not None:
        kv_indices = kv_indices[..., :pad_to]
    return kv_indices.to(torch.int32), counts


def query_order_from_sorted(sorted_mask: torch.Tensor, s_h: int
                            ) -> torch.Tensor:
    """Order queries HEAD | GLOB | TAIL and, within each class, by the
    centroid of their selected keys in sorted-key space.
    sorted_mask: (..., N_q, N_k) bool, already column-permuted by the key
    order.  Every float here is an exact small integer or one division
    of two, so the order matches the reference exactly."""
    n_k = sorted_mask.shape[-1]
    s_h = min(int(s_h), n_k // 2)
    first = sorted_mask[..., :s_h].any(dim=-1)
    last = sorted_mask[..., n_k - s_h:].any(dim=-1)
    # class rank: HEAD=0 (no tail access), GLOB=1 (both), TAIL=2
    rank = torch.where(~last, 0, torch.where(first, 1, 2)).float()
    m = sorted_mask.float()
    pos = torch.arange(n_k, dtype=torch.float32, device=m.device)
    centroid = (m * pos).sum(-1) / m.sum(-1).clamp(min=1.0)
    key = rank * (2.0 * n_k) + centroid
    return torch.argsort(key, dim=-1, stable=True).to(torch.int32)


def block_occupancy(mask: torch.Tensor, q_block: int, k_block: int
                    ) -> torch.Tensor:
    """(..., N_q/qb, N_k/kb) bool — any selected pair inside each tile."""
    *b, n_q, n_k = mask.shape
    m = mask.reshape(*b, n_q // q_block, q_block, n_k // k_block, k_block)
    return m.any(dim=-1).any(dim=-2)


def sata_block_plan(mask: torch.Tensor, q_block: int, k_block: int,
                    s_h_frac: float = 0.5, seed: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full SATA plan ``(kv_order, q_order, block_map)`` of a
    (..., N_q, N_k) bool top-k mask: the greedy key sort, the query
    order over the sorted mask, and the tile occupancy of the mask
    permuted both ways."""
    n_k = mask.shape[-1]
    kv_order = sort_keys(mask, seed=seed)                       # (..., N_k)
    sorted_mask = torch.gather(
        mask, -1, kv_order.long()[..., None, :].expand_as(mask))
    s_h = max(1, int(s_h_frac * n_k))
    q_order = query_order_from_sorted(sorted_mask, s_h)         # (..., N_q)
    permuted = torch.gather(
        sorted_mask, -2, q_order.long()[..., :, None].expand_as(mask))
    return kv_order, q_order, block_occupancy(permuted, q_block, k_block)


def identity_block_plan(mask: torch.Tensor, q_block: int, k_block: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unsorted baseline: identity permutations + raw occupancy."""
    *b, n_q, n_k = mask.shape
    dev = mask.device
    kv_order = torch.arange(n_k, dtype=torch.int32, device=dev).expand(
        *b, n_k)
    q_order = torch.arange(n_q, dtype=torch.int32, device=dev).expand(
        *b, n_q)
    return kv_order, q_order, block_occupancy(mask, q_block, k_block)


# ---------------------------------------------------------------------------
# Plan-from-chunks: selection → occupancy → compact plan without ever
# holding the (BH, Sq, Sk) score tensor or boolean mask
# ---------------------------------------------------------------------------

def occupancy_from_score_chunk(scores_chunk: torch.Tensor,
                               thr_chunk: torch.Tensor,
                               admissible: torch.Tensor, q_block: int,
                               k_block: int) -> torch.Tensor:
    """Tile occupancy of one streamed chunk: scores_chunk (BH, C, Sk)
    fp32 raw scaled scores, thr_chunk (BH, C, 1) fp32, admissible
    (BH|1, C, Sk) bool → (BH, C/q_block, Sk/k_block) bool, with the
    kernel's own predicate."""
    bh, c, sk = scores_chunk.shape
    sel = bisect_select(scores_chunk, thr_chunk) & admissible
    return sel.reshape(bh, c // q_block, q_block, sk // k_block,
                       k_block).any(dim=4).any(dim=2)


def resolve_sel_chunk(chunk: Optional[int], s: int, q_block: int) -> int:
    """Largest multiple of ``q_block`` that is <= ``chunk`` (default
    ``q_block``) and divides ``s``.  Requires ``s % q_block == 0``."""
    assert s % q_block == 0, (s, q_block)
    c = min(chunk or q_block, s)
    c = max(q_block, (c // q_block) * q_block)
    while s % c:
        c -= q_block
    return c


def stream_score_chunks(q: torch.Tensor, k: torch.Tensor, fn: Callable, *,
                        chunk: int, sm_scale: Optional[float] = None,
                        causal: bool = True,
                        q_pos: Optional[torch.Tensor] = None,
                        k_pos: Optional[torch.Tensor] = None,
                        extras: Tuple[torch.Tensor, ...] = (),
                        remat: bool = False):
    """The one streaming loop every chunked-selection consumer shares:
    one (BH, chunk, Sk) fp32 scaled score tile and its causal
    admissibility at a time, handed to
    ``fn(scores_chunk, admissible, *extra_chunks)``.

    ``extras`` are (BH, Sq, …) tensors cut alongside ``q``.
    ``remat=True`` runs each chunk under ``torch.utils.checkpoint`` when
    gradients are on, so the backward recomputes the tile instead of
    keeping it.  Returns ``fn``'s outputs stacked on a leading
    (Sq/chunk) axis (a tuple of stacks when ``fn`` returns a tuple).
    Scores are fp32 sums of exact products: bf16 operands are upcast
    before the product."""
    bh, s, d = q.shape
    sk = k.shape[1]
    assert s % chunk == 0, (s, chunk)
    scale = float(sm_scale if sm_scale is not None else 1.0 / np.sqrt(d))
    dev = q.device
    q_pos = (torch.arange(s, dtype=torch.int32, device=dev) if q_pos is None
             else q_pos.to(torch.int32))
    kp = (torch.arange(sk, dtype=torch.int32, device=dev) if k_pos is None
          else k_pos.to(torch.int32))
    kf = k.float()

    def one(q_c, p_c, *e_c):
        sc = torch.einsum("bqd,bkd->bqk", q_c.float(), kf) * scale
        if causal:
            adm = (kp[None, :] <= p_c[:, None])[None]
        else:
            adm = torch.ones((1, q_c.shape[1], sk), dtype=torch.bool,
                             device=dev)
        return fn(sc, adm, *e_c)

    outs = []
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (q[:, sl], q_pos[sl]) + tuple(e[:, sl] for e in extras)
        if remat and torch.is_grad_enabled():
            outs.append(checkpoint(one, *args, use_reentrant=False))
        else:
            outs.append(one(*args))
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def occupancy_from_scores_chunked(
    q: torch.Tensor, k: torch.Tensor, thresholds: torch.Tensor, *,
    q_block: int, k_block: int, sm_scale: Optional[float] = None,
    causal: bool = True, q_pos: Optional[torch.Tensor] = None,
    k_pos: Optional[torch.Tensor] = None, chunk: Optional[int] = None,
) -> torch.Tensor:
    """Re-stream score tiles against precomputed per-row thresholds
    (BH, Sq, 1) and emit the (BH, nqb, nkb) tile occupancy directly."""
    bh, sq, _ = q.shape
    sk = k.shape[1]
    assert sk % k_block == 0, (sk, k_block)
    chunk = resolve_sel_chunk(chunk, sq, q_block)
    occ = stream_score_chunks(
        q, k,
        lambda sc, adm, t_c: occupancy_from_score_chunk(sc, t_c, adm,
                                                        q_block, k_block),
        chunk=chunk, sm_scale=sm_scale, causal=causal, q_pos=q_pos,
        k_pos=k_pos, extras=(thresholds,))          # (n, BH, chunk/qb, nkb)
    return occ.transpose(0, 1).reshape(bh, sq // q_block, sk // k_block)


def compact_plan_from_chunks(
    q: torch.Tensor, k: torch.Tensor, thresholds: torch.Tensor, *,
    q_block: int, k_block: int, sm_scale: Optional[float] = None,
    causal: bool = True, q_pos: Optional[torch.Tensor] = None,
    k_pos: Optional[torch.Tensor] = None, chunk: Optional[int] = None,
    pad_to: Optional[int] = None, truncate: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Selection → compact schedule in one call, mask-free.  Returns
    (block_map, kv_indices, kv_counts)."""
    bm = occupancy_from_scores_chunked(
        q, k, thresholds, q_block=q_block, k_block=k_block,
        sm_scale=sm_scale, causal=causal, q_pos=q_pos, k_pos=k_pos,
        chunk=chunk)
    kv_indices, kv_counts = compact_kv_plan(bm, pad_to=pad_to,
                                            truncate=truncate)
    return bm, kv_indices, kv_counts


def occupancy_bound(kv_counts, pct: float = 100.0) -> int:
    """Static per-row occupancy bound (``max_kv_blocks``) from the
    counts of a calibration run: ``ceil`` of the ``pct``-th percentile,
    floored at 1.  ``pct=100`` drops no tile."""
    if isinstance(kv_counts, torch.Tensor):
        kv_counts = kv_counts.cpu().numpy()
    counts = np.asarray(kv_counts).reshape(-1)
    if counts.size == 0:
        return 1
    return max(1, int(np.ceil(np.percentile(counts, pct))))


def block_skip_fraction(block_map: torch.Tensor) -> torch.Tensor:
    """Fraction of (q_block × k_block) tiles with zero work."""
    return 1.0 - block_map.float().mean()
