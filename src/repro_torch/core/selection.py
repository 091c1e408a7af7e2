"""Top-k selection primitives — port of ``repro.core.selection``: the
bisection threshold (the decode path's selection) and pass 1 of the
chunked selection pipeline (``select_thresholds_chunked``), which
streams ``chunk × Sk`` score tiles so that only (BH, Sq, 1) thresholds
and the block occupancy map persist."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.blockmap import (bisect_select,
                                       occupancy_from_score_chunk,
                                       resolve_sel_chunk, stream_score_chunks)

NEG_INF = -2.0 ** 30


def kth_largest_bisect(scores: torch.Tensor, k, iters: int = 16
                       ) -> torch.Tensor:
    """Fixed-iteration bisection on the score range converging to the
    k-th largest value per row (last dim).  Counting runs on a bf16 copy
    with the ``bisect_select`` predicate, so the returned threshold ``t``
    satisfies ``count(bf16(s) >= bf16(t)) >= k`` (ties may admit a few
    extra keys).  ``k`` is an int or a tensor broadcasting against the
    row-count shape ``scores.shape[:-1] + (1,)`` (a per-row budget).
    Entries at or below ``NEG_INF / 2`` are invalid and never counted."""
    valid = scores > NEG_INF / 2
    inf = torch.tensor(float("inf"), dtype=scores.dtype, device=scores.device)
    sc = torch.where(valid, scores, inf)
    lo = torch.clamp(sc.amin(dim=-1, keepdim=True), max=0.0) - 1.0
    hi = torch.where(valid, scores, -inf).amax(dim=-1, keepdim=True)
    cnt_src = torch.where(valid, scores, -inf).to(torch.bfloat16)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = bisect_select(cnt_src, mid).sum(dim=-1, keepdim=True,
                                              dtype=torch.int32)
        take = cnt >= k                      # threshold lies at or above mid
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
    # invariant: count(cnt_src >= bf16(lo)) >= k — callers must apply the
    # mask with the same bf16 compare
    return lo


def topk_mask_bisect(scores: torch.Tensor, k) -> torch.Tensor:
    """Boolean top-k mask via bisection, compare-consistent with the
    bf16 counting pass (>= k selected per row)."""
    lo = kth_largest_bisect(scores, k)
    valid = scores > NEG_INF / 2
    return bisect_select(torch.where(valid, scores, float("-inf")), lo)


@torch.no_grad()
def select_thresholds_chunked(q: torch.Tensor, k: torch.Tensor, k_sel: int,
                              *, q_pos: Optional[torch.Tensor] = None,
                              k_pos: Optional[torch.Tensor] = None,
                              causal: bool = True,
                              sm_scale: Optional[float] = None,
                              chunk: Optional[int] = None,
                              q_block: int = 128, k_block: int = 128
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked selection, passes 1+2 fused in one stream: per resident
    ``chunk × Sk`` score tile, bisect each row's top-k threshold (row
    local, so equal to the full-matrix bisect) and reduce the same tile
    to block occupancy with the kernel's predicate.

    q: (BH, Sq, D); k: (BH, Sk, D).  Returns ``(thresholds (BH, Sq, 1)
    fp32, block_map (BH, nqb, nkb) bool)``.  Selection is a discrete
    decision: it runs without autograd (the reference's stop_gradient).
    """
    bh, s, d = q.shape
    sk = k.shape[1]
    assert sk % k_block == 0, (sk, k_block)
    chunk = resolve_sel_chunk(chunk, s, q_block)

    def _fn(sc, adm):
        thr_c = kth_largest_bisect(torch.where(adm, sc, NEG_INF), k_sel)
        occ_c = occupancy_from_score_chunk(sc, thr_c, adm, q_block, k_block)
        return thr_c, occ_c

    thr, occ = stream_score_chunks(q, k, _fn, chunk=chunk,
                                   sm_scale=sm_scale, causal=causal,
                                   q_pos=q_pos, k_pos=k_pos)
    thr = thr.transpose(0, 1).reshape(bh, s, 1)
    bm = occ.transpose(0, 1).reshape(bh, s // q_block, sk // k_block)
    return thr, bm
