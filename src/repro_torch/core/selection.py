"""Top-k selection primitives — port of ``repro.core.selection``'s
bisection threshold (the decode path's selection)."""
from __future__ import annotations

import torch

from repro_torch.core.blockmap import bisect_select

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
