"""Block-granular selection plans — port of the parts of
``repro.core.blockmap`` the decode path uses: the one selection
predicate (``bisect_select``) and the compact per-row plan layout
(``compact_kv_plan``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


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
