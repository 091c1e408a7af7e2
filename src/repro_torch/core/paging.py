"""Paged serving KV cache: global page pool + per-slot page tables —
port of the core of ``repro.core.paging``.

  k_pages / v_pages  (n_pages, page, KV, D) — one physical pool per layer;
  page_table         (B, max_pages) int32 — per-slot logical→physical map.

Physical page 0 is the reserved **overflow page**: unmapped table
entries point at it, so a write from a stalled slot lands there
harmlessly (every read path masks key positions ``<= pos``, and a stall
only happens at a page boundary).

The allocator is host-side numpy, copied from the reference (not
imported): claim, append, stall and free.  Host swap, retirement,
copy-on-write and the prefix trie are later slices.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

OVERFLOW_PAGE = 0


def logical_kv_view(pages: torch.Tensor, page_table: torch.Tensor
                    ) -> torch.Tensor:
    """Gather the pool back into the contiguous logical layout:
    pages (n_pages, page, KV, D) + table (B, max_pages)
    → (B, max_pages·page, KV, D).  Materializes the full logical cache,
    so it backs only paths that stream all cached K anyway (dense
    decode, the exact full re-plan)."""
    b, mp = page_table.shape
    g = pages[page_table.long()]                    # (B, mp, page, KV, D)
    return g.reshape(b, mp * g.shape[2], *pages.shape[2:])


class PageAllocator:
    """Host-side free-list allocator for the paged pool.

    Positions advance sequentially from 0 within a slot, so logical
    pages map strictly in order; ``n_mapped[slot]`` is both the mapped
    count and the next logical page to map.  ``table`` mirrors the
    device page table (unmapped = OVERFLOW_PAGE)."""

    def __init__(self, n_pages: int, batch_slots: int, max_pages: int,
                 page: int):
        assert n_pages >= 2, "pool needs >= 1 usable page + overflow"
        self.n_pages = int(n_pages)
        self.page = int(page)
        self.max_pages = int(max_pages)
        # LIFO free list keeps recently-freed (cache-warm) pages hot
        self.free: List[int] = list(range(n_pages - 1, OVERFLOW_PAGE, -1))
        self.table = np.full((batch_slots, max_pages), OVERFLOW_PAGE,
                             np.int32)
        self.n_mapped = np.zeros(batch_slots, np.int32)
        self.pages_in_use_peak = 0

    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def pages_in_use(self) -> int:
        return (self.n_pages - 1) - len(self.free)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache rows."""
        return -(-max(int(n_tokens), 0) // self.page)

    def can_admit(self, n_new_pages: int = 1) -> bool:
        """Admission control: claim a slot only when the pool can back
        its first pages."""
        return len(self.free) >= n_new_pages

    def ensure(self, slot: int, pos: int) -> bool:
        """Map physical pages for ``slot`` covering position ``pos``.
        Returns False (the slot stalls this step) on pool exhaustion;
        pages mapped before running dry stay mapped."""
        need = pos // self.page + 1
        while self.n_mapped[slot] < need:
            if not self.free:
                return False
            phys = self.free.pop()
            self.table[slot, self.n_mapped[slot]] = phys
            self.n_mapped[slot] += 1
        self.pages_in_use_peak = max(self.pages_in_use_peak,
                                     self.pages_in_use)
        return True

    def free_slot(self, slot: int) -> int:
        """Release a finished slot's pages back to the free list and
        reset its table row to the overflow page (a recycled page must
        not stay visible through an old row).  Returns pages freed."""
        n = int(self.n_mapped[slot])
        phys = [int(p) for p in self.table[slot, :n]]
        self.table[slot, :] = OVERFLOW_PAGE
        self.n_mapped[slot] = 0
        self.free.extend(phys)
        return n

    def stats(self, *, row_bytes: int, layers: int = 1) -> Dict[str, int]:
        """Pool occupancy in bytes.  ``row_bytes`` = bytes of ONE token
        row of K+V for one layer; ``layers`` scales to the stacked
        cache."""
        page_bytes = self.page * row_bytes * layers
        return {
            "n_pages": self.n_pages,
            "page_size": self.page,
            "pages_in_use": self.pages_in_use,
            "pages_in_use_peak": self.pages_in_use_peak,
            "hbm_reserved_bytes": self.n_pages * page_bytes,
            "hbm_used_peak_bytes": self.pages_in_use_peak * page_bytes,
        }
