"""Paged serving KV cache: global page pool + per-slot page tables —
port of ``repro.core.paging``.

  k_pages / v_pages  (n_pages, page, KV, D) — one physical pool per layer;
  page_table         (B, max_pages) int32 — per-slot logical→physical map.

Physical page 0 is the reserved **overflow page**: unmapped table
entries point at it, so a write from a stalled slot lands there
harmlessly (every read path masks key positions ``<= pos``, and a stall
only happens at a page boundary).

The allocator and the prefix trie are host-side numpy, copied from the
reference (not imported): claim, append, stall and free; per-page
refcounts, so one physical page backs the same logical block of several
slots; copy-on-write (``ensure_writable``, eager or through lazy write
leases); and the shared-prefix trie (``PrefixCache``) that maps a new
prompt's longest cached prefix into its slot.  Shared pages are
immutable while ``ref > 1``: an append into one copies it first, and
the paged decode write re-routes any write that would still land in one
to the overflow page.

Fault tolerance: ``squeeze``/``unsqueeze`` withhold free pages (injected
external pressure); ``swap_out`` detaches a slot for host-swap
preemption — private pages' rows go to host through the driver's gather
callback, each payload array under a crc32, while shared pages stay
resident under a reference the handle pins — and ``swap_in`` restores
it into fresh pages after ``verify_handle`` re-checks every crc.
``swap_to_full`` turns a handle's pins into host payload before a crash
drops the pool, and ``discard_handle`` quarantines a handle that failed
its check.  ``audit="light"`` samples the full audit.

Cascade retirement: ``retire_compact`` frees the pages behind a slot's
cold logical pages mid-stream.  A retired logical page becomes a HOLE
below ``n_mapped``: its table entry maps the overflow page, ``ensure``
never remaps it, and ``free_slot`` / ``swap_out`` skip it; a swap handle
records the holes and ``swap_in`` marks them again.

Across replicas: ``SharedPrefixIndex`` holds the prompt-prefix pages
each replica published, under the trie's chained digest, as host
payload that another replica's miss copies into its own pool.
"""
from __future__ import annotations

import hashlib
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

OVERFLOW_PAGE = 0


class PageIntegrityError(RuntimeError):
    """A host-swap payload failed its checksum at restore time: the
    handle's pages were corrupted while parked in host memory.  The
    serving driver quarantines the handle (``discard_handle`` +
    ``PrefixCache.invalidate_pages``) and recovers the request by
    re-prefill; corrupted K/V never scatters back into the pool."""


def _payload_checksums(payload: Any) -> Dict[str, int]:
    """crc32 per payload array (the ``gather_phys_pages`` dict layout; a
    bare array checks under the empty key).  crc32 detects every
    single-byte flip, the failure ``corrupt_page`` injects, and any
    burst under 32 bits.  It reads each array's buffer in place: the
    sums equal those of its ``tobytes()``, which would copy every
    payload once more."""
    if isinstance(payload, dict):
        return {k: zlib.crc32(np.ascontiguousarray(v))
                for k, v in payload.items()}
    return {"": zlib.crc32(np.ascontiguousarray(payload))}


# Host-swap payload callbacks: the allocator decides WHICH physical pages
# move, the serving driver HOW their rows move
# (``models.decode.gather_phys_pages`` / ``scatter_phys_pages``).
# Payloads are opaque to the allocator.
GatherFn = Callable[[List[int]], Any]
ScatterFn = Callable[[List[int], Any], None]


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


# --- per-physical-page SATA block-summary cache -------------------------
# A shared-prefix install copies a cached page's summary row instead of
# recomputing it from the page's keys.  The rows mirror the plan state's
# summary backend: fp32 stores exact bounds; int8 stores conservative
# codes plus per-page fp32 (scale, zero).  A page's row is always the
# quantization of the same from-scratch fp32 bounds, so copying it is
# bit-identical to recomputing it under either backend.

def page_summary_fields(summary: str = "fp32") -> Tuple[str, ...]:
    """Cache-dict names of the page-summary arrays — the rows
    ``copy_phys_pages`` moves with K/V on copy-on-write."""
    if summary == "int8":
        return ("page_k_min", "page_k_max", "page_k_scale", "page_k_zero")
    return ("page_k_min", "page_k_max")


def init_page_summaries(n_pages: int, n_kv_heads: int, d: int,
                        summary: str = "fp32", *, device
                        ) -> Dict[str, torch.Tensor]:
    """Empty per-physical-page summary arrays: bounds (n_pages, KV, D);
    the int8 backend adds (n_pages, KV) scale/zero with the ``scale =
    -1`` empty sentinel (``decode_plan.dequantize_summaries``)."""
    if summary == "int8":
        return {
            "page_k_min": torch.zeros((n_pages, n_kv_heads, d),
                                      dtype=torch.int8, device=device),
            "page_k_max": torch.zeros((n_pages, n_kv_heads, d),
                                      dtype=torch.int8, device=device),
            "page_k_scale": torch.full((n_pages, n_kv_heads), -1.0,
                                       dtype=torch.float32, device=device),
            "page_k_zero": torch.zeros((n_pages, n_kv_heads),
                                       dtype=torch.float32, device=device),
        }
    return {
        "page_k_min": torch.full((n_pages, n_kv_heads, d), float("inf"),
                                 dtype=torch.float32, device=device),
        "page_k_max": torch.full((n_pages, n_kv_heads, d), float("-inf"),
                                 dtype=torch.float32, device=device),
    }


class PageAllocator:
    """Host-side free-list allocator for the paged pool.

    Positions advance sequentially from 0 within a slot, so logical
    pages map strictly in order; ``n_mapped[slot]`` is both the mapped
    count and the next logical page to map.  ``table`` mirrors the
    device page table (unmapped = OVERFLOW_PAGE).  ``ref`` counts each
    physical page's references — slot table entries, swap handles' pins
    and the prefix trie's retention — and a page recycles only at zero;
    ``ref > 1`` marks it shared, so writes must copy it first.
    ``audit=True`` runs ``check_invariants`` after every mutation, as
    the reference's serving default does; ``audit="light"`` runs it
    every ``audit_period``-th mutation and the O(pages)
    ``_light_audit`` otherwise."""

    def __init__(self, n_pages: int, batch_slots: int, max_pages: int,
                 page: int, audit: Union[bool, str] = False):
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
        self.ref = np.zeros(n_pages, np.int64)
        self.shared_pages_peak = 0
        # pages withheld by injected pressure (``squeeze``): out of the
        # free list but referenced by nobody
        self.squeezed: List[int] = []
        # retirement holes: per slot, the logical pages whose physical
        # page ``retire_compact`` freed; cleared with the slot
        self.retired: List[set] = [set() for _ in range(batch_slots)]
        self.pages_retired = 0
        # outstanding host-swap handles: each resident (shared) page a
        # handle pins holds one reference until ``swap_in`` releases it
        self.swapped: List[Dict[str, Any]] = []
        # lazy copy-on-write: phys page → the slot holding a write lease
        # on it.  The SOLE mapping slot may append in place into a
        # trie-retained partial page past the rows the trie node covers;
        # the lease lives only while {holder's entry, trie retention}
        # are the page's references
        self.lazy_cow = False
        self.cow_leases: Dict[int, int] = {}
        self.lazy_cow_skips = 0
        self.audit = audit if audit == "light" else bool(audit)
        self.audit_period = 16
        self.audit_trie: Optional["PrefixCache"] = None
        self.audits_run = 0
        self.light_audits_run = 0
        self._mutations = 0

    def _audit(self) -> None:
        if not self.audit:
            return
        self._mutations += 1
        if self.audit == "light" and self._mutations % self.audit_period:
            self._light_audit()
            self.light_audits_run += 1
            return
        self.check_invariants()
        self.audits_run += 1

    def _light_audit(self) -> None:
        """The sampled mode's cheap check: the refcounts sum to the
        nameable references (table mappings + handle pins + trie nodes),
        the overflow page stays unreferenced, and the idle pages number
        the free + squeezed lists.  Catches a leaked or doubled
        reference in O(pages) without walking the tables."""
        expect = int(self.n_mapped.sum())
        expect -= sum(len(r) for r in self.retired)   # holes map nothing
        expect += sum(int((h["resident"] >= 0).sum()) for h in self.swapped)
        if self.audit_trie is not None:
            expect += self.audit_trie.node_count
        total = int(self.ref.sum())
        assert total == expect, (
            f"refcount sum {total} != nameable references {expect}")
        assert self.ref[OVERFLOW_PAGE] == 0, \
            "overflow page acquired a reference"
        idle = int((self.ref == 0).sum()) - 1       # minus overflow
        assert idle == len(self.free) + len(self.squeezed), (
            f"{idle} idle pages vs {len(self.free)} free + "
            f"{len(self.squeezed)} squeezed")

    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def pages_in_use(self) -> int:
        return (self.n_pages - 1) - len(self.free) - len(self.squeezed)

    @property
    def shared_pages(self) -> int:
        """Physical pages currently referenced more than once."""
        return int((self.ref > 1).sum())

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
                self._audit()
                return False
            phys = self.free.pop()
            self.ref[phys] = 1
            self.table[slot, self.n_mapped[slot]] = phys
            self.n_mapped[slot] += 1
        self.pages_in_use_peak = max(self.pages_in_use_peak,
                                     self.pages_in_use)
        self._audit()
        return True

    def map_shared(self, slot: int, phys_pages: List[int]) -> None:
        """Map already-populated physical pages (a matched cached
        prefix) as the slot's first logical pages: refcount bump, zero
        copy.  Must precede any ``ensure`` for the slot."""
        assert self.n_mapped[slot] == 0, "shared prefix maps first"
        for lp, phys in enumerate(phys_pages):
            assert phys != OVERFLOW_PAGE
            self.table[slot, lp] = int(phys)
            self.ref[phys] += 1
        self.n_mapped[slot] = len(phys_pages)
        self.shared_pages_peak = max(self.shared_pages_peak,
                                     self.shared_pages)
        self._audit()

    def _deref(self, phys: int) -> None:
        """Reference drop without the audit, for multi-page mutations
        that audit once at the end."""
        assert phys != OVERFLOW_PAGE and self.ref[phys] > 0, phys
        self.ref[phys] -= 1
        if self.ref[phys] == 0:
            self.free.append(int(phys))

    def deref(self, phys: int) -> None:
        """Drop one reference; the page recycles at zero."""
        self._deref(phys)
        self._audit()

    def ensure_writable(self, slot: int, pos: int
                        ) -> Tuple[bool, Optional[Tuple[int, int]]]:
        """Copy-on-write gate: the page holding ``pos`` must be
        exclusively owned before the slot writes a row into it.
        Returns ``(ok, copy)``: ``copy = (src, dst)`` when a shared page
        was remapped and the caller must copy its rows device-side
        (``models.decode.copy_phys_pages``) before the write lands;
        ``(False, None)`` when the pool cannot back the copy (the slot
        stalls this step, like ``ensure``).

        With ``lazy_cow``, a page whose only other reference is the
        trie's retention (``ref == 2``) and whose write row lies past
        every row a trie node covers is not copied: the slot takes a
        write lease instead.  The driver pushes ``writable_ref_view()``
        so the device write-protect honours the lease; a third
        reference ends it, and the next append takes the copy."""
        lp = pos // self.page
        if lp >= self.n_mapped[slot]:
            return True, None                    # unmapped: ensure() maps
        src = int(self.table[slot, lp])
        if self.ref[src] <= 1:
            self.cow_leases.pop(src, None)       # lease served its term
            return True, None                    # exclusive: write away
        if self.lazy_cow and self.ref[src] == 2:
            if self.cow_leases.get(src) == slot:
                return True, None                # live lease
            if (src not in self.cow_leases and self._trie_retains(src)
                    and pos % self.page >=
                    self.audit_trie.covered_rows(src)):
                # the write row lies past every cached row: in place is
                # safe.  A matcher diverging inside the covered rows
                # never qualifies — it would overwrite a cached prefix
                self.cow_leases[src] = slot
                self.lazy_cow_skips += 1
                return True, None
        if not self.free:
            return False, None                   # CoW needs a page: stall
        dst = self.free.pop()
        self.ref[dst] = 1
        self.table[slot, lp] = dst
        self.ref[src] -= 1                       # shared pages never hit 0
        self.cow_leases.pop(src, None)           # holder went private
        self.pages_in_use_peak = max(self.pages_in_use_peak,
                                     self.pages_in_use)
        self._audit()
        return True, (src, dst)

    def _trie_retains(self, phys: int) -> bool:
        """Is one of ``phys``'s references the prefix trie's retention?"""
        return self.audit_trie is not None and \
            phys in self.audit_trie.retained_pages()

    def writable_ref_view(self) -> np.ndarray:
        """The refcounts the driver pushes for the device write-protect:
        ``ref``, except that a live lazy-CoW lease's page reports 1 so
        its holder's in-place appends pass.  Liveness is re-derived on
        every push: a lease whose page gained a third reference, or
        whose holder no longer maps it, is dropped here."""
        if not self.cow_leases:
            return self.ref
        view = self.ref.copy()
        for phys in list(self.cow_leases):
            slot = self.cow_leases[phys]
            held = phys in self.table[slot, :self.n_mapped[slot]]
            if self.ref[phys] == 2 and held:
                view[phys] = 1
            else:
                del self.cow_leases[phys]
        return view

    def drop_leases(self, slot: int) -> None:
        """Release every lazy-CoW lease ``slot`` holds (the next occupant
        must not inherit a write grant on a page it never mapped)."""
        self.cow_leases = {p: s for p, s in self.cow_leases.items()
                           if s != slot}

    def retire_compact(self, slot: int, lps: List[int]
                       ) -> Tuple[List[int], List[int]]:
        """Cascade retirement: free the physical pages behind ``slot``'s
        cold logical pages ``lps`` mid-stream.  Returns ``(freed_phys,
        skipped_lps)``.  A page anyone else references (``ref > 1``: the
        trie's retention, another slot's mapping, a swap handle's pin)
        is skipped, never freed; a swapped-out request has no table row
        to name pages through.  A retired logical page becomes a hole:
        its entry maps the overflow page while ``n_mapped`` stands, so
        the surviving pages keep their logical positions.  The caller
        never retires the block holding the write position."""
        freed: List[int] = []
        skipped: List[int] = []
        for lp in sorted({int(x) for x in lps}):
            assert 0 <= lp < self.n_mapped[slot], \
                f"retire of unmapped logical page {lp} (slot {slot})"
            assert lp not in self.retired[slot], \
                f"logical page {lp} already retired (slot {slot})"
            phys = int(self.table[slot, lp])
            assert phys != OVERFLOW_PAGE, (slot, lp)
            if self.ref[phys] > 1:               # pinned: trie / slot /
                skipped.append(lp)               # swap-handle reference
                continue
            self.table[slot, lp] = OVERFLOW_PAGE
            self.retired[slot].add(lp)
            self.cow_leases.pop(phys, None)
            self._deref(phys)
            freed.append(phys)
        self.pages_retired += len(freed)
        self._audit()
        return freed, skipped

    def free_slot(self, slot: int) -> int:
        """Release a finished (or preempted) slot's references.  A page
        returns to the free list only when nothing else references it —
        a page the trie or another slot holds survives.  The table row
        resets to the overflow page (a recycled page must not stay
        visible through an old row); retirement holes hold no reference
        and are forgotten.  Returns the pages unmapped."""
        n = int(self.n_mapped[slot])
        phys = [int(self.table[slot, lp]) for lp in range(n)
                if lp not in self.retired[slot]]
        self.table[slot, :] = OVERFLOW_PAGE
        self.n_mapped[slot] = 0
        self.retired[slot] = set()
        self.drop_leases(slot)
        for p in phys:
            self._deref(p)
        self._audit()
        return n

    # --- fault injection: external pool pressure ----------------------

    def squeeze(self, n: int) -> int:
        """Withhold up to ``n`` free pages (injected external memory
        pressure): they leave the free list unreferenced, so the pool
        looks that much smaller to admission, copy-on-write and append
        until ``unsqueeze`` returns them.  Returns pages taken."""
        taken = 0
        while taken < n and self.free:
            self.squeezed.append(self.free.pop())
            taken += 1
        self._audit()
        return taken

    def unsqueeze(self, n: Optional[int] = None) -> int:
        """Return squeezed pages to the free list (all by default)."""
        back = 0
        while self.squeezed and (n is None or back < n):
            self.free.append(self.squeezed.pop())
            back += 1
        self._audit()
        return back

    # --- host-swap preemption -----------------------------------------

    def swap_out(self, slot: int, gather: GatherFn) -> Dict[str, Any]:
        """Detach ``slot``'s pages for host-swap preemption and return
        the handle ``swap_in`` re-admits from.  Private pages (``ref ==
        1``) have their rows gathered to host through ``gather(phys)``
        and return to the free list; shared pages stay resident, and the
        handle takes over the slot's reference on each, so eviction can
        never recycle a page the swapped request still needs.  Each
        payload array is checksummed.  The slot's table row resets;
        retirement holes move nothing and are recorded in the handle."""
        n = int(self.n_mapped[slot])
        assert n > 0, "swap_out on a slot with no mapped pages"
        retired = sorted(self.retired[slot])
        phys = [int(p) for p in self.table[slot, :n]]
        resident = np.full(n, -1, np.int64)
        priv_lp: List[int] = []
        priv_phys: List[int] = []
        for lp, p in enumerate(phys):
            if lp in self.retired[slot]:
                continue                 # a hole: nothing to move
            if self.ref[p] > 1:
                resident[lp] = p     # the slot's ref moves to the handle
            else:
                priv_lp.append(lp)
                priv_phys.append(p)
        chunks = [(priv_lp, gather(priv_phys))] if priv_phys else []
        self.table[slot, :] = OVERFLOW_PAGE
        self.n_mapped[slot] = 0
        self.retired[slot] = set()
        self.drop_leases(slot)
        for p in priv_phys:
            self._deref(p)
        handle = {"n_pages": n, "resident": resident, "chunks": chunks,
                  "retired": retired,
                  "sums": [_payload_checksums(pl) for _, pl in chunks]}
        self.swapped.append(handle)
        self._audit()
        return handle

    def swap_to_full(self, handle: Dict[str, Any], gather: GatherFn
                     ) -> None:
        """Turn a handle's resident (shared) pages into host payload too:
        the crash path, where the device pool is about to be lost.
        Afterwards the handle restores entirely from host memory, into a
        fresh allocator."""
        resident = handle["resident"]
        res_lp = [lp for lp in range(handle["n_pages"]) if resident[lp] >= 0]
        if not res_lp:
            return
        res_phys = [int(resident[lp]) for lp in res_lp]
        payload = gather(res_phys)
        handle["chunks"].append((res_lp, payload))
        handle["sums"].append(_payload_checksums(payload))
        resident[:] = -1
        for p in res_phys:
            self._deref(p)
        self._audit()

    def swap_pages_needed(self, handle: Dict[str, Any]) -> int:
        """Free pages ``swap_in`` must allocate for this handle (its
        payload pages; resident pages just remap)."""
        return sum(len(lps) for lps, _ in handle["chunks"])

    def verify_handle(self, handle: Dict[str, Any]) -> None:
        """Re-checksum every payload chunk against the sums recorded when
        it was gathered; raises :class:`PageIntegrityError` naming the
        first mismatching chunk and array."""
        for ci, ((lps, payload), sums) in enumerate(
                zip(handle["chunks"], handle.get("sums", []))):
            fresh = _payload_checksums(payload)
            for key, want in sums.items():
                got = fresh.get(key)
                if got != want:
                    raise PageIntegrityError(
                        f"swap payload checksum mismatch: chunk {ci} "
                        f"(logical pages {list(lps)}) array {key!r}: "
                        f"crc {got:#010x} != recorded {want:#010x}")

    def discard_handle(self, handle: Dict[str, Any]) -> List[int]:
        """Quarantine a swap handle: drop it from the outstanding list
        and release its resident pins (those pages never left the
        device, but nothing holds them for this request any more); the
        host payload is abandoned.  Returns the formerly resident pages,
        so the driver can invalidate trie entries built over them."""
        assert any(h is handle for h in self.swapped), \
            "unknown or already-restored handle"
        resident = handle["resident"]
        res = [int(p) for p in resident if p >= 0]
        for p in res:
            self._deref(p)
        resident[:] = -1
        self.swapped = [h for h in self.swapped if h is not handle]
        self._audit()
        return res

    def swap_in(self, slot: int, handle: Dict[str, Any],
                scatter: ScatterFn) -> bool:
        """Re-admit a swapped request into the empty ``slot``: resident
        pages remap at their logical positions (the handle's pin moves
        back to the slot's table), payload pages land in freshly
        allocated pages through ``scatter(new_phys, payload)``, and its
        retirement holes are holes again.  The handle is verified before
        any mutation.  Returns False, with
        nothing changed, when the pool cannot back the payload yet."""
        assert any(h is handle for h in self.swapped), \
            "unknown or already-restored handle"
        self.verify_handle(handle)      # before ANY mutation
        if len(self.free) < self.swap_pages_needed(handle):
            return False
        assert self.n_mapped[slot] == 0, "swap_in needs an empty slot"
        resident = handle["resident"]
        for lp in range(handle["n_pages"]):
            if resident[lp] >= 0:
                self.table[slot, lp] = int(resident[lp])
        for lps, payload in handle["chunks"]:
            fresh = []
            for lp in lps:
                q = self.free.pop()
                self.ref[q] = 1
                self.table[slot, lp] = q
                fresh.append(q)
            scatter(fresh, payload)
        self.n_mapped[slot] = handle["n_pages"]
        self.retired[slot] = set(handle.get("retired", ()))
        self.swapped = [h for h in self.swapped if h is not handle]
        self.pages_in_use_peak = max(self.pages_in_use_peak,
                                     self.pages_in_use)
        self._audit()
        return True

    # --- invariant audit ----------------------------------------------

    def check_invariants(self, trie: Optional["PrefixCache"] = None
                         ) -> None:
        """Allocator-state audit; raises ``AssertionError`` on the first
        violated invariant:

        * the overflow page is never referenced, free, squeezed, or
          mapped inside a slot's mapped region;
        * the free and squeezed lists are duplicate-free and disjoint,
          and a page sits on one of them iff its refcount is zero;
        * every refcount equals the references the bookkeeping can name:
          slot table entries in mapped regions, swap handles' resident
          pins and the trie's retention (so no ``ref == 1`` page is
          mapped by two slots);
        * table entries beyond ``n_mapped`` are the overflow page;
        * retirement holes lie below ``n_mapped`` and map exactly the
          overflow page;
        * every lazy-CoW lease names a live, non-overflow page;
        * every trie node's page is live.

        ``trie`` defaults to ``audit_trie`` (``PrefixCache`` wires
        itself in)."""
        trie = trie if trie is not None else self.audit_trie
        assert self.ref[OVERFLOW_PAGE] == 0, \
            "overflow page acquired a reference"
        free_set = set(self.free)
        assert len(free_set) == len(self.free), "free list has duplicates"
        sq_set = set(self.squeezed)
        assert len(sq_set) == len(self.squeezed), \
            "squeezed list has duplicates"
        assert not (free_set & sq_set), "page both free and squeezed"
        assert OVERFLOW_PAGE not in free_set | sq_set, \
            "overflow page entered the free/squeezed lists"
        mapped = (np.arange(self.max_pages)[None, :]
                  < self.n_mapped[:, None])           # (B, max_pages)
        hole = np.zeros_like(mapped)
        for s, lps in enumerate(self.retired):
            m = int(self.n_mapped[s])
            assert all(0 <= lp < m for lp in lps), (
                f"slot {s}: retired pages {sorted(lps)} outside the mapped "
                f"region [0, {m})")
            hole[s, list(lps)] = True
        kept = hole & (self.table != OVERFLOW_PAGE)
        if kept.any():
            s, lp = (int(x[0]) for x in np.nonzero(kept))
            raise AssertionError(f"slot {s}: retired logical page {lp} "
                                 f"still maps physical page "
                                 f"{self.table[s, lp]}")
        mapped &= ~hole
        over = mapped & (self.table == OVERFLOW_PAGE)
        if over.any():
            s, lp = (int(x[0]) for x in np.nonzero(over))
            raise AssertionError(
                f"slot {s} maps overflow at logical page {lp}")
        stale = ~mapped & (self.table != OVERFLOW_PAGE)
        if stale.any():
            s, lp = (int(x[0]) for x in np.nonzero(stale))
            raise AssertionError(f"stale table entry {self.table[s, lp]} "
                                 f"at slot {s} lp {lp}")
        expected = np.bincount(self.table[mapped].astype(np.int64),
                               minlength=self.n_pages)
        for phys, slot in self.cow_leases.items():
            assert phys != OVERFLOW_PAGE, "lease on the overflow page"
            assert self.ref[phys] >= 1, \
                f"lazy-CoW lease on dead page {phys} (slot {slot})"
        for h in self.swapped:
            for p in h["resident"]:
                if p >= 0:
                    expected[int(p)] += 1
        if trie is not None:
            for p in trie.retained_pages():
                assert self.ref[p] > 0, f"trie retains dead page {p}"
                expected[p] += 1
        bad = np.nonzero(expected != self.ref)[0]
        assert bad.size == 0, (
            f"refcount mismatch at pages {bad.tolist()}: counted "
            f"{expected[bad].tolist()} references, ref say "
            f"{self.ref[bad].tolist()}")
        listed = np.zeros(self.n_pages, bool)
        listed[list(free_set | sq_set)] = True
        off = np.nonzero(listed[1:] != (self.ref[1:] == 0))[0]
        if off.size:
            p = int(off[0]) + 1
            raise AssertionError(
                f"page {p}: ref {int(self.ref[p])} but "
                f"{'on' if listed[p] else 'missing from'} the "
                f"free/squeezed lists")

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
            "shared_pages": self.shared_pages,
            "shared_pages_peak": self.shared_pages_peak,
            "private_pages": self.pages_in_use - self.shared_pages,
            "hbm_reserved_bytes": self.n_pages * page_bytes,
            "hbm_used_peak_bytes": self.pages_in_use_peak * page_bytes,
            "pages_retired": self.pages_retired,
            "lazy_cow_skips": self.lazy_cow_skips,
        }


# ---------------------------------------------------------------------------
# Shared-prefix page cache
# ---------------------------------------------------------------------------

class _TrieNode:
    """One physical page worth of prompt tokens.  Full nodes (``page``
    tokens) key the chain walk by token hash and may have children;
    partial nodes terminate a chain and match by token-prefix
    comparison only."""

    __slots__ = ("phys", "tokens", "digest", "children", "partials",
                 "parent", "stamp")

    def __init__(self, phys: int, tokens: Tuple[int, ...], digest: bytes,
                 parent: Optional["_TrieNode"]):
        self.phys = int(phys)
        self.tokens = tokens
        self.digest = digest
        self.children: Dict[bytes, "_TrieNode"] = {}
        self.partials: List["_TrieNode"] = []
        self.parent = parent
        self.stamp = 0

    @property
    def evictable(self) -> bool:
        return not self.children and not self.partials


def _chain_digest(parent_digest: bytes, tokens: np.ndarray) -> bytes:
    """Position-dependent page key: hashing the parent digest chains the
    pages, so equal page contents at different prefix depths never
    collide.  Lookups still compare tokens — the digest only routes."""
    return hashlib.sha1(
        parent_digest + np.ascontiguousarray(tokens, np.int64).tobytes()
    ).digest()


class PrefixCache:
    """Prompt-prefix trie over the page pool.

    ``match`` walks full-page children by chained token hash (checking
    the stored tokens) and ends with the longest token-prefix match
    among the stop node's children, so a prompt sharing half a cached
    page still maps it (its tail prefill copies the page before writing).
    ``register`` inserts a prefilled prompt's pages — full pages as chain
    nodes, a final partial page as a terminal node — taking one
    reference per page for the trie.  ``evict`` releases least recently
    used leaves that no slot maps when the pool runs dry.  Host-side
    bookkeeping, like the allocator it feeds."""

    def __init__(self, alloc: PageAllocator):
        self.alloc = alloc
        self.page = alloc.page
        self.root = _TrieNode(OVERFLOW_PAGE, (), b"root", None)
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0
        self.evictions = 0
        self.node_count = 0
        self.invalidated = 0
        # the allocator's audit counts trie retention
        alloc.audit_trie = self

    def _nodes(self):
        """Every node below the root (depth-first)."""
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node is not self.root:
                yield node
            stack.extend(node.children.values())
            stack.extend(node.partials)

    @property
    def cached_pages(self) -> int:
        return len(self.retained_pages())

    def retained_pages(self) -> List[int]:
        """Physical pages the trie holds one retention reference on, one
        entry per node."""
        return [n.phys for n in self._nodes()]

    def covered_rows(self, phys: int) -> int:
        """Rows of ``phys`` a trie node covers (0 when none): the lazy
        lease gate — in-place writes are safe only past these rows."""
        return max((len(n.tokens) for n in self._nodes()
                    if n.phys == int(phys)), default=0)

    def _touch(self, node: _TrieNode) -> None:
        self._clock += 1
        while node is not None and node is not self.root:
            node.stamp = self._clock
            node = node.parent

    def match(self, tokens: np.ndarray
              ) -> Tuple[int, List[int], Optional[int]]:
        """Longest cached prefix of ``tokens``: ``(matched_tokens,
        phys_pages, partial_rows)`` — the ascending physical pages to
        map (``map_shared``) and, when the match ends mid-page, the
        valid rows of the last one (``None`` when page-aligned).  Match
        ``tokens[:-1]`` so the tail prefill still yields last-token
        logits.  A pure lookup plus the LRU touch: ``note`` records the
        hit once the claim lands."""
        toks = np.asarray(tokens, np.int64).reshape(-1)
        node, phys, m = self.root, [], 0
        while len(toks) - m >= self.page:
            page_toks = toks[m:m + self.page]
            child = node.children.get(_chain_digest(node.digest, page_toks))
            if child is None or child.tokens != tuple(page_toks.tolist()):
                break
            node, m = child, m + self.page
            phys.append(child.phys)
        # longest common token prefix among the stop node's children,
        # full and partial: a half-used shared page still saves compute
        best, best_len = None, 0
        rest = tuple(toks[m:].tolist())
        for cand in list(node.children.values()) + node.partials:
            lcp = 0
            for a, b in zip(rest, cand.tokens):
                if a != b:
                    break
                lcp += 1
            if lcp > best_len:
                best, best_len = cand, lcp
        if best is not None:
            phys.append(best.phys)
            m += best_len
            self._touch(best)
        elif phys:
            self._touch(node)
        return m, phys, (best_len if best is not None else None)

    def note(self, matched_tokens: int) -> None:
        """Record one admitted request's hit statistics."""
        if matched_tokens:
            self.hits += 1
            self.tokens_saved += matched_tokens
        else:
            self.misses += 1

    def register(self, tokens: np.ndarray, table_row: np.ndarray) -> int:
        """Insert a prompt's pages (the slot's mapping ``table_row``);
        each newly retained page gains one reference for the trie.
        Chain nodes already cached are skipped, and so is a partial page
        whose tokens an existing sibling covers.  Returns pages newly
        retained."""
        toks = np.asarray(tokens, np.int64).reshape(-1)
        node, m, added = self.root, 0, 0
        while len(toks) - m >= self.page:
            page_toks = toks[m:m + self.page]
            digest = _chain_digest(node.digest, page_toks)
            child = node.children.get(digest)
            if child is None or child.tokens != tuple(page_toks.tolist()):
                phys = int(table_row[m // self.page])
                child = _TrieNode(phys, tuple(page_toks.tolist()), digest,
                                  node)
                node.children[digest] = child
                self.alloc.ref[phys] += 1
                added += 1
            node, m = child, m + self.page
        rest = tuple(toks[m:].tolist())
        if rest:
            covered = any(
                len(cand.tokens) >= len(rest)
                and cand.tokens[:len(rest)] == rest
                for cand in list(node.children.values()) + node.partials)
            if not covered:
                phys = int(table_row[m // self.page])
                part = _TrieNode(phys, rest,
                                 _chain_digest(node.digest,
                                               np.asarray(rest)), node)
                node.partials.append(part)
                self.alloc.ref[phys] += 1
                added += 1
                node = part
        self._touch(node)
        self.node_count += added
        self.alloc.shared_pages_peak = max(self.alloc.shared_pages_peak,
                                           self.alloc.shared_pages)
        self.alloc._audit()
        return added

    def evict(self, need_pages: int) -> int:
        """Free least recently used evictable leaves until ``need_pages``
        pages are free (or nothing more can go).  Only leaves no slot
        maps (``ref == 1``, the trie's own reference) go; an interior
        node whose subtree went becomes a leaf for a later round."""
        freed = 0
        while len(self.alloc.free) < need_pages:
            victims = [n for n in self._nodes()
                       if n.evictable and self.alloc.ref[n.phys] == 1]
            pick = min(victims, key=lambda n: n.stamp, default=None)
            if pick is None:
                break
            parent = pick.parent
            if pick in parent.partials:
                parent.partials.remove(pick)
            else:
                parent.children.pop(pick.digest, None)
            self.alloc.deref(pick.phys)
            self.node_count -= 1
            freed += 1
            self.evictions += 1
        return freed

    def invalidate_pages(self, pages: List[int]) -> int:
        """Drop every node whose physical page is in ``pages``, with its
        whole subtree (a chain walk cannot cross a removed node),
        releasing one retention reference per removed node.  Returns
        nodes removed."""
        bad = {int(p) for p in pages}
        removed = 0

        def _drop_subtree(node: _TrieNode) -> int:
            n = 0
            stack = [node]
            while stack:
                x = stack.pop()
                stack.extend(x.children.values())
                stack.extend(x.partials)
                self.alloc._deref(x.phys)
                n += 1
            return n

        def _scrub(node: _TrieNode) -> None:
            nonlocal removed
            for key in list(node.children):
                child = node.children[key]
                if child.phys in bad:
                    removed += _drop_subtree(child)
                    del node.children[key]
                else:
                    _scrub(child)
            keep = []
            for part in node.partials:
                if part.phys in bad:
                    removed += _drop_subtree(part)
                else:
                    keep.append(part)
            node.partials = keep

        _scrub(self.root)
        self.node_count -= removed
        self.invalidated += removed
        self.alloc._audit()
        return removed

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "requests": total,
            "hits": self.hits,
            "hit_rate": self.hits / max(total, 1),
            "prefill_tokens_saved": self.tokens_saved,
            "cached_pages": self.cached_pages,
            "evictions": self.evictions,
            "invalidated": self.invalidated,
        }


class SharedPrefixIndex:
    """Cross-replica prompt-prefix index, the distributed counterpart of
    :class:`PrefixCache` — an own copy of the reference's.

    Each serving replica owns its page pool and trie but publishes its
    prompt-prefix pages here, keyed by the same chained page digest the
    trie routes on (``_chain_digest``), with the pages' host payload (the
    ``models.decode.gather_phys_pages`` dict: K/V and summary rows, bf16
    rows as ``int16`` bit patterns).  A replica whose local trie misses
    walks the chain here; a hit that ANOTHER replica published is a
    migration: the caller copies the payload into fresh local pages
    (``scatter_phys_pages``), registers them in its trie and serves them
    under the ordinary refcount / copy-on-write rules.  The index is a
    copy source, never an owner, so no cross-replica refcount exists.

    Host-side and process-local (the N-replica harness runs replicas in
    one process); the digest chain is what a multi-host index service
    would shard on."""

    def __init__(self):
        self.page: Optional[int] = None
        # chain digest -> (replica_id, page tokens, per-page payload)
        self._pages: Dict[bytes, Tuple[int, Tuple[int, ...],
                                       Dict[str, np.ndarray]]] = {}
        self.publishes = 0
        self.pages_published = 0
        self.lookups = 0
        self.remote_hits = 0

    def publish(self, replica_id: int, tokens: np.ndarray, page: int,
                payload: Dict[str, np.ndarray]) -> int:
        """Register a prompt's FULL pages (the payload's page axis, axis
        1, covers ``len(tokens) // page`` pages in prefix order).  Known
        digests are skipped — the first publisher wins, so an indexed
        page's payload never changes (the trie keeps full prompt pages
        append-frozen).  Returns the pages newly indexed."""
        if self.page is None:
            self.page = int(page)
        assert self.page == int(page), "replicas must agree on page size"
        toks = np.asarray(tokens, np.int64).reshape(-1)
        digest, added = b"root", 0
        for p in range(len(toks) // self.page):
            page_toks = toks[p * self.page:(p + 1) * self.page]
            digest = _chain_digest(digest, page_toks)
            if digest not in self._pages:
                self._pages[digest] = (
                    int(replica_id), tuple(page_toks.tolist()),
                    {k: np.asarray(v[:, p:p + 1])
                     for k, v in payload.items()})
                added += 1
        self.publishes += 1
        self.pages_published += added
        return added

    def lookup(self, replica_id: int, tokens: np.ndarray
               ) -> Optional[Tuple[int, Dict[str, np.ndarray], int]]:
        """Longest indexed full-page prefix of ``tokens``:
        ``(matched_tokens, stacked_payload, remote_pages)`` — the
        payload's page axis in prefix order, ready for
        ``scatter_phys_pages`` into ``matched_tokens // page`` fresh
        pages — or ``None`` when no page matches.  ``remote_pages``
        counts matched pages another replica published (a migration, as
        against re-reading this replica's own)."""
        self.lookups += 1
        if self.page is None:
            return None
        toks = np.asarray(tokens, np.int64).reshape(-1)
        digest, chain = b"root", []
        for p in range(len(toks) // self.page):
            page_toks = toks[p * self.page:(p + 1) * self.page]
            digest = _chain_digest(digest, page_toks)
            hit = self._pages.get(digest)
            if hit is None or hit[1] != tuple(page_toks.tolist()):
                break
            chain.append(hit)
        if not chain:
            return None
        remote = sum(1 for rid, _, _ in chain if rid != int(replica_id))
        # concatenate keeps an int16 bit pattern's bits
        payload = {k: np.concatenate([c[2][k] for c in chain], axis=1)
                   for k in chain[0][2]}
        return len(chain) * self.page, payload, remote

    def host_bytes(self) -> int:
        """Bytes of payload the index holds on the host."""
        return sum(a.nbytes for _, _, pl in self._pages.values()
                   for a in pl.values())

    def stats(self) -> Dict[str, float]:
        return {
            "pages_indexed": len(self._pages),
            "publishes": self.publishes,
            "pages_published": self.pages_published,
            "lookups": self.lookups,
            "remote_hits": self.remote_hits,
        }
