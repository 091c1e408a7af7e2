"""Algo 2 — Sparsity-aware inter-head FSM scheduling — port of
``repro.core.scheduling`` (the reference's numpy, copied).

Queries are the *stationary* operand (each query has exactly K key-MACs;
keys have variable fan-in).  Keys stream through the compute array in
SATA-sorted order.  The FSM overlaps loading the next group of queries
with MAC-ing keys the currently-retiring group does not need:

  init      load major Qs of head 0 (pipeline fill)
  intoHD(h) MAC streamed keys [0 : S_h)        | load minor Qs of head h
  midstHD(h)MAC streamed keys [S_h : N - S_h)  | (all Qs resident)
  outtaHD(h)MAC streamed keys [N - S_h : N)    | load major Qs of head h+1
            (dominant Qs of head h retire — they never touch these keys)
  wrapGLOB  conventional load-then-MAC for heads stuck in GLOB state

"major" = dominant-type ∪ GLOB queries, "minor" = the opposite type.
For a TAIL-type head the key stream order is *reversed* so that the
first-streamed S_h keys are exactly the ones its major queries own —
this is the symmetric reading of the paper's init/intoHD descriptions
(Sec. III-C) and is asserted correct by the coverage property test.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.sorting import (HeadType, QType, SortResult,
                                      sort_and_classify)


@dataclasses.dataclass(frozen=True)
class Step:
    """One FSM state occupancy: MAC ``k_mac`` keys while loading ``q_load``."""
    phase: str                     # init|intoHD|midstHD|outtaHD|globLoad|globMAC
    k_head: int                    # head owning the MAC'd keys (-1: none)
    q_head: int                    # head owning the loaded queries (-1: none)
    k_mac: Tuple[int, ...]         # original key indices MAC'd this step
    q_load: Tuple[int, ...]        # original query indices loaded this step
    n_active_q: int                # resident queries participating in MACs
    resident: Tuple[Tuple[int, int], ...]  # resident (head, q) pairs


@dataclasses.dataclass(frozen=True)
class Schedule:
    steps: Tuple[Step, ...]
    n_tokens: int
    n_heads: int
    peak_residency: int

    @property
    def q_seq(self) -> List[Tuple[int, int]]:
        return [(s.q_head, q) for s in self.steps for q in s.q_load]

    @property
    def k_seq(self) -> List[Tuple[int, int]]:
        return [(s.k_head, k) for s in self.steps for k in s.k_mac]


def _split_queries(res: SortResult) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    qt = res.qtypes
    dom = QType.HEAD if res.head_type == HeadType.HEAD else QType.TAIL
    mnr = QType.TAIL if res.head_type == HeadType.HEAD else QType.HEAD
    dominant = np.flatnonzero(qt == dom)
    minor = np.flatnonzero(qt == mnr)
    glob = np.flatnonzero(qt == QType.GLOB)
    return dominant, minor, glob


def _stream_order(res: SortResult) -> np.ndarray:
    """Key stream order: sorted order for HEAD heads, reversed for TAIL."""
    kid = np.asarray(res.kid)
    return kid if res.head_type == HeadType.HEAD else kid[::-1]


def build_schedule(results: Sequence[SortResult],
                   masks: Optional[Sequence[np.ndarray]] = None,
                   skip_empty_keys: bool = False,
                   group_of: Optional[Sequence[int]] = None) -> Schedule:
    """Build the full inter-head schedule from per-head Algo-1 results.

    ``masks`` (original, unsorted) are only needed when
    ``skip_empty_keys`` is set — all-zero key columns are then elided
    from the stream (zero-skip, Sec. III-D).

    ``group_of`` assigns each (sub-)head to a Q-fold residency group
    (tiled path).  GLOB sub-heads then run at the end of *their group*
    — their fold's queries are still resident — instead of the paper's
    untiled behaviour of wrapping all GLOB heads up at the very end.
    """
    if group_of is None:
        local = [i for i, r in enumerate(results)
                 if r.head_type != HeadType.GLOB]
        globs = [i for i, r in enumerate(results)
                 if r.head_type == HeadType.GLOB]
        sequence = [("local", i) for i in local] + [("glob", i) for i in globs]
    else:
        order: List[int] = []
        seen: set = set()
        for g in group_of:
            if g not in seen:
                seen.add(g)
                order.append(g)
        sequence = []
        local = []
        for g in order:
            members = [i for i in range(len(results)) if group_of[i] == g]
            loc = [i for i in members if results[i].head_type != HeadType.GLOB]
            glb = [i for i in members if results[i].head_type == HeadType.GLOB]
            sequence += [("local", i) for i in loc]
            sequence += [("glob", i) for i in glb]
            local += loc

    n_tokens = len(results[0].kid) if results else 0
    steps: List[Step] = []
    resident: List[Tuple[int, int]] = []   # (head, q) pairs currently resident
    peak = 0

    def _filter(i: int, seg: np.ndarray) -> np.ndarray:
        """Zero-skip: drop keys no query selects (Sec. III-D) — applied
        per segment so the S_h boundaries keep their sorted positions."""
        if skip_empty_keys and masks is not None and len(seg):
            nonzero = np.asarray(masks[i]).any(axis=0)
            seg = seg[nonzero[seg]]
        return seg

    def key_segments(i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        stream = _stream_order(results[i])
        n = len(stream)
        s_h = min(results[i].s_h, n // 2)
        return (_filter(i, stream[:s_h]),
                _filter(i, stream[s_h:n - s_h]),
                _filter(i, stream[n - s_h:]))

    def emit(phase, k_head, q_head, k_mac, q_load, n_active):
        nonlocal peak
        steps.append(Step(phase=phase, k_head=k_head, q_head=q_head,
                          k_mac=tuple(int(k) for k in k_mac),
                          q_load=tuple(int(q) for q in q_load),
                          n_active_q=int(n_active),
                          resident=tuple(resident)))
        peak = max(peak, len(resident))

    pos = -1                       # index into the local chain
    for kind, i in sequence:
        res = results[i]
        if kind == "glob":
            # wrapGLOB: conventional load-then-MAC flow.
            stream = np.concatenate(key_segments(i))
            all_q = np.arange(len(res.qtypes))
            resident.extend((i, int(q)) for q in all_q)
            emit("globLoad", -1, i, (), all_q, 0)
            emit("globMAC", i, -1, stream, (), n_active=len(all_q))
            for q in all_q.tolist():
                resident.remove((i, int(q)))
            continue

        pos += 1
        dominant, minor, glob = _split_queries(res)
        first_seg, mid_seg, last_seg = key_segments(i)

        if pos == 0:
            # Pipeline fill: load major queries of the first head.
            resident.extend((i, int(q)) for q in np.concatenate([dominant, glob]))
            emit("init", -1, i, (), np.concatenate([dominant, glob]), 0)

        # intoHD — first-streamed s_h keys (minor queries don't need them).
        emit("intoHD", i, i, first_seg, minor,
             n_active=len(dominant) + len(glob))
        resident.extend((i, int(q)) for q in minor)

        # midstHD — middle keys vs every resident query of this head.
        if len(mid_seg) > 0:
            emit("midstHD", i, -1, mid_seg, (),
                 n_active=len(dominant) + len(minor) + len(glob))

        # outtaHD — last-streamed s_h keys; dominant queries retire, next
        # head's major queries stream into the freed slots.
        for q in dominant.tolist():
            resident.remove((i, int(q)))
        if pos + 1 < len(local):
            nxt = results[local[pos + 1]]
            ndom, _, nglob = _split_queries(nxt)
            incoming = np.concatenate([ndom, nglob])
            q_head = local[pos + 1]
        else:
            incoming, q_head = np.asarray([], dtype=np.int64), -1
        resident.extend((q_head, int(q)) for q in incoming)
        emit("outtaHD", i, q_head, last_seg, incoming,
             n_active=len(minor) + len(glob))
        for q in minor.tolist() + glob.tolist():
            resident.remove((i, int(q)))

    return Schedule(steps=tuple(steps), n_tokens=n_tokens,
                    n_heads=len(results), peak_residency=peak)


def schedule_heads(masks: np.ndarray, seed: int = 0,
                   theta: Optional[int] = None,
                   skip_empty_keys: bool = False) -> Tuple[Schedule, List[SortResult]]:
    """Convenience: Algo 1 per head + Algo 2 across heads.

    masks: (n_heads, N_q, N_k) boolean selective masks.
    """
    results = [sort_and_classify(masks[h], seed=seed, theta=theta)
               for h in range(masks.shape[0])]
    sched = build_schedule(results, masks=list(masks),
                           skip_empty_keys=skip_empty_keys)
    return sched, results


def coverage_ok(schedule: Schedule, masks: np.ndarray) -> bool:
    """Invariant: every selected (q, k) pair is computable — when key k of
    head h is MAC'd, query q is resident; and each key streams exactly once."""
    masks = np.asarray(masks, dtype=bool)
    seen_keys = {h: [] for h in range(masks.shape[0])}
    for s in schedule.steps:
        if s.k_head < 0:
            continue
        res = set(s.resident)
        for k in s.k_mac:
            seen_keys[s.k_head].append(k)
            needed = {(s.k_head, int(q))
                      for q in np.flatnonzero(masks[s.k_head][:, k])}
            if not needed <= res:
                return False
    for h in range(masks.shape[0]):
        nonzero_cols = set(np.flatnonzero(masks[h].any(axis=0)).tolist())
        ks = seen_keys[h]
        if len(ks) != len(set(ks)):
            return False                      # a key streamed twice
        if not nonzero_cols <= set(ks):
            return False                      # a needed key never streamed
    return True
