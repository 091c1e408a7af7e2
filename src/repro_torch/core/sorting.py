"""Algo 1 — intra-head mask sorting and query classification — port of
``repro.core.sorting``.

Given the binary selective mask ``QK ∈ {0,1}^{N_q × N_k}`` (rows =
queries, columns = keys), greedily order keys so columns with similar
access patterns become adjacent, then classify queries as HEAD / TAIL /
GLOB against a "heavy size" ``S_h``.

* ``sort_keys_direct`` — the textbook form of Algo 1 (Eq. 1): a
  cumulative ``dummy`` vector (sum of sorted columns), pick
  ``argmax(dummy · QK[:, i])`` among unsorted keys.
* ``sort_keys_psum`` — the paper's hardware form (Eq. 2): per-key
  partial-sum registers incremented by the binary dot product with the
  most recently sorted column.  Identical output (``Psum[i] ==
  dummy·QK[:,i]`` telescopes).
* ``sort_keys`` — the batched torch sorter (the port of
  ``sort_keys_jax``) the dense selection route's planner runs on the
  device: the same greedy walk over the column Gram matrix
  ``G = maskᵀ·mask``, batched over heads.  In fp32 the Gram matrix and
  the registers are exact integers (below 2^24), and ``torch.argmax``
  returns the first maximum, as ``jnp.argmax`` and ``np.argmax`` do, so
  its order equals ``sort_keys_psum``'s exactly.

The numpy sorters, the classification and the GLOB-escape loop are the
reference's numpy, copied: host analytics of the paper's scheduler.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np
import torch


class QType(enum.IntEnum):
    HEAD = 0
    TAIL = 1
    GLOB = 2


class HeadType(enum.IntEnum):
    HEAD = 0
    TAIL = 1
    GLOB = 2          # head failed to escape GLOB state


@dataclasses.dataclass(frozen=True)
class SortResult:
    kid: np.ndarray           # (N_k,) sorted key order (original key indices)
    qtypes: np.ndarray        # (N_q,) QType per query
    head_type: HeadType
    s_h: int                  # post-schedule heavy size
    n_decrements: int         # how many times S_h -= 1 fired (Tab. I stat)


# ---------------------------------------------------------------------------
# Sorting (Algo 1, lines 4-12)
# ---------------------------------------------------------------------------

def sort_keys_direct(mask: np.ndarray, seed: int = 0) -> np.ndarray:
    """Greedy key ordering via the cumulative ``dummy`` vector (Eq. 1)."""
    mask = np.asarray(mask, dtype=np.int64)
    n_k = mask.shape[1]
    order = np.empty(n_k, dtype=np.int64)
    sorted_set = np.zeros(n_k, dtype=bool)
    kid = seed % n_k
    dummy = mask[:, kid].copy()
    order[0] = kid
    sorted_set[kid] = True
    for step in range(1, n_k):
        dist = dummy @ mask                      # (N_k,) Eq. 1
        dist[sorted_set] = -1
        kid = int(np.argmax(dist))               # ties → lowest index
        order[step] = kid
        sorted_set[kid] = True
        dummy += mask[:, kid]
    return order


def sort_keys_psum(mask: np.ndarray, seed: int = 0) -> np.ndarray:
    """Greedy key ordering via Psum registers (Eq. 2) — hardware form."""
    mask = np.asarray(mask, dtype=np.int64)
    n_k = mask.shape[1]
    order = np.empty(n_k, dtype=np.int64)
    sorted_set = np.zeros(n_k, dtype=bool)
    psum = np.zeros(n_k, dtype=np.int64)
    kid = seed % n_k
    order[0] = kid
    sorted_set[kid] = True
    for step in range(1, n_k):
        # Psum-Reg[i] += QK[:, i]ᵀ · QK[:, kid]   for unsorted i (Eq. 2)
        psum += mask.T @ mask[:, kid]
        masked = np.where(sorted_set, -1, psum)
        kid = int(np.argmax(masked))
        order[step] = kid
        sorted_set[kid] = True
    return order


def sort_keys(mask: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Batched greedy key order.  mask: (..., N_q, N_k) bool →
    (..., N_k) int32.  N_k − 1 sequential argmax steps, each batched
    over every leading dimension (heads)."""
    *batch, _, n_k = mask.shape
    m = mask.reshape(-1, *mask.shape[-2:]).float()
    gram = torch.einsum("bqi,bqj->bij", m, m)                # (H, N_k, N_k)
    h = gram.shape[0]
    dev = mask.device
    rows = torch.arange(h, device=dev)
    start = seed % n_k
    order = torch.empty((h, n_k), dtype=torch.int64, device=dev)
    order[:, 0] = start
    in_set = torch.zeros((h, n_k), dtype=torch.bool, device=dev)
    in_set[:, start] = True
    psum = torch.zeros((h, n_k), dtype=torch.float32, device=dev)
    last = order[:, 0]
    for step in range(1, n_k):
        psum += gram[rows, last]
        nxt = torch.argmax(psum.masked_fill(in_set, -1.0), dim=-1)
        in_set[rows, nxt] = True
        order[:, step] = nxt
        last = nxt
    return order.to(torch.int32).reshape(*batch, n_k)


# ---------------------------------------------------------------------------
# Query classification (Algo 1, lines 14-27)
# ---------------------------------------------------------------------------

def classify_queries(sorted_mask: np.ndarray, s_h: int) -> np.ndarray:
    """QType per query given a key-sorted mask and heavy size ``s_h``.

    * HEAD — touches none of the *last*  ``s_h`` sorted keys.
    * TAIL — touches none of the *first* ``s_h`` sorted keys.
    * GLOB — touches both ends.
    A query qualifying as both (touches neither end) is assigned HEAD,
    consistent with the paper's tie-to-HEAD rule.
    """
    n_k = sorted_mask.shape[1]
    s_h = int(min(s_h, n_k // 2))
    first = sorted_mask[:, :s_h].any(axis=1)
    last = sorted_mask[:, n_k - s_h:].any(axis=1)
    qt = np.full(sorted_mask.shape[0], QType.GLOB, dtype=np.int64)
    qt[~last] = QType.HEAD
    qt[last & ~first] = QType.TAIL
    return qt


def classify_with_escape(
    sorted_mask: np.ndarray,
    theta: Optional[int] = None,
    s_h0: Optional[int] = None,
) -> Tuple[np.ndarray, HeadType, int, int]:
    """The GLOB-escape loop (Algo 1 lines 14-27).

    Start at ``S_h = N/2`` and decrement while #GLOB queries exceeds θ
    (default N/2, the paper's setting).  Returns (qtypes, head_type,
    final s_h, n_decrements).
    """
    n_q, n_k = sorted_mask.shape
    s_h = n_k // 2 if s_h0 is None else int(s_h0)
    theta = n_q // 2 if theta is None else int(theta)
    n_dec = 0
    while True:
        qt = classify_queries(sorted_mask, s_h)
        n_glob = int((qt == QType.GLOB).sum())
        if n_glob > theta and s_h > 0:
            s_h -= 1
            n_dec += 1
            continue
        break
    if s_h == 0:
        # Degenerate: no locality exploitable — head stays GLOB.
        return qt, HeadType.GLOB, s_h, n_dec
    n_head = int((qt == QType.HEAD).sum())
    n_tail = int((qt == QType.TAIL).sum())
    ht = HeadType.HEAD if n_head >= n_tail else HeadType.TAIL   # tie → HEAD
    return qt, ht, s_h, n_dec


def sort_and_classify(mask: np.ndarray, seed: int = 0,
                      theta: Optional[int] = None,
                      use_psum: bool = True) -> SortResult:
    """Full Algo 1 for one head: sort keys, classify queries, escape GLOB."""
    mask = np.asarray(mask, dtype=bool)
    kid = (sort_keys_psum if use_psum else sort_keys_direct)(mask, seed)
    sorted_mask = mask[:, kid]
    qt, ht, s_h, n_dec = classify_with_escape(sorted_mask, theta)
    return SortResult(kid=kid, qtypes=qt, head_type=ht, s_h=s_h,
                      n_decrements=n_dec)


def locality_score(sorted_mask: np.ndarray) -> float:
    """Mean adjacent-column similarity — the quantity greedy sorting
    maximizes stepwise; used by tests to check sorted ≥ unsorted."""
    m = np.asarray(sorted_mask, dtype=np.float64)
    sims = (m[:, :-1] * m[:, 1:]).sum(axis=0)
    return float(sims.mean())
