"""Sec. III-D — tiling + zero-skip for long sequences — port of
``repro.core.tiling`` (the reference's numpy, copied).

The N×N selective mask is partitioned into ``S_f × S_f`` sub-blocks;
each non-empty tile is treated as a *sub-head*: all-zero rows/columns
inside the tile are skipped (zero-skip), the remaining local mask is
sorted/classified per Algo 1, and the resulting sub-heads enter the
Algo-2 FSM schedule.

Tile execution order is **Q-fold-major**: all tiles sharing a Q-fold run
consecutively, so the fold's queries are written into the stationary
array once and *stay resident* while the fold's K-tiles stream past
("Sorting would be conducted across Q-folds while fold-wise Ks are
reused", Sec. III-D — keys are re-streamed from the on-chip fold buffer,
queries are written once per fold).  The simulator charges query array
writes only on first touch within a fold group and key DRAM energy only
on the first stream of each key.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.scheduling import Schedule, build_schedule
from repro_torch.core.sorting import SortResult, sort_and_classify


@dataclasses.dataclass(frozen=True)
class Tile:
    head: int                 # original head index
    q_fold: int
    k_fold: int
    q_idx: np.ndarray         # global query indices kept after zero-skip
    k_idx: np.ndarray         # global key indices kept after zero-skip
    mask: np.ndarray          # local (len(q_idx), len(k_idx)) mask
    result: SortResult        # Algo-1 result in local coordinates


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    tiles: Tuple[Tile, ...]
    s_f: int
    n_tiles_total: int
    n_tiles_skipped: int      # all-zero tiles elided entirely
    n_rows_skipped: int       # zero-skipped query rows across kept tiles
    n_cols_skipped: int       # zero-skipped key columns across kept tiles

    @property
    def zero_skip_fraction(self) -> float:
        """Fraction of tile rows+cols elided by zero-skip + empty tiles."""
        total_rc = 2 * self.n_tiles_total * self.s_f
        skipped = (self.n_rows_skipped + self.n_cols_skipped
                   + 2 * self.n_tiles_skipped * self.s_f)
        return skipped / max(total_rc, 1)


def plan_tiled(masks: np.ndarray, s_f: int, seed: int = 0,
               theta_frac: float = 0.5) -> TiledPlan:
    """Tile every head's mask into S_f×S_f sub-heads (K-fold-major order).

    masks: (n_heads, N_q, N_k) bool.
    """
    masks = np.asarray(masks, dtype=bool)
    n_heads, n_q, n_k = masks.shape
    qf = -(-n_q // s_f)
    kf = -(-n_k // s_f)
    tiles: List[Tile] = []
    n_skipped = rows_skipped = cols_skipped = 0
    for h in range(n_heads):
        for q_fold in range(qf):              # Q-fold-major: queries resident
            for k_fold in range(kf):
                q0, q1 = q_fold * s_f, min((q_fold + 1) * s_f, n_q)
                k0, k1 = k_fold * s_f, min((k_fold + 1) * s_f, n_k)
                sub = masks[h, q0:q1, k0:k1]
                if not sub.any():
                    n_skipped += 1
                    continue
                keep_q = sub.any(axis=1)       # zero-skip rows
                keep_k = sub.any(axis=0)       # zero-skip cols
                rows_skipped += int((~keep_q).sum())
                cols_skipped += int((~keep_k).sum())
                local = sub[keep_q][:, keep_k]
                theta = max(1, int(theta_frac * local.shape[0]))
                res = sort_and_classify(local, seed=seed, theta=theta)
                tiles.append(Tile(
                    head=h, q_fold=q_fold, k_fold=k_fold,
                    q_idx=np.arange(q0, q1)[keep_q],
                    k_idx=np.arange(k0, k1)[keep_k],
                    mask=local, result=res))
    return TiledPlan(tiles=tuple(tiles), s_f=s_f,
                     n_tiles_total=n_heads * qf * kf,
                     n_tiles_skipped=n_skipped,
                     n_rows_skipped=rows_skipped,
                     n_cols_skipped=cols_skipped)


def tiled_schedule(plan: TiledPlan) -> Tuple[Schedule, List[np.ndarray]]:
    """Algo-2 FSM schedule over the sub-heads of a tiled plan.

    Returns the schedule plus the local masks (sub-head order) so that
    coverage invariants and the simulator can resolve operands.
    """
    results = [t.result for t in plan.tiles]
    local_masks = [t.mask for t in plan.tiles]
    sched = build_schedule(results, masks=local_masks, skip_empty_keys=False,
                           group_of=fold_group_ids(plan))
    return sched, local_masks


def fold_group_ids(plan: TiledPlan) -> np.ndarray:
    """(n_subheads,) group id — consecutive sub-heads sharing (head, q_fold).

    Queries loaded within one group stay resident in the stationary array
    until the group ends; re-loads inside the group are free.
    """
    ids, cur, last = [], -1, None
    for t in plan.tiles:
        key = (t.head, t.q_fold)
        if key != last:
            cur += 1
            last = key
        ids.append(cur)
    return np.asarray(ids, dtype=np.int64)
