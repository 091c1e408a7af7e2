"""End-to-end SATA planner: mask → sort → classify → schedule → stats —
port of ``repro.core.sata`` (the reference's numpy, copied).

This is the paper's full pipeline for one attention layer, plus the
post-schedule statistics reported in Tab. I (GlobQ%, average heavy size,
average S_h-decrement count, GLOB-head fraction).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.scheduling import Schedule, schedule_heads
from repro_torch.core.sorting import HeadType, QType, SortResult
from repro_torch.core.tiling import TiledPlan, plan_tiled, tiled_schedule


@dataclasses.dataclass(frozen=True)
class SataStats:
    """Tab.-I style post-schedule statistics."""
    glob_q_frac: float            # GlobQ%
    avg_s_h_frac: float           # avg S_h / N (or / S_f when tiled)
    avg_n_decrements: float       # avg #(S_h -= 1)
    glob_head_frac: float         # fraction of (sub)heads stuck GLOB
    n_heads: int
    n_tokens: int


def stats_from_results(results: Sequence[SortResult],
                       n_ref: Optional[int] = None) -> SataStats:
    if not results:
        return SataStats(0.0, 0.0, 0.0, 0.0, 0, 0)
    n_glob_q = sum(int((r.qtypes == QType.GLOB).sum()) for r in results)
    n_q = sum(len(r.qtypes) for r in results)
    # Tab. I reports S_h relative to the ORIGINAL sequence length N,
    # also for tiled workloads (e.g. 0.053N with S_f = 0.11N).
    fracs = [r.s_h / max(n_ref or len(r.kid), 1) for r in results]
    decs = [r.n_decrements for r in results]
    globs = sum(1 for r in results if r.head_type == HeadType.GLOB)
    return SataStats(
        glob_q_frac=n_glob_q / max(n_q, 1),
        avg_s_h_frac=float(np.mean(fracs)),
        avg_n_decrements=float(np.mean(decs)),
        glob_head_frac=globs / len(results),
        n_heads=len(results),
        n_tokens=len(results[0].kid))


@dataclasses.dataclass(frozen=True)
class SataPlan:
    """A complete executable plan for one multi-head selective layer."""
    schedule: Schedule
    results: Tuple[SortResult, ...]
    stats: SataStats
    tiled: Optional[TiledPlan] = None


def plan(masks: np.ndarray, s_f: Optional[int] = None, seed: int = 0,
         theta: Optional[int] = None) -> SataPlan:
    """Build the SATA plan for (n_heads, N, N) selective masks.

    ``s_f``: tile size; ``None`` or ``>= N`` disables tiling (TTST-style
    whole-head sorting).
    """
    masks = np.asarray(masks, dtype=bool)
    n = masks.shape[-1]
    if s_f is not None and s_f < n:
        tp = plan_tiled(masks, s_f, seed=seed)
        sched, _ = tiled_schedule(tp)
        stats = stats_from_results([t.result for t in tp.tiles], n_ref=n)
        return SataPlan(schedule=sched,
                        results=tuple(t.result for t in tp.tiles),
                        stats=stats, tiled=tp)
    sched, results = schedule_heads(masks, seed=seed, theta=theta)
    return SataPlan(schedule=sched, results=tuple(results),
                    stats=stats_from_results(results), tiled=None)
