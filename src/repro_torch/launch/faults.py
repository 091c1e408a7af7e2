"""Deterministic fault injection for the paged serving loop — port of
``repro.launch.faults`` (a copy: the port imports nothing of the JAX
package).

A ``FaultPlan`` is a seeded, fully explicit schedule of adverse events
keyed on the serving loop's step counter, so every backpressure branch
in ``launch.serve`` (boundary stall, CoW stall, admission deferral,
preemption by host swap or requeue, mid-serve crash and restart from
swapped host state) is drivable from tests.  The events:

  pool_squeeze(step, pages)   withhold free pages (external memory
                              pressure) — ``PageAllocator.squeeze``
  pool_restore(step, pages)   return squeezed pages (None = all)
  preempt(step, slot)         force-preempt a slot (None = the loop's
                              own victim policy picks)
  defer_admission(step)       skip the claim loop for one iteration
  crash_step(step)            drop the device cache + allocator; the
                              loop swaps all live state to host first
                              and restores from the swap handles
  load_spike(step, severity)  sustained overload signal: with the QoS
                              ladder on, every active slot steps down
                              ``severity`` rungs; ladder off, the loop
                              preempts ``severity`` victims
  slow_step(step)             step-deadline miss signal: one pressure
                              tick into the QoS controller (no-op
                              beyond a counter when the ladder is off)
  corrupt_page(step, nth)     flip one byte in the ``nth`` outstanding
                              host swap handle (bit-rot injection);
                              integrity checksums must catch it at
                              swap-in, quarantine the pages, and
                              recover the victim by re-prefill

The schedule is data: the serving loop replays it identically every
run, so serve outputs bitwise equal to the fault-free run are
assertable.  ``FaultPlan.seeded`` and ``seeded_overload`` derive a
schedule from a seed with the reference's draw order, so one seed gives
the same schedule in both packages.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

Event = Tuple[str, Optional[int]]


class FaultPlan:
    """A step-keyed fault schedule, built by chaining.  All mutators return
    ``self`` so schedules chain:

        FaultPlan().pool_squeeze(4, pages=6).pool_restore(12).crash_step(20)
    """

    def __init__(self) -> None:
        self._events: Dict[int, List[Event]] = {}

    def _add(self, step: int, kind: str, arg: Optional[int]) -> "FaultPlan":
        assert step >= 0, step
        self._events.setdefault(int(step), []).append((kind, arg))
        return self

    def pool_squeeze(self, step: int, pages: int) -> "FaultPlan":
        return self._add(step, "pool_squeeze", int(pages))

    def pool_restore(self, step: int,
                     pages: Optional[int] = None) -> "FaultPlan":
        return self._add(step, "pool_restore",
                         None if pages is None else int(pages))

    def preempt(self, step: int, slot: Optional[int] = None) -> "FaultPlan":
        return self._add(step, "preempt",
                         None if slot is None else int(slot))

    def defer_admission(self, step: int) -> "FaultPlan":
        return self._add(step, "defer_admission", None)

    def crash_step(self, step: int) -> "FaultPlan":
        return self._add(step, "crash_step", None)

    def load_spike(self, step: int, severity: int = 1) -> "FaultPlan":
        return self._add(step, "load_spike", int(severity))

    def slow_step(self, step: int) -> "FaultPlan":
        return self._add(step, "slow_step", None)

    def corrupt_page(self, step: int, nth: int = 0) -> "FaultPlan":
        return self._add(step, "corrupt_page", int(nth))

    def at(self, step: int) -> List[Event]:
        """Events scheduled for this loop step (empty list if none)."""
        return self._events.get(int(step), [])

    @property
    def empty(self) -> bool:
        return not self._events

    @property
    def has_crash(self) -> bool:
        return any(kind == "crash_step"
                   for evs in self._events.values() for kind, _ in evs)

    @property
    def last_step(self) -> int:
        return max(self._events, default=-1)

    def describe(self) -> str:
        lines = []
        for step in sorted(self._events):
            for kind, arg in self._events[step]:
                lines.append(f"step {step:4d}: {kind}"
                             + (f"({arg})" if arg is not None else ""))
        return "\n".join(lines) if lines else "(no faults)"

    @classmethod
    def seeded(cls, seed: int, *, steps: int, n_events: int = 6,
               max_squeeze: int = 8, slots: Optional[int] = None,
               allow_crash: bool = False) -> "FaultPlan":
        """Random-but-reproducible schedule over ``steps`` loop steps:
        squeeze/restore pairs, forced preemptions, admission deferrals,
        and (``allow_crash``) at most one crash.  Every draw comes from
        the seeded generator, so the same seed always yields the same
        schedule — suitable for property tests and the seeded
        serve-smoke."""
        rng = np.random.default_rng(seed)
        plan = cls()
        crash_used = False
        kinds = ["squeeze", "preempt", "defer"]
        for _ in range(n_events):
            kind = kinds[int(rng.integers(len(kinds)))]
            step = int(rng.integers(1, max(steps - 2, 2)))
            if kind == "squeeze":
                pages = int(rng.integers(1, max_squeeze + 1))
                plan.pool_squeeze(step, pages)
                plan.pool_restore(min(step + int(rng.integers(2, 8)),
                                      steps - 1))
            elif kind == "preempt":
                slot = (None if slots is None
                        else int(rng.integers(slots)))
                plan.preempt(step, slot)
            else:
                plan.defer_admission(step)
        if allow_crash and not crash_used:
            plan.crash_step(int(rng.integers(2, max(steps - 2, 3))))
        return plan

    @classmethod
    def seeded_overload(cls, seed: int, *, steps: int,
                        n_spikes: int = 2, max_severity: int = 2,
                        n_corrupt: int = 1,
                        n_slow: int = 2) -> "FaultPlan":
        """Overload-flavored seeded schedule: load spikes with paired
        slow-step pressure ticks (each spike is a sustained episode,
        not a blip) and host-handle corruption events.  Independent of
        :meth:`seeded` — its draw sequence stays frozen so existing
        committed schedules never shift."""
        rng = np.random.default_rng(seed)
        plan = cls()
        lo, hi = 2, max(steps - 4, 3)
        for _ in range(n_spikes):
            step = int(rng.integers(lo, hi))
            sev = int(rng.integers(1, max_severity + 1))
            plan.load_spike(step, sev)
            for _ in range(int(rng.integers(1, n_slow + 1))):
                plan.slow_step(min(step + 1 + int(rng.integers(0, 3)),
                                   steps - 1))
        for _ in range(n_corrupt):
            plan.corrupt_page(int(rng.integers(lo, hi)),
                              int(rng.integers(0, 2)))
        return plan
