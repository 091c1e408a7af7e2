"""ASCII rendition of the paper's Fig. 2 on the PyTorch port: mask
sorting, query classification, and the Algo-2 FSM schedule for a small
head.

Run:  PYTHONPATH=src python examples/schedule_demo_torch.py
"""
import numpy as np

from repro_torch.core import (QType, build_schedule, coverage_ok,
                              sort_and_classify)


def show_mask(mask, title):
    print(f"\n{title}")
    for row in mask:
        print("  " + "".join("#" if v else "." for v in row))


def main():
    rng = np.random.default_rng(4)
    n, k = 12, 4
    # two query groups with shared key preferences + scattered columns
    base = np.zeros((n, n), dtype=bool)
    base[:6, :5] = True
    base[6:, 7:] = True
    base[2, 8] = base[9, 1] = True          # a couple of GLOB-ish queries
    perm = rng.permutation(n)
    mask = base[:, perm]                     # scramble key order

    show_mask(mask, f"selective mask (N={n}, ~K={k}) — scrambled key order")
    res = sort_and_classify(mask, seed=0)
    show_mask(mask[:, res.kid], f"after Algo-1 key sorting "
              f"(S_h={res.s_h}, head type {res.head_type.name})")
    names = {QType.HEAD: "HEAD", QType.TAIL: "TAIL", QType.GLOB: "GLOB"}
    print("  query classes:",
          " ".join(names[QType(t)] for t in res.qtypes))

    sched = build_schedule([res])
    print("\nAlgo-2 FSM schedule (one head):")
    for s in sched.steps:
        ks = ",".join(map(str, s.k_mac)) or "-"
        qs = ",".join(map(str, s.q_load)) or "-"
        print(f"  {s.phase:8s} MAC keys [{ks:12s}] "
              f"| load queries [{qs}] (active={s.n_active_q})")
    print("\ncoverage check:", coverage_ok(sched, mask[None]))


if __name__ == "__main__":
    main()
