"""Quickstart on the PyTorch port: SATA end to end.

1. Build top-k selective masks for a KVT-like workload.
2. Run Algo 1 (sort+classify) + Algo 2 (FSM schedule) and print the
   Tab.-I statistics.
3. Simulate scheduled vs dense/gated execution (Fig. 4a) on the CIM
   model: the gains are modeled ratios, not device measurements.
4. Plan the block-sparse execution and run the prefill kernel in mask
   mode against the exact top-k oracle (on the CPU, the kernel's plain
   version).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.workloads import WORKLOADS
from repro_torch.core import (HwConfig, plan, simulate_dense, simulate_gated,
                              simulate_tiled_sata)
from repro_torch.core.blockmap import block_skip_fraction
from repro_torch.core.masks import SyntheticTrace, synthetic_masks
from repro_torch.kernels.ops import sata_attention, sata_attention_reference


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    # --- 1-3: the paper's evaluation plane --------------------------------
    w = WORKLOADS["kvt_tiny"]
    masks = synthetic_masks(0, w.trace, w.n_heads, device=dev)
    p = plan(masks, s_f=w.s_f)
    print(f"workload {w.name}: N={w.n_tokens} K={w.k} S_f={w.s_f}")
    print(f"  post-schedule stats: GlobQ%={p.stats.glob_q_frac:.3f} "
          f"(paper {w.paper_glob_q}), S_h={p.stats.avg_s_h_frac:.3f}N "
          f"(paper {w.paper_s_h_frac}N)")
    hw = HwConfig()
    r = simulate_tiled_sata(p.tiled, w.d_k, hw)
    d = simulate_dense(masks, w.d_k, hw)
    g = simulate_gated(masks, w.d_k, hw)
    print(f"  modeled throughput gain vs dense: {r.throughput_gain(d):.2f}x "
          f"(paper {w.paper_throughput_gain}x)")
    print(f"  modeled energy-eff gain vs dense: {r.energy_eff_gain(d):.2f}x "
          f"(paper {w.paper_energy_gain}x)")
    print(f"  gated baseline saves energy but not time: "
          f"{g.latency_cycles/d.latency_cycles:.2f}x latency, "
          f"{d.energy_pj/g.energy_pj:.2f}x energy")

    # --- 4: the block-sparse kernel ----------------------------------------
    tr = SyntheticTrace(n_tokens=256, k=32, cluster_scale=3.0,
                        discrete_clusters=8, noise=0.3)
    m = torch.from_numpy(synthetic_masks(0, tr, n_heads=2, device=dev)).to(dev)
    rng = np.random.default_rng(0)
    q, k_, v = (torch.from_numpy(rng.standard_normal((2, 256, 64))
                                 .astype(np.float32)).to(dev)
                for _ in range(3))
    out, bm = sata_attention(q, k_, v, m, q_block=32, k_block=32)
    ref = sata_attention_reference(q, k_, v, m)
    print(f"{'cuda' if dev.type == 'cuda' else 'plain'} kernel on {dev}: "
          f"block skip {float(block_skip_fraction(bm)):.2%}, max err vs "
          f"exact top-k oracle {float((out - ref).abs().max()):.2e}")


if __name__ == "__main__":
    main()
