"""The paper's four selective-attention workloads (Tab. I) — port of
``repro.configs.workloads``, on the port's ``SyntheticTrace``.

| model          | D_k    | K/N     | 0-skip | S_f      | paper GlobQ% | paper S_h |
|----------------|--------|---------|--------|----------|--------------|-----------|
| TTST           | 65536  | 15/30   | off    | N        | 24.2%        | 0.463 N   |
| KVT-DeiT-Tiny  | 64     | 50/198  | on     | 0.11 N   | 33.3%        | 0.053 N   |
| KVT-DeiT-Base  | 64     | 64/198  | on     | 0.11 N   | 46.4%        | 0.051 N   |
| DRSformer      | 4800   | 12/48   | on     | 0.125 N  | 14.8%        | 0.062 N   |

The authors' runtime traces are not available; masks are drawn from
the locality-structured synthetic generator (``core.masks.SyntheticTrace``)
whose cluster/band/noise parameters are calibrated so the *post-schedule
statistics* land near Tab. I.  The gains are the CIM simulator's modeled
ratios (``core.simulator``), not measurements of any device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.masks import SyntheticTrace


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    n_tokens: int
    k: int
    d_k: int
    s_f: Optional[int]            # None → untiled (whole-head sorting)
    zero_skip: bool
    n_heads: int
    trace: SyntheticTrace
    paper_throughput_gain: float  # Fig. 4a claims
    paper_energy_gain: float
    paper_glob_q: float           # Tab. I
    paper_s_h_frac: float
    paper_n_dec: float


WORKLOADS: Dict[str, Workload] = {
    # Calibration notes (the reference's masks; modeled, paper in ()):
    #  ttst      → thr 1.42 (1.47), en 1.25 (1.81), S_h 0.494 (0.463)
    #  kvt_tiny  → thr 1.81 (1.76), en 1.94 (2.10), GlobQ 0.332 (0.333)
    #  kvt_base  → thr 1.70 (1.59), en 1.77 (1.85)
    #  drsformer → thr 1.25 (1.50), en 1.71 (2.94), zero-skip 0.74
    # Residual gaps (ttst/drsformer energy) stem from trace microstructure
    # that cannot be reconstructed without the authors' runtime traces.
    "ttst": Workload(
        name="TTST", n_tokens=30, k=15, d_k=65536, s_f=None,
        zero_skip=False, n_heads=6,
        trace=SyntheticTrace(n_tokens=30, k=15, cluster_rank=1,
                             cluster_scale=5.0, noise=0.2),
        paper_throughput_gain=1.47, paper_energy_gain=1.81,
        paper_glob_q=0.242, paper_s_h_frac=0.463, paper_n_dec=1.55),
    "kvt_tiny": Workload(
        name="KVT-DeiT-Tiny", n_tokens=198, k=50, d_k=64, s_f=22,
        zero_skip=True, n_heads=3,
        trace=SyntheticTrace(n_tokens=198, k=50, cluster_rank=2,
                             cluster_scale=1.0, band_width=15.0,
                             band_scale=2.5, noise=0.35),
        paper_throughput_gain=1.76, paper_energy_gain=2.10,
        paper_glob_q=0.333, paper_s_h_frac=0.053, paper_n_dec=0.62),
    "kvt_base": Workload(
        name="KVT-DeiT-Base", n_tokens=198, k=64, d_k=64, s_f=22,
        zero_skip=True, n_heads=12,
        trace=SyntheticTrace(n_tokens=198, k=64, cluster_rank=2,
                             cluster_scale=1.0, band_width=18.0,
                             band_scale=3.0, noise=0.35),
        paper_throughput_gain=1.59, paper_energy_gain=1.85,
        paper_glob_q=0.464, paper_s_h_frac=0.051, paper_n_dec=1.38),
    "drsformer": Workload(
        name="DRSformer", n_tokens=48, k=12, d_k=4800, s_f=6,
        zero_skip=True, n_heads=6,
        trace=SyntheticTrace(n_tokens=48, k=12, cluster_rank=2,
                             cluster_scale=0.5, band_width=6.0,
                             band_scale=4.0, block_quant=12, noise=0.45),
        paper_throughput_gain=1.50, paper_energy_gain=2.94,
        paper_glob_q=0.148, paper_s_h_frac=0.062, paper_n_dec=0.05),
}
