"""Roofline of the SATA prefill kernel's two schedules on one H100 —
port of ``repro.launch.roofline``'s ``analyse_kernel`` (``--kernel``).

    compute = FLOPs of the occupied tiles / 989 TFLOP/s (bf16 dense)
    memory  = (K/V fetch bytes + Q bytes) / 3.35 TB/s (HBM3)

both from the published peaks of an NVIDIA H100 SXM (NVIDIA's data
sheet, at its 700 W power limit).  The counts come from the port's
``kernels.ops.kernel_fetch_stats`` on ``core.blockmap.fixed_occupancy_map``
maps, the reference's inputs; only the peaks differ from the reference,
which divides the same counts by a TPU v5e's.

The per-cell roofline (``analyse_cell``, ``print_table``) lowers whole
models through ``launch/dryrun.py`` to a TPU mesh; it is ROADMAP queue A
item 5 and raises here.

Usage:
  python -m repro_torch.launch.roofline --kernel [--out-dir DIR]
"""
from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from repro_torch.core.blockmap import fixed_occupancy_map
from repro_torch.kernels.ops import kernel_fetch_stats

H100_BF16_FLOPS = 989e12     # FLOP/s, H100 SXM bf16 dense, data sheet
H100_HBM_BW = 3.35e12        # B/s, H100 SXM HBM3, data sheet

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
           / "roofline")

_CELL = ("the per-cell roofline lowers through launch/dryrun.py, which is "
         "not ported (ROADMAP queue A item 5)")


def _units(cfg):
    raise NotImplementedError(_CELL)


def _measure(arch, shape_name, cfg, cp=True):
    raise NotImplementedError(_CELL)


def analyse_cell(arch: str, shape_name: str, verbose: bool = True,
                 cp: bool = True, tag_suffix: str = ""):
    raise NotImplementedError(_CELL)


def print_table():
    raise NotImplementedError(_CELL)


def analyse_kernel(seq: int = 2048, d: int = 64, bh: int = 8,
                   block: int = 128, occ_frac: float = 0.5,
                   verbose: bool = True, out_dir=OUT_DIR) -> dict:
    """Roofline the SATA kernel's two schedules against each other.

    The dense grid's HBM term streams every K/V tile; the compacted grid
    streams only occupied tiles (``kernel_fetch_stats`` counts both).
    Compute is identical across schedules per occupied tile — the dense
    grid visits empty tiles but computes nothing there — so the gap is
    memory and scheduling.  Writes
    ``<out_dir>/sata_kernel__s{seq}_b{block}_occ{frac}.json``; the JSON's
    ``path`` says where."""
    nqb = nkb = seq // block
    occ = max(1, int(occ_frac * nkb))
    bm = fixed_occupancy_map(np.random.default_rng(0), bh, nqb, nkb, occ)
    stats = kernel_fetch_stats(bm, q_block=block, k_block=block, d=d,
                               dtype_bytes=2, max_kv_blocks=occ)
    # per occupied tile: QK^T + PV, 2·(block·block·d) MACs: 4·b²·d flops
    flops_per_tile = 4 * block * block * d
    occupied = int(bm.sum())
    flops = occupied * flops_per_tile
    q_bytes = bh * nqb * block * d * 2            # one Q tile per row
    bytes_dense = stats["kv_fetch_bytes_dense"] + q_bytes
    bytes_compact = stats["kv_fetch_bytes_compact"] + q_bytes
    t_compute = flops / H100_BF16_FLOPS
    t_mem_dense = bytes_dense / H100_HBM_BW
    t_mem_compact = bytes_compact / H100_HBM_BW
    out_dir = pathlib.Path(out_dir)
    cell = f"sata_kernel__s{seq}_b{block}_occ{occ_frac}"
    out = {
        "cell": cell,
        "device": "NVIDIA H100 SXM (data-sheet peaks, 700 W)",
        "peaks": {"bf16_flops_per_s": H100_BF16_FLOPS,
                  "hbm_bytes_per_s": H100_HBM_BW},
        "shape": {"bh": bh, "seq": seq, "d": d, "block": block,
                  "occ_frac": occ_frac},
        "fetch": stats,
        "work": {"flops": flops, "bytes_dense": bytes_dense,
                 "bytes_compact": bytes_compact},
        "terms_s": {
            "compute_s": t_compute,
            "memory_dense_s": t_mem_dense,
            "memory_compact_s": t_mem_compact,
        },
        "bound_dense": ("memory" if t_mem_dense > t_compute else "compute"),
        "bound_compact": ("memory" if t_mem_compact > t_compute
                          else "compute"),
        "modeled_speedup": (max(t_mem_dense, t_compute)
                            / max(t_mem_compact, t_compute)),
        "path": str(out_dir / f"{cell}.json"),
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    pathlib.Path(out["path"]).write_text(json.dumps(out, indent=1))
    if verbose:
        print(f"[roofline] {cell}: compute {t_compute*1e6:.1f}us, "
              f"mem dense {t_mem_dense*1e6:.1f}us → compact "
              f"{t_mem_compact*1e6:.1f}us "
              f"(fetch {stats['fetch_reduction']:.2f}x down, modeled "
              f"speedup {out['modeled_speedup']:.2f}x, "
              f"{out['bound_dense']}→{out['bound_compact']}-bound) "
              f"-> {out['path']}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", action="store_true",
                    help="roofline the SATA kernel schedules (dense vs "
                         "compacted grid: time terms + fetch bytes)")
    ap.add_argument("--out-dir", default=str(OUT_DIR),
                    help="where the JSON files go (default %(default)s)")
    args = ap.parse_args(argv)
    if not args.kernel:
        raise NotImplementedError(_CELL)
    for occ in (0.25, 0.5, 0.75):
        analyse_kernel(occ_frac=occ, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
