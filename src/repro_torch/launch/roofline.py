"""Roofline analysis on H100s — port of ``repro.launch.roofline``: the
three terms per (arch × shape) cell on the single-pod mesh, with the
dominant bottleneck identified (``analyse_cell``), and the SATA prefill
kernel's two schedules against each other (``analyse_kernel``,
``--kernel``).

    compute     = FLOPs / 989 TFLOP/s (bf16 dense)
    memory      = bytes / 3.35 TB/s (HBM3)
    collective  = collective bytes / 450 GB/s (NVLink, each way)

all published peaks of an NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W power limit); only the peaks differ from the reference, which
divides by a TPU v5e's.  The production mesh's 16-wide axes span two
8-card hosts, whose links between hosts are slower than NVLink: the
collective term is optimistic there.

A cell's counts come from the dry run (``launch.dryrun.run_cell``):
rank 0 of the 16×16 mesh tracing the port's step on meta tensors, per
device.  The probe-and-extrapolate arithmetic is the reference's: each
cell runs at 1-unit and 2-unit depth (unit = 1 layer, or one hybrid /
vlm group), and ``total = fixed + n_units × per_unit``.  The reference
needs the probes because XLA counts a ``while`` body once; the port's
counter sees every op, so the probes only save tracing time, and its
probe configs set ``micro_steps=1`` as the reference's do (the dry run's
loops are Python loops, so the reference's ``q_chunk`` and
``scan_layers`` overrides change nothing that is counted and are not
set).  rwkv6's time scan is a Python loop whose ``r·S`` product the
counter sees step by step; the reference's analytic term (≈5·hd² MACs
per head and step) is added only for the four elementwise products the
counter does not count as FLOPs.

MODEL_FLOPS = 6·N·tokens (train) / 2·N_active·tokens (inference); the
ratio MODEL_FLOPS / counted FLOPs measures how much of the computed
work is "useful" (remat recompute, selection and attention overhead;
in a decode cell also every "model" rank computing the attention's
projections whole where ``ShardLayout`` builds no head-parallel region
for them: on a 16-wide axis, every arch with fewer than 16 KV heads,
though its scoring, re-plan and kernel run on the rank's 1/16 of the
keys (``CACHE_SEQ_SHARD``); a train or prefill cell is
context-parallel, ``run_cell``'s ``cp``, and splits every layer over
"model").

Usage:
  python -m repro_torch.launch.roofline --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.roofline --all [--skip-done]
  python -m repro_torch.launch.roofline --table   # markdown from build/
  python -m repro_torch.launch.roofline --kernel [--out-dir DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback

import numpy as np
import torch

from repro_torch.configs.archs import ARCHS, SHAPES, all_cells
from repro_torch.core.blockmap import fixed_occupancy_map
from repro_torch.distributed.sharding import ShardLayout
from repro_torch.kernels.ops import kernel_fetch_stats
from repro_torch.launch.dryrun import (decode_cache, decode_param_mode,
                                       main_path_cfg, run_cell)
from repro_torch.launch.mesh import ShardMesh

H100_BF16_FLOPS = 989e12     # FLOP/s, H100 SXM bf16 dense, data sheet
H100_HBM_BW = 3.35e12        # B/s, H100 SXM HBM3, data sheet
H100_NVLINK_BW = 450e9       # B/s each way, H100 SXM NVLink 4, data sheet

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
           / "roofline")

CHIPS = 256                  # the single-pod mesh


def _units(cfg):
    """(unit size in layers, n_units, the config of k units as a
    function of k)."""
    probe = dict(scan_layers=False, micro_steps=1)
    if cfg.family == "hybrid":
        u = cfg.hybrid_period
        build = lambda k: dataclasses.replace(cfg, n_layers=u * k, **probe)
    elif cfg.family == "vlm":
        u = cfg.cross_attn_period
        build = lambda k: dataclasses.replace(cfg, n_layers=u * k, **probe)
    elif cfg.family == "audio":
        u = 1
        build = lambda k: dataclasses.replace(cfg, n_layers=k,
                                              encoder_layers=k, **probe)
    else:
        u = 1
        build = lambda k: dataclasses.replace(cfg, n_layers=k, **probe)
    return u, cfg.n_layers // u, build


def _measure(arch, shape_name, cfg, param_mode=None, cp=True):
    r = run_cell(arch, shape_name, multi_pod=False, save=False,
                 verbose=False, cfg=cfg, tag_suffix="__probe",
                 param_mode=param_mode, cp=cp)
    flops = r["cost"].get("flops", 0.0)
    byts = r["cost"].get("bytes accessed", 0.0)
    coll = r["collectives"].get("total_bytes", 0.0)
    return flops, byts, coll, r


def _pod1_rank0():
    """Rank 0 of the single-pod mesh, for the rules that read only its
    shape (no process group)."""
    return ShardMesh(("data", "model"), {"data": 16, "model": 16}, None, 0,
                     torch.device("meta"))


def _rwkv_heads_per_rank(cfg) -> int:
    """The rwkv6 heads a rank of the single-pod mesh scans (the time mix
    runs on a rank's heads where the layout splits them)."""
    mesh = _pod1_rank0()
    h = cfg.d_model // cfg.rwkv_head_dim
    split = ShardLayout(cfg, mesh).tp_for("layers.0.tmix") is not None
    return h // mesh.shape["model"] if split else h


def _decode_mode(cfg, shape) -> str:
    """The full-depth decode cell's weights' mode, which its probes keep:
    ``decode_param_mode`` of the rank's cache bytes, blocked on meta
    under one layout of ``cfg``."""
    mesh = _pod1_rank0()
    layout = ShardLayout(cfg, mesh, mode="infer_tp")
    return decode_param_mode(cfg, mesh,
                             decode_cache(cfg, shape, layout)[1])


def _probe_line(k, r, secs):
    mem = r["memory"]
    kinds = " ".join(f"{kind} {b:.4g}" for kind, b in
                     sorted(r["collectives"]["per_kind"].items()))
    return (f"[roofline]   probe {k} unit(s): args "
            f"{mem['argument_size_in_bytes'] / 2**30:.3f} GiB/dev, temp "
            f"{mem['temp_size_in_bytes'] / 2**30:.3f} GiB/dev, flops "
            f"{r['cost']['flops']:.4g}, bytes "
            f"{r['cost']['bytes accessed']:.4g}, collectives B/dev "
            f"{{{kinds}}}, {secs:.1f} s on the host")


def analyse_cell(arch: str, shape_name: str, verbose: bool = True,
                 cp: bool = True, tag_suffix: str = ""):
    """The cell's three terms from its two probes (``run_cell``, ``cp``
    passed through: a train or prefill cell context-parallel by default,
    as the reference's)."""
    cfg = main_path_cfg(ARCHS[arch])
    shape = SHAPES[shape_name]
    unit, n_units, build = _units(cfg)
    mode = _decode_mode(cfg, shape) if shape.kind == "decode" else None

    t0 = time.time()
    f1, b1, c1, r1 = _measure(arch, shape_name, build(1), mode, cp)
    t1 = time.time()
    f2, b2, c2, r2 = _measure(arch, shape_name, build(2), mode, cp)
    t2 = time.time()
    pf = max(f2 - f1, 0.0)
    pb = max(b2 - b1, 0.0)
    pc = max(c2 - c1, 0.0)
    flops = max(f1 - pf, 0.0) + n_units * pf
    byts = max(b1 - pb, 0.0) + n_units * pb
    coll = max(c1 - pc, 0.0) + n_units * pc

    scan_flops = 0.0
    if cfg.rwkv and shape.kind != "decode":
        # the reference's ~5·hd² MACs per head and step, ×3 for backward,
        # less the r·S product the counter sees (one of the five)
        b_loc = max(shape.global_batch // 16, 1)     # per-device batch
        h = _rwkv_heads_per_rank(cfg)
        per_step = (5 - 1) * 2 * cfg.rwkv_head_dim ** 2 * h * b_loc
        mult = 3.0 if shape.kind == "train" else 1.0
        scan_flops = cfg.n_layers * shape.seq_len * per_step * mult
        flops += scan_flops

    t_compute = flops / H100_BF16_FLOPS
    t_memory = byts / H100_HBM_BW
    t_coll = coll / H100_NVLINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_active = cfg.active_param_count()
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    hlo_flops_global = flops * CHIPS
    useful = model_flops / max(hlo_flops_global, 1.0)

    bound_note = {
        "compute_s": "scale sparsity/selective compute or raise per-card "
                     "utilization (tensor-core tiles, fewer remat passes)",
        "memory_s": "cut HBM traffic: fuse the selection's passes and "
                    "softmax into kernels, keep operands in shared "
                    "memory longer, or quantize the bandwidth-bound side",
        "collective_s": "reshard to shrink the gathered dim, overlap the "
                        "collective behind per-layer compute, or move the "
                        "axis with less traffic onto the slower links",
    }[dominant]

    out = {
        "cell": f"{arch}__{shape_name}__pod1{tag_suffix}",
        "arch": arch, "shape": shape_name,
        "device": "NVIDIA H100 SXM (data-sheet peaks, 700 W)",
        "peaks": {"bf16_flops_per_s": H100_BF16_FLOPS,
                  "hbm_bytes_per_s": H100_HBM_BW,
                  "nvlink_bytes_per_s": H100_NVLINK_BW},
        "per_device": {"hlo_flops": flops, "hlo_bytes": byts,
                       "collective_bytes": coll,
                       "rwkv_scan_flops": scan_flops},
        "terms_s": terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops": model_flops,
        "hlo_flops_global": hlo_flops_global,
        "useful_ratio": useful,
        "roofline_fraction": t_compute / max(max(terms.values()), 1e-30),
        "param_mode": mode,
        "note": bound_note,
        "probe": {"unit_layers": unit, "n_units": n_units,
                  "f1": f1, "f2": f2, "c1": c1, "c2": c2, "b1": b1, "b2": b2,
                  "host_s": [t1 - t0, t2 - t1],
                  "memory": [r1["memory"], r2["memory"]],
                  "collectives": [r1["collectives"]["per_kind"],
                                  r2["collectives"]["per_kind"]]},
    }
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / f"{out['cell']}.json").write_text(json.dumps(out, indent=1))
    if verbose:
        print(f"[roofline] {out['cell']}: compute {t_compute*1e3:.2f}ms "
              f"memory {t_memory*1e3:.2f}ms coll {t_coll*1e3:.2f}ms "
              f"→ {out['dominant']}-bound, useful {useful:.2f}, "
              f"roofline frac {out['roofline_fraction']:.2f}", flush=True)
        print(_probe_line(1, r1, t1 - t0), flush=True)
        print(_probe_line(2, r2, t2 - t1), flush=True)
    return out


def print_table():
    rows = []
    for p in sorted(OUT_DIR.glob("*.json")):
        r = json.loads(p.read_text())
        if "dominant" not in r:
            continue        # kernel-schedule cells (--kernel) have their
            # own shape; they print at generation time, not in this table
        rows.append(r)
    print("| cell | compute (ms) | memory (ms) | collective (ms) | "
          "bound | MODEL/HLO flops | roofline frac |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        t = r["terms_s"]
        print(f"| {r['cell']} | {t['compute_s']*1e3:.2f} | "
              f"{t['memory_s']*1e3:.2f} | {t['collective_s']*1e3:.2f} | "
              f"{r['dominant']} | {r['useful_ratio']:.2f} | "
              f"{r['roofline_fraction']:.2f} |")


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
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--table", action="store_true")
    ap.add_argument("--kernel", action="store_true",
                    help="roofline the SATA kernel schedules (dense vs "
                         "compacted grid: time terms + fetch bytes)")
    ap.add_argument("--out-dir", default=str(OUT_DIR),
                    help="where the --kernel JSON files go "
                         "(default %(default)s)")
    args = ap.parse_args(argv)
    if args.table:
        print_table()
        return
    if args.kernel:
        for occ in (0.25, 0.5, 0.75):
            analyse_kernel(occ_frac=occ, out_dir=args.out_dir)
        return
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch/--shape, --all, --table or --kernel")
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    fails = []
    for arch, shape in cells:
        tag = f"{arch}__{shape}__pod1"
        if args.skip_done and (OUT_DIR / f"{tag}.json").exists():
            print(f"[roofline] {tag}: cached", flush=True)
            continue
        try:
            analyse_cell(arch, shape)
        except Exception as e:
            fails.append(tag)
            print(f"[roofline] {tag}: FAIL {e}", flush=True)
            traceback.print_exc()
    if fails:
        print(f"[roofline] failures: {fails}")
        sys.exit(1)


if __name__ == "__main__":
    main()
