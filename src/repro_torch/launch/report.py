"""Markdown tables of the dry run and the per-cell roofline — port of
``repro.launch.report``, over ``build/dryrun/*.json`` and
``build/roofline/*.json`` (the port writes under ``build/``; the
reference's ``results/`` are its own).

Usage:  PYTHONPATH=src python -m repro_torch.launch.report [dryrun|roofline]
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[3] / "build"


def dryrun_table() -> str:
    rows = []
    for p in sorted((ROOT / "dryrun").glob("*.json")):
        if "__probe" in p.name:
            continue
        r = json.loads(p.read_text())
        if not r.get("ok"):
            rows.append((r["cell"], "FAIL", "", "", "", ""))
            continue
        mem = r.get("memory", {})
        temp = mem.get("temp_size_in_bytes", 0) / 2 ** 30
        args = mem.get("argument_size_in_bytes", 0) / 2 ** 30
        flops = r.get("cost", {}).get("flops", 0)
        coll = r.get("collectives", {}).get("total_bytes", 0)
        per_kind = r.get("collectives", {}).get("per_kind", {})
        kinds = " ".join(f"{k.split('-')[-1][:4]}:{v:.2g}"
                         for k, v in sorted(per_kind.items()))
        rows.append((r["cell"], f"{r['compile_s']:.0f}s",
                     f"{args:.2f}", f"{temp:.2f}",
                     f"{flops:.3g}", kinds or f"{coll:.3g}"))
    out = ["| cell | compile | args GiB/dev | temp GiB/dev | "
           "HLO flops/dev* | collectives (B/dev*) |",
           "|---|---|---|---|---|---|"]
    for r in rows:
        out.append("| " + " | ".join(str(x) for x in r) + " |")
    out.append("")
    out.append("\\* counted op by op on meta tensors (rank 0 of the "
               "16×16 mesh): \"compile\" is the traced step's host "
               "seconds, \"HLO flops\" the matrix products' and kernels' "
               "FLOPs.")
    return "\n".join(out)


def roofline_table() -> str:
    rows = []
    for p in sorted((ROOT / "roofline").glob("*.json")):
        r = json.loads(p.read_text())
        if "dominant" not in r:
            continue            # the --kernel schedule cells
        t = r["terms_s"]
        rows.append((r["cell"].replace("__pod1", ""),
                     f"{t['compute_s']*1e3:.1f}",
                     f"{t['memory_s']*1e3:.1f}",
                     f"{t['collective_s']*1e3:.1f}",
                     r["dominant"],
                     f"{r['useful_ratio']:.2f}",
                     f"{r['roofline_fraction']:.3f}",
                     r["note"][:60] + "…"))
    out = ["| arch × shape | compute ms | memory ms | collective ms | "
           "bound | 6ND/HLO | roofline frac | to improve |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append("| " + " | ".join(r) + " |")
    return "\n".join(out)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "both"
    if which in ("dryrun", "both"):
        print("### Dry-run\n")
        print(dryrun_table())
    if which in ("roofline", "both"):
        print("\n### Roofline\n")
        print(roofline_table())


if __name__ == "__main__":
    main()
