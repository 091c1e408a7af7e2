#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port: builds the CUDA decode kernel from
the checkout's sources, holds it against its plain PyTorch version on the
card, serves full-width qwen3-4b (random weights, 36 layers) through the
port's paged and contiguous serving paths, and times the kernel at the
main path's shape.

    python3 chip_smoke.py            # needs one CUDA GPU (an H100 here)
    python3 chip_smoke.py --mutants  # phase 2 on each of MUTANTS: each must fail

Phases (any failure exits non-zero; none is caught so a later one runs):
  1. device and build — card name and power limit, torch/CUDA versions,
     nvcc build seconds;
  2. kernel vs plain version on the card, both layouts, at the main-path
     shape and edge cases (fp32 <= 1e-5 max abs; bf16 <= 2e-2 max abs
     and at most 1% of the outputs off the plain version's bits; paged ==
     contiguous bitwise);
  3. serve qwen3-4b paged (page 64) through ``repro_torch.launch.serve``;
     the paged kernel's launch count must equal layers x decode steps;
  4. the same requests on the contiguous layout: equal token streams;
  5. kernel timing at the main-path shape (CUDA events, median of 30
     runs, L2 flushed before each), its bound from the bytes the output
     needs at 3.35 TB/s, the plain version, and SDPA over the dense cache
     with the same mask as the library yardstick.

The last stdout line is ``{"ok": true, "device": {...}}``; the line before
it is the ``kernels`` JSON, and the card's name and power limit are
printed on a line of their own before that.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12
# max abs error against the plain version.  bf16 outputs are also held to
# the plain version's bits: the kernel differs from it only in fp32
# summation order, which flips the rounding of ~0.1% of the outputs, while
# an fp32 selection predicate or a missing bf16 rounding of p moves 25% or
# more of them (a 2e-2 max-abs limit alone lets the second pass).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BF16_MISMATCH_MAX = 0.01    # share of bf16 outputs off the plain version
SRC_CU = "src/repro_torch/kernels/csrc/sata_decode.cu"
REPLACES = {"paged": "src/repro/kernels/sata_decode.py:168",
            "contiguous": "src/repro/kernels/sata_decode.py:97"}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def make_case(torch, *, b, kv, g, d, page, s, dtype, seed, device,
              pos_lo=1, pos_hi=None, topk=64):
    """Random cache + the planner's own plan (``full_replan``) for it,
    the pool laid out through a shuffled page table."""
    from repro_torch.core.decode_plan import full_replan
    rng = np.random.default_rng(seed)
    nkb = s // page
    q = torch.tensor(rng.standard_normal((b, kv, g, d)), dtype=dtype,
                     device=device)
    k = torch.tensor(rng.standard_normal((b, s, kv, d)), dtype=dtype,
                     device=device)
    v = torch.tensor(rng.standard_normal((b, s, kv, d)), dtype=dtype,
                     device=device)
    pos = torch.tensor(rng.integers(pos_lo, pos_hi or s, b),
                       dtype=torch.int32, device=device)
    idx, cnt, thr = full_replan(q, k, pos, topk_k=topk, k_block=page,
                                plan_blocks=nkb)
    n_pages = b * nkb + 1
    perm = rng.permutation(np.arange(1, n_pages))
    table = torch.tensor(perm.reshape(b, nkb), dtype=torch.int32,
                         device=device)
    kp = torch.zeros((n_pages, page, kv, d), dtype=dtype, device=device)
    vp = torch.zeros_like(kp)
    kp[table.long()] = k.reshape(b, nkb, page, kv, d)
    vp[table.long()] = v.reshape(b, nkb, page, kv, d)
    return dict(q=q, k=k, v=v, kp=kp, vp=vp, table=table, idx=idx,
                cnt=cnt, thr=thr, pos=pos, page=page)


def run_kernel(sd, c, paged):
    if paged:
        return sd.sata_decode_attention_paged_kernel(
            c["q"], c["kp"], c["vp"], c["table"], c["idx"], c["cnt"],
            c["thr"], c["pos"])
    return sd.sata_decode_attention_kernel(
        c["q"], c["k"], c["v"], c["idx"], c["cnt"], c["thr"], c["pos"],
        k_block=c["page"])


def run_plain(sd, c, paged):
    if paged:
        return sd.sata_decode_attention_ref(
            c["q"], c["kp"], c["vp"], c["idx"], c["cnt"], c["thr"],
            c["pos"], k_block=c["page"], page_table=c["table"])
    return sd.sata_decode_attention_ref(
        c["q"], c["k"], c["v"], c["idx"], c["cnt"], c["thr"], c["pos"],
        k_block=c["page"])


def check_case(torch, sd, name, c):
    """Kernel vs plain in both layouts + paged == contiguous bitwise.
    Returns the largest kernel-vs-plain error."""
    tol = TOL[str(c["q"].dtype).split(".")[-1]]
    outs = {}
    err = 0.0
    for paged in (False, True):
        got = run_kernel(sd, c, paged)
        want = run_plain(sd, c, paged)
        torch.cuda.synchronize()
        assert got.shape == want.shape == c["q"].shape, (got.shape, want.shape)
        assert torch.isfinite(got).all(), f"{name}: non-finite output"
        e = float((got.float() - want.float()).abs().max()) \
            if got.numel() else 0.0
        lay = "paged" if paged else "contiguous"
        off = float((got != want).float().mean()) if got.numel() else 0.0
        log(f"[kernel] {name} {lay}: max_abs_err={e:.3e} (tol {tol:g}), "
            f"{off:.4%} of outputs off the plain version's bits")
        assert e <= tol, f"{name} {lay}: {e} > {tol}"
        if got.dtype == torch.bfloat16:
            assert off <= BF16_MISMATCH_MAX, f"{name} {lay}: {off:.4%} off"
        err = max(err, e)
        outs[paged] = got
    assert torch.equal(outs[False], outs[True]), \
        f"{name}: paged != contiguous (must be bitwise equal)"
    return err


def edge_cases(torch, device):
    """Small shapes covering G in {1,2,4,8}, D in {16,64,128}, pages of
    8..128 rows, fp32 and bf16, P == 0, count-0 rows, pos inside a page
    and padding slots past the count."""
    f32, bf16 = torch.float32, torch.bfloat16
    specs = [  # (b, kv, g, d, page, s, dtype)
        (3, 2, 1, 16, 8, 64, f32),
        (2, 4, 2, 64, 16, 256, f32),
        (2, 2, 4, 128, 32, 512, f32),
        (2, 2, 8, 128, 128, 1024, bf16),
        (3, 2, 4, 64, 64, 512, bf16),
    ]
    for n, (b, kv, g, d, page, s, dt) in enumerate(specs):
        c = make_case(torch, b=b, kv=kv, g=g, d=d, page=page, s=s, dtype=dt,
                      seed=100 + n, device=device, topk=8)
        # count-0 rows, and padding slots past a shortened count
        c["cnt"] = c["cnt"].clone()
        c["cnt"][0, 0] = 0
        c["cnt"][-1, -1] = torch.clamp(c["cnt"][-1, -1] - 1, min=0)
        yield f"G{g}_D{d}_page{page}_{str(dt).split('.')[-1]}", c
    c = make_case(torch, b=2, kv=2, g=2, d=16, page=8, s=64, dtype=f32,
                  seed=7, device=device, topk=4)
    c["idx"] = c["idx"][..., :0].contiguous()                  # P == 0
    yield "P0", c


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps=30, warm=3):
    """Median ms of ``reps`` runs, each timed with CUDA events and
    preceded by a 256 MB write that evicts the 50 MB L2 (the serving
    loop reaches each layer's K/V cold)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        ts.append(a.elapsed_time(z))
    return float(np.median(ts))


def selection(torch, c):
    """The keys the output depends on, over the dense cache: ``scored``
    (B, KV, S), tokens <= pos in the row's planned blocks, and
    ``selected`` (B, KV, G, S), those with bf16(s) >= bf16(thr)."""
    from repro_torch.core.blockmap import bisect_select
    q, k = c["q"], c["k"]
    b, kv, g, d = q.shape
    s = k.shape[1]
    page = c["page"]
    sc = torch.einsum("bkgd,bskd->bkgs", q.float(), k.float()) / np.sqrt(d)
    tok = torch.arange(s, device=q.device)
    live = (torch.arange(c["idx"].shape[-1], device=q.device)
            < c["cnt"][..., None]).to(torch.int32)
    # padding slots repeat a live index: reduce, never overwrite
    planned = torch.zeros((b, kv, s // page), dtype=torch.int32,
                          device=q.device).scatter_reduce_(
        2, c["idx"].long(), live, reduce="amax").bool()
    scored = (planned.repeat_interleave(page, dim=2)
              & (tok <= c["pos"][:, None])[:, None])
    return scored, bisect_select(sc, c["thr"]) & scored[:, :, None]


def kernel_bound(torch, c, paged):
    """Least time for the function's work on an H100: the larger of the
    bytes it must move over 3.35 TB/s and its flops over the peak for the
    input type.  Bytes: the K rows it must score (tokens <= pos in the
    planned blocks), the V rows that at least one of the G heads selects,
    q, out and the plan, each once.  Flops: QK^T for every scored key and
    head, PV for every selected (head, key)."""
    q = c["q"]
    es = q.element_size()
    b, kv, g, d = q.shape
    scored, selected = selection(torch, c)
    k_rows = int(scored.sum())
    v_rows = int(selected.any(dim=2).sum())
    nbytes = ((k_rows + v_rows) * d * es + 2 * q.numel() * es
              + c["thr"].numel() * 4 + c["idx"].numel() * 4
              + c["cnt"].numel() * 4 + c["pos"].numel() * 4
              + (c["table"].numel() * 4 if paged else 0))
    flops = 2 * d * (g * k_rows + int(selected.sum()))
    peak = BF16_FLOPS_PER_S if es == 2 else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", k_rows, v_rows)


def sdpa_inputs(torch, c):
    """Dense-cache SDPA inputs with the kernel's selection as a boolean
    mask: planned blocks AND bf16(s) >= bf16(thr) AND token <= pos."""
    q, k, v = c["q"], c["k"], c["v"]
    b, kv, g, d = q.shape
    _, mask = selection(torch, c)
    qh = q.reshape(b, kv * g, 1, d)
    kh = k.permute(0, 2, 1, 3).contiguous()               # (B, KV, S, D)
    vh = v.permute(0, 2, 1, 3).contiguous()
    return qh, kh, vh, mask.reshape(b, kv * g, 1, k.shape[1])


def kernel_cases(torch, dev):
    """Phase 2's inputs: the main-path shape, then the edge cases."""
    yield "main_B8_KV8_G4_D128_page64_bf16", make_case(
        torch, b=8, kv=8, g=4, d=128, page=64, s=4096, dtype=torch.bfloat16,
        seed=0, device=dev, pos_lo=1024, pos_hi=1088)
    yield from edge_cases(torch, dev)


def check_kernels(torch, sd, dev):
    """Phase 2: the kernel against its plain version on every case.
    Returns the main case and the errors."""
    errs, main_case = {}, None
    for cname, c in kernel_cases(torch, dev):
        if main_case is None:
            main_case = c
            log(f"[kernel] main-path plan: kv_counts mean "
                f"{float(c['cnt'].float().mean()):.2f} of "
                f"{c['idx'].shape[-1]} pages, pos {c['pos'].tolist()}")
        errs[cname] = check_case(torch, sd, cname, c)
    return main_case, errs


# one-line faults of the kernel that phase 2's limits must catch
MUTANTS = {
    "fp32_predicate": ("const bool sel = bf16_rn(s) >= thr_sh[g];",
                       "const bool sel = s >= thr_sh[g];"),
    "unrounded_p": ("s_sh[g][t] = to_f32(from_f32<T>(p));",
                    "s_sh[g][t] = p;"),
}

_MUTANT_CHILD = """
import sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
import chip_smoke as cs
from repro_torch.kernels import sata_decode as sd
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
failed = []
for name, c in cs.kernel_cases(torch, torch.device("cuda")):
    try:
        cs.check_case(torch, sd, name, c)
    except AssertionError as e:
        failed.append(name)
        print("[mutant] fails:", e, flush=True)
print("FAILED", ",".join(failed))
"""


def run_mutants(root: str) -> int:
    """``--mutants``: build each of ``MUTANTS`` in a temporary copy of the
    tree and run phase 2's cases on it.  Fails unless every mutant fails
    at least one case."""
    import shutil
    import tempfile
    missed = []
    for name, (old, new) in MUTANTS.items():
        with tempfile.TemporaryDirectory() as d:
            shutil.copytree(os.path.join(root, "src"), os.path.join(d, "src"))
            shutil.copy(os.path.abspath(__file__), d)
            cu = os.path.join(d, SRC_CU)
            with open(cu) as f:
                text = f.read()
            assert text.count(old) == 1, f"{name}: {old!r} not found once"
            with open(cu, "w") as f:
                f.write(text.replace(old, new))
            res = subprocess.run([sys.executable, "-c", _MUTANT_CHILD, d],
                                 capture_output=True, text=True, cwd=d)
        lines = res.stdout.splitlines()
        for line in lines[:-1]:
            log(f"[{name}] {line}")
        if res.returncode or not lines or not lines[-1].startswith("FAILED"):
            log(res.stderr[-4000:])
            return 1
        failed = [c for c in lines[-1].split(" ", 1)[-1].split(",") if c]
        log(f"[{name}] caught by {len(failed)} case(s): {failed}")
        if not failed:
            missed.append(name)
    log(f"mutants missed: {missed}")
    return 1 if missed else 0


# ---------------------------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke test needs a CUDA GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--mutants"]:
        return run_mutants(root)
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.configs.archs import ARCHS
    from repro_torch.kernels import build
    from repro_torch.kernels import sata_decode as sd
    from repro_torch.launch.serve import ServeOptions, serve
    from repro_torch.models.config import KVCacheConfig, SataDecodeConfig
    from repro_torch.models.model import DenseModel

    # no fp32 product on the path may run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    tag = f"[{card}]"

    # --- 1. device and build
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s); "
        f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    t = time.time()
    lib = build.build("sata_decode")
    log(f"[build] nvcc sata_decode.cu -> {os.path.relpath(lib, root)} in "
        f"{time.time() - t:.2f} s")
    ptxas = lib.parent / f"{lib.stem}.ptxas.txt"
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] ptxas: {line.strip()}")

    # --- 2. kernel vs plain on the card
    main_case, errs = check_kernels(torch, sd, dev)

    # --- 3. serve qwen3-4b at full width, paged
    base = ARCHS["qwen3-4b"]
    cfg = dataclasses.replace(
        base, topk_impl="bisect",
        sata=dataclasses.replace(base.sata, decode=SataDecodeConfig(
            mode="on", block=64, replan=1)),
        kv=KVCacheConfig(layout="paged", page_size=64))
    opts = ServeOptions(n_requests=16, batch_slots=8, prompt_len=1024,
                        gen_len=64, max_len=4096)
    t = time.time()
    model = DenseModel(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"[serve] qwen3-4b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, qk_norm {cfg.qk_norm}, {cfg.dtype}; random "
        f"weights (seed 0) built in {time.time() - t:.1f} s")
    runs = {}
    for layout in ("paged", "contiguous"):
        lcfg = cfg if layout == "paged" else dataclasses.replace(
            cfg, kv=KVCacheConfig(layout="contiguous"))
        sd.sata_decode_attention_kernel.launches = 0
        sd.sata_decode_attention_paged_kernel.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = serve("qwen3-4b", smoke=False, cfg=lcfg, model=model,
                    options=opts, device=dev)
        torch.cuda.synchronize()
        n_paged = sd.sata_decode_attention_paged_kernel.launches
        n_contig = sd.sata_decode_attention_kernel.launches
        outs = out["outputs"]
        assert sorted(outs) == list(range(opts.n_requests)), sorted(outs)
        for r, toks in outs.items():
            assert len(toks) == opts.gen_len, (r, len(toks))
            assert all(0 <= x < cfg.vocab_size for x in toks), r
        want = cfg.n_layers * out["steps"]
        got, other = (n_paged, n_contig) if layout == "paged" \
            else (n_contig, n_paged)
        assert got == want, f"{layout}: {got} launches != {want}"
        assert other == 0, f"{layout}: the other layout's kernel ran"
        f = out["decode_fetch"]
        assert f["kv_fetch_tiles_plan"] < f["kv_fetch_tiles_dense"], f
        occ = out.get("page_occupancy", {})
        log(f"[serve] {layout}: {out['tokens_generated']} tokens, "
            f"{out['steps']} decode steps, {out['tok_per_s']:.2f} tok/s, "
            f"mean decode step {out['step_ms_mean']:.2f} ms, kernel "
            f"launches {got} (= {cfg.n_layers} layers x {out['steps']} "
            f"steps), fetch reduction {f['fetch_reduction']:.3f}x "
            f"({f['kv_fetch_tiles_plan']} vs {f['kv_fetch_tiles_dense']} "
            f"tiles), peak pages {occ.get('pages_in_use_peak', 'n/a')}/"
            f"{occ.get('n_pages', 'n/a')}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB {tag}")
        runs[layout] = (out, got)

    # --- 4. paged and contiguous serve the same token streams
    assert runs["paged"][0]["outputs"] == runs["contiguous"][0]["outputs"], \
        "paged and contiguous token streams differ"
    log("[serve] paged == contiguous token streams: True")
    del model
    torch.cuda.empty_cache()

    # --- 5. kernel timing at the main-path shape
    c = main_case
    kernels = []
    for layout in ("paged", "contiguous"):
        paged = layout == "paged"
        ms = time_ms(torch, lambda: run_kernel(sd, c, paged))
        plain_ms = time_ms(torch, lambda: run_plain(sd, c, paged), reps=20)
        qh, kh, vh, mask = sdpa_inputs(torch, c)
        lib_ms = time_ms(torch, lambda: torch.nn.functional
                         .scaled_dot_product_attention(
                             qh, kh, vh, attn_mask=mask, enable_gqa=True))
        bound_ms, bound_by, k_rows, v_rows = kernel_bound(torch, c, paged)
        fn = sd.sata_decode_attention_paged_kernel if paged \
            else sd.sata_decode_attention_kernel
        kernels.append({
            "name": fn.__name__, "route": "cuda", "source": SRC_CU,
            "replaces": REPLACES[layout], "launches": runs[layout][1],
            "max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms})
        log(f"[timing] {fn.__name__} ({layout}) B8 KV8 G4 D128 page64 bf16, "
            f"{int(c['cnt'].sum())} planned pages, {k_rows} K rows scored, "
            f"{v_rows} V rows selected: kernel {ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
            f"SDPA+mask {lib_ms:.4f} ms {tag}")
    # where a decode step's time goes: one layer's exact re-plan (the
    # served replan=1 path) at the same shape, beside the kernel
    from repro_torch.core.decode_plan import (decode_plan_update,
                                              init_decode_plan,
                                              summaries_from_cache,
                                              update_block_summaries)
    b = c["q"].shape[0]
    plan = init_decode_plan(b, 8, 4096, 128, 64, device=dev)
    lo, hi = summaries_from_cache(c["k"], c["pos"], k_block=64)
    plan["k_min"].copy_(lo)
    plan["k_max"].copy_(hi)
    k_new = c["k"][torch.arange(b, device=dev), c["pos"].long()][:, None]

    def planner():
        update_block_summaries(plan, k_new, c["pos"], k_block=64)
        decode_plan_update(plan, c["q"], c["kp"], c["pos"], topk_k=64,
                           k_block=64, page_table=c["table"])

    plan_ms = time_ms(torch, planner, reps=20)
    step_ms = runs["paged"][0]["step_ms_mean"]
    per_layer = plan_ms + kernels[0]["ms"]
    log(f"[timing] per layer (paged, B8, exact re-plan over S=4096): "
        f"planner {plan_ms:.4f} ms + decode kernel {kernels[0]['ms']:.4f} ms;"
        f" x {cfg.n_layers} layers = {cfg.n_layers * per_layer:.2f} ms of "
        f"the {step_ms:.2f} ms mean decode step "
        f"({100 * cfg.n_layers * per_layer / step_ms:.1f}%) {tag}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
