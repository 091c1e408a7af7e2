#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port: builds the CUDA kernels from the
checkout's sources, holds each against its plain PyTorch version on the
card, serves full-width qwen3-4b (random weights, 36 layers) through the
port's paged and contiguous serving paths, trains it through the SATA
prefill kernels, and times every kernel at its main path's shape.

    python3 chip_smoke.py            # needs one CUDA GPU (an H100 here)
    python3 chip_smoke.py --mutants  # phases 2 and 6 (and 8 for the
                                     # prefill kernel) on each of
                                     # MUTANTS: each must fail
    python3 chip_smoke.py --ab DIR   # phase 2, then this tree's decode
                                     # and prefill kernels and DIR's (an
                                     # earlier checkout) timed in turns

Phases (any failure exits non-zero; none is caught so a later one runs):
  1. device and build — card name and power limit, torch/CUDA versions,
     one nvcc per kernel source, all started together;
  2. kernel vs plain version on the card, both layouts, at the main-path
     shape and edge cases (fp32 <= 1e-5 max abs; bf16 <= 2e-2 max abs
     and at most 1% of the outputs off the plain version's bits; paged ==
     contiguous bitwise);
  3. serve qwen3-4b paged (page 64) through ``repro_torch.launch.serve``;
     the paged kernel's launch count must equal layers x decode steps;
  4. the same requests on the contiguous layout: equal token streams;
  5. decode kernel timing at the main-path shape, at one slot (B1) and
     at a long row (pos ~4000): CUDA events (median of 30 runs, L2
     flushed before each, queued behind a device sleep so the events
     time the device, not the host) and the profiler's device time over
     the same calls (which also fails if the wrapper launches anything
     but the kernel), its bound from the bytes the output needs at 3.35
     TB/s, the plain version, and SDPA over the dense cache with the
     same mask as the library yardstick; one layer's exact re-plan on
     the host clock beside it;
  6. the SATA prefill kernels (compacted grid B3 in threshold, mask and
     block mode; dense grid B4) against their plain versions: fp32 <=
     1e-5, bf16 within phase 2's limits; admitted-key counts per row
     equal to the plain version's, except bf16 threshold mode (scores
     summed on the tensor cores), where every row's count must lie in
     ``admitted_window``'s range (the rows off the plain count are
     reported); B3 == B4 bitwise on the same plan, two launches bitwise
     equal;
     at the main shape, the rows where the kernel admits other keys than
     the chunked route's backward recompute selects (reported);
  7. the main path: ``launch.train.train`` on full-width qwen3-4b, 36
     layers, chunked selection (``topk_impl="bisect"``), batch 1,
     S = 4096, 4 steps; the compacted-grid kernel's launches must equal
     layers x steps x 2 (the forward and the remat recompute), the dense
     grid's 0; layer 0's kernel arguments are recorded on the way; then
     one more step under ``torch.profiler`` for the device time by
     kernel and the device's idle share;
  8. one forward + backward at full width (4 layers) with the kernel
     route on and off (``_attend``): the same loss and grad norm within
     ROUTE_RTOL, layer 0's attention output within ROUTE_ATTN_RTOL;
  9. the dense-selection route: ``make_prefill_step`` with
     ``topk_impl="sort"`` at full width, 4 layers, S = 2048, on the
     compacted and the dense grid: equal logits bitwise; layer 0's
     dense-grid arguments are recorded on the way;
 10. prefill kernels on the arguments recorded in phases 7 and 9: kernel
     vs plain version (phase 6's limits), the body the kernel's entry
     point takes (bf16 must take the tensor cores), timing (CUDA events, median,
     L2 flushed), the bound from the flops and bytes this input needs,
     and SDPA with the equivalent boolean mask as the library yardstick.

The last stdout line is ``{"ok": true, "device": {...}}``; the line before
it is the ``kernels`` JSON, and the card's name and power limit are
printed on a line of their own before that.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
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
SRC_ATTN_CU = "src/repro_torch/kernels/csrc/sata_attention.cu"
REPLACES = {"paged": "src/repro/kernels/sata_decode.py:168",
            "contiguous": "src/repro/kernels/sata_decode.py:97",
            "compact": "src/repro/kernels/sata_attention.py:260",
            "dense": "src/repro/kernels/sata_attention.py:117"}
# phase 8, kernel route vs _attend.  The routes round p to bf16 at
# different points (per tile after the running max vs once after the full
# softmax) and sum in different orders, which moves each bf16 attention
# output by about one rounding step (2^-9 relative, uniform), so layer 0's
# attention output differs by ~2^-8 in relative Frobenius norm
# (ROUTE_ATTN_RTOL allows 2.5x that), and the loss and the grad norm,
# means over millions of such outputs, by far less (ROUTE_RTOL).
ROUTE_RTOL = 2e-3
ROUTE_ATTN_RTOL = 1e-2


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
              pos_lo=1, pos_hi=None, topk=64, key_at_pos=False):
    """Random cache + the planner's own plan (``full_replan``) for it,
    the pool laid out through a shuffled page table.  ``key_at_pos``
    makes each row's key at pos 3·q of its first head, so that head
    selects it."""
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
    if key_at_pos:
        k[torch.arange(b, device=device), pos.long()] = 3 * q[:, :, 0]
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
    """Small shapes covering G in 1..8, D in {9, 16, 20, 24, 64, 128}
    (every copy width), pages of 8..128 rows, fp32 and bf16, P == 0,
    count-0 rows, padding slots past the count, and pos inside a page
    with the key at pos selected."""
    f32, bf16 = torch.float32, torch.bfloat16
    specs = [  # (b, kv, g, d, page, s, dtype)
        (3, 2, 1, 16, 8, 64, f32),
        (2, 4, 2, 64, 16, 256, f32),
        (2, 2, 4, 128, 32, 512, f32),
        (2, 2, 8, 128, 128, 1024, bf16),
        (3, 2, 4, 64, 64, 512, bf16),
        # odd widths: 16-byte copies into padded rows, then 8-, 4- and
        # 2-byte copies; G padded to a power of two; a page of 1.5 chunks
        (2, 2, 3, 24, 16, 128, bf16),
        (2, 2, 3, 20, 16, 128, bf16),
        (2, 2, 5, 9, 8, 64, f32),
        (2, 1, 3, 9, 8, 64, bf16),
        (2, 2, 4, 128, 48, 480, bf16),
    ]
    for n, (b, kv, g, d, page, s, dt) in enumerate(specs):
        c = make_case(torch, b=b, kv=kv, g=g, d=d, page=page, s=s, dtype=dt,
                      seed=100 + n, device=device, topk=8)
        # count-0 rows, and padding slots past a shortened count
        c["cnt"] = c["cnt"].clone()
        c["cnt"][0, 0] = 0
        c["cnt"][-1, -1] = torch.clamp(c["cnt"][-1, -1] - 1, min=0)
        yield f"G{g}_D{d}_page{page}_{str(dt).split('.')[-1]}", c
    # pos inside a page, its key selected: the token <= pos test decides
    for dt in (f32, bf16):
        yield f"pos_inside_page_{str(dt).split('.')[-1]}", make_case(
            torch, b=4, kv=2, g=2, d=64, page=16, s=256, dtype=dt, seed=8,
            device=device, topk=8, key_at_pos=True)
    c = make_case(torch, b=2, kv=2, g=2, d=16, page=8, s=64, dtype=f32,
                  seed=7, device=device, topk=4)
    c["idx"] = c["idx"][..., :0].contiguous()                  # P == 0
    yield "P0", c


def build_all(build, root, names=("sata_decode", "sata_attention")):
    """One nvcc per kernel source, all started together; prints each
    build's seconds and ptxas's registers and spills."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(name):
        t = time.time()
        return build.build(name), time.time() - t

    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(timed, names)))
    for name, (lib, secs) in libs.items():
        log(f"[build] nvcc {name}.cu -> {os.path.relpath(lib, root)} in "
            f"{secs:.2f} s")
        ptxas = lib.parent / f"{lib.stem}.ptxas.txt"
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] ptxas {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

SLEEP_CYCLES = 50_000_000     # ~25-30 ms of an H100's SM clock


def time_ms(torch, fn, reps=30, warm=3):
    """Median ms of ``reps`` runs, each timed with CUDA events and
    preceded by a 256 MB write that evicts the 50 MB L2 (the serving
    loop reaches each layer's K/V cold).  The device first sleeps while
    the host queues every run, so the events time the device's work,
    not the host's launch path between them (a function that syncs
    inside still shows its host time)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for a, z in evs:
        flush.zero_()
        a.record()
        fn()
        z.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(z) for a, z in evs]))


def wall_ms(torch, fn, reps=20, warm=3):
    """Median host-clock ms of ``reps`` synchronized runs: the time an
    eager chain of small operations takes in the serving loop, where
    the host's launch path, not the device, sets the pace."""
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t))
    return float(np.median(ts))


def device_ms(e):
    """A profiler row's own device time in ms."""
    us = getattr(e, "self_device_time_total", None)
    if us is None:
        us = getattr(e, "self_cuda_time_total", 0)
    return us / 1e3


def profiled_ms(torch, fn, kernel, reps=30, warm=3):
    """``time_ms`` under ``torch.profiler``: the event median and the
    mean device time of the kernels whose name holds ``kernel``.  Fails
    if anything but those kernels and the timing's own (the L2 flushes
    and one sleep) ran on the device, i.e. if the wrapper launched
    anything beside its kernel.  Returns (event ms, device ms or None
    when the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms = time_ms(torch, fn, reps=reps, warm=warm)
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == cuda and device_ms(e) > 0]
    ours = [e for e in evs if kernel in e.key]
    if not ours:
        log(f"[profile] no device time for {kernel} (rows: "
            f"{[e.key[:60] for e in evs]})")
        return ms, None
    n = sum(e.count for e in ours)
    others = {e.key[:70]: e.count for e in evs if kernel not in e.key}
    assert n == reps + warm, f"{kernel}: {n} launches, {reps + warm} calls"
    assert sum(others.values()) <= reps + 1, \
        f"other kernels in the window: {others}"
    return ms, sum(device_ms(e) for e in ours) / n


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


def extra_decode_cases(torch, dev):
    """Phase 5's other shapes: one slot (B1: 8 rows, one block each on
    132 SMs) and a long row (pos ~4000 of 4096, ~63 planned pages)."""
    yield "B1_KV8_G4_D128_page64_bf16", make_case(
        torch, b=1, kv=8, g=4, d=128, page=64, s=4096, dtype=torch.bfloat16,
        seed=1, device=dev, pos_lo=1024, pos_hi=1088)
    yield "long_B8_KV8_G4_D128_page64_bf16_pos4000", make_case(
        torch, b=8, kv=8, g=4, d=128, page=64, s=4096, dtype=torch.bfloat16,
        seed=2, device=dev, pos_lo=3968, pos_hi=4032)


def time_decode(torch, sd, c, label, paged, tag):
    """The decode kernel on case ``c``: CUDA-event median and the
    profiler's device time over the same calls, the plain version, SDPA
    over the dense cache with the same mask, and the bound.  Returns
    the ``kernels`` row's timing fields."""
    layout = "paged" if paged else "contiguous"
    ms, dev_ms = profiled_ms(torch, lambda: run_kernel(sd, c, paged),
                             "sata_decode_kernel")
    plain_ms = time_ms(torch, lambda: run_plain(sd, c, paged), reps=20)
    qh, kh, vh, mask = sdpa_inputs(torch, c)
    lib_ms = time_ms(torch, lambda: torch.nn.functional
                     .scaled_dot_product_attention(
                         qh, kh, vh, attn_mask=mask, enable_gqa=True))
    del qh, kh, vh, mask
    bound_ms, bound_by, k_rows, v_rows = kernel_bound(torch, c, paged)
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    log(f"[timing] decode kernel ({layout}) {label}, "
        f"{int(c['cnt'].sum())} planned pages, {k_rows} K rows scored, "
        f"{v_rows} V rows selected: kernel {ms:.4f} ms (profiler device "
        f"time {dev_txt}), bound {bound_ms:.4f} ms ({bound_by}), "
        f"{100 * bound_ms / ms:.1f}% of it; plain {plain_ms:.4f} ms, "
        f"SDPA+mask {lib_ms:.4f} ms {tag}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


# ---------------------------------------------------------------------------
# SATA prefill kernels (compacted grid B3, dense grid B4)
# ---------------------------------------------------------------------------

def attn_case(torch, *, bh, s, d, qb, kb, dtype, mode, causal, seed, device,
              topk=8):
    """Random q/k/v and a plan for one kernel mode: ``threshold`` (the
    chunked planner's own thresholds and block map), ``mask`` (a random
    element mask with empty rows, and its tile occupancy) or ``block``
    (a random block map).  ``idx``/``cnt`` are the full compact plan of
    ``bm``; ``cut`` adds count-0 rows and padding slots past a
    shortened count."""
    from repro_torch.core.blockmap import block_occupancy, compact_kv_plan
    from repro_torch.core.selection import select_thresholds_chunked
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn((bh, s, d), generator=g).to(device=device,
                                                       dtype=dtype)
               for _ in range(3))
    pos = torch.arange(s, dtype=torch.int32, device=device)[None, :, None] \
        .expand(bh, s, 1)
    c = dict(q=q, k=k, v=v, qb=qb, kb=kb, mode=mode, causal=causal,
             sel={})
    if mode == "threshold":
        thr, bm = select_thresholds_chunked(
            q, k, topk, causal=causal, chunk=min(1024, s), q_block=qb,
            k_block=kb)
        c["sel"]["thresholds"] = thr
    elif mode == "mask":
        mask = torch.rand((bh, s, s), generator=g) < 0.1
        mask[0, : min(qb, s) // 2] = False               # rows with no key
        mask = mask.to(device)
        bm = block_occupancy(mask, qb, kb)
        c["sel"]["mask"] = mask
    else:
        bm = (torch.rand((bh, s // qb, s // kb), generator=g) < 0.5).to(
            device)
    if causal and mode != "mask":
        c["sel"].update(causal=True, q_pos=pos, k_pos=pos)
    c["bm"] = bm
    c["idx"], c["cnt"] = compact_kv_plan(bm)
    return c


def run_attn(sa, c, *, plain, dense_grid=False, idx=None, cnt=None,
             admitted=None):
    """B3 (or, ``dense_grid``, B4) on case ``c``: the kernel or its plain
    version."""
    kw = dict(q_block=c["qb"], k_block=c["kb"], admitted=admitted)
    if dense_grid:
        fn = sa.sata_block_attention_ref if plain else sa.sata_block_attention
        return fn(c["q"], c["k"], c["v"], c["bm"], mask=c["sel"].get("mask"),
                  **kw)
    fn = sa.sata_block_attention_compact_ref if plain \
        else sa.sata_block_attention_compact
    return fn(c["q"], c["k"], c["v"], c["idx"] if idx is None else idx,
              c["cnt"] if cnt is None else cnt, **c["sel"], **kw)


def compare(torch, name, got, want, adm_got=None, adm_want=None,
            window=None):
    """Kernel vs plain: max abs error within TOL, bf16 outputs within
    BF16_MISMATCH_MAX of the plain version's bits, and admitted-key counts
    per row equal to the plain version's or, given ``window`` (lo, hi)
    from ``admitted_window``, inside it, with the rows whose count
    differs from the plain one reported.  Returns the max abs error."""
    tol = TOL[str(want.dtype).split(".")[-1]]
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert torch.isfinite(got).all(), f"{name}: non-finite output"
    e = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    off = float((got != want).float().mean()) if got.numel() else 0.0
    adm = "" if adm_got is None else \
        f", admitted keys {int(adm_got.sum())} vs {int(adm_want.sum())}"
    log(f"[attn-kernel] {name}: max_abs_err={e:.3e} (tol {tol:g}), "
        f"{off:.4%} of outputs off the plain version's bits{adm}")
    differ = outside = 0
    if adm_got is not None:
        differ = int((adm_got != adm_want).sum())
        if window is not None:
            lo, hi = window
            outside = int(((adm_got < lo) | (adm_got > hi)).sum())
            log(f"[attn-kernel] {name}: admitted keys inside the window in "
                f"every row: {outside == 0} ({outside} rows outside; {differ} "
                f"of {adm_got.numel()} rows differ from the plain count; "
                f"window lo < hi in {int((lo != hi).sum())} rows)")
    assert e <= tol, f"{name}: {e} > {tol}"
    if got.dtype == torch.bfloat16:
        assert off <= BF16_MISMATCH_MAX, f"{name}: {off:.4%} off"
    if window is None:
        assert differ == 0, \
            f"{name}: admitted-key counts differ in {differ} rows"
    assert outside == 0, f"{name}: {outside} rows outside the window"
    return e


def attn_window(torch, sa, c, cnt=None):
    """``admitted_window`` of case ``c`` where the kernel sums each score
    in the tensor cores' order (bf16 threshold mode), else None: the
    counts must then equal the plain version's."""
    if c["mode"] != "threshold" or c["q"].dtype != torch.bfloat16:
        return None
    return sa.admitted_window(
        c["q"], c["k"], c["idx"], c["cnt"] if cnt is None else cnt,
        q_block=c["qb"], k_block=c["kb"], **c["sel"])


def attn_body(torch, c, dense_grid):
    """The body ``csrc/sata_attention.cu`` takes for case ``c`` ("tensor
    cores" or "CUDA cores", by its entry point's own rule) and that
    body's dynamic shared memory in bytes."""
    import ctypes
    from repro_torch.kernels import build
    fn = build.load("sata_attention").sata_block_attention_body
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smem = ctypes.c_int(0)
    tc = fn(c["q"].shape[-1], c["qb"], c["kb"], int("mask" in c["sel"]),
            int("q_pos" in c["sel"]), int("thresholds" in c["sel"]),
            c["bm"].shape[-1] if dense_grid else c["idx"].shape[-1],
            int(c["q"].dtype == torch.bfloat16), ctypes.byref(smem))
    return ("tensor cores" if tc else "CUDA cores"), smem.value


def admitted_buffer(torch, c):
    bh, s = c["q"].shape[:2]
    return torch.zeros((bh, s), dtype=torch.int32, device=c["q"].device)


def check_attn_case(torch, sa, name, c):
    """B3 vs plain on the full plan and on a cut one (count-0 rows,
    padding slots), admitted counts held by ``compare``'s rule; where the
    mode exists on the dense grid, B4 vs plain and B3 == B4 bitwise.
    Returns B3's admitted-key counts per row on the full plan."""
    cnt_cut = c["cnt"].clone()
    cnt_cut[0, 0] = 0
    cnt_cut[-1, -1] = torch.clamp(cnt_cut[-1, -1] - 1, min=0)
    for label, cnt in (("", None), (" cut plan", cnt_cut)):
        a_k, a_p = admitted_buffer(torch, c), admitted_buffer(torch, c)
        got = run_attn(sa, c, plain=False, cnt=cnt, admitted=a_k)
        want = run_attn(sa, c, plain=True, cnt=cnt, admitted=a_p)
        torch.cuda.synchronize()
        compare(torch, f"B3 {name}{label}", got, want, a_k, a_p,
                attn_window(torch, sa, c, cnt))
        if not label:
            full, adm_full = got, a_k
    if c["mode"] != "threshold" and not c["causal"]:
        a_k, a_p = admitted_buffer(torch, c), admitted_buffer(torch, c)
        got = run_attn(sa, c, plain=False, dense_grid=True, admitted=a_k)
        want = run_attn(sa, c, plain=True, dense_grid=True, admitted=a_p)
        torch.cuda.synchronize()
        compare(torch, f"B4 {name}", got, want, a_k, a_p)
        assert torch.equal(got, full), f"{name}: B3 != B4 (must be bitwise)"
        log(f"[attn-kernel] {name}: B3 == B4 bitwise: True")
    return adm_full


def recompute_flips(torch, c, admitted, name, tag=""):
    """Threshold mode: the rows where the kernel's admitted-key count
    differs from the selection of the chunked route's backward
    (``_selective_ref_chunked``: ``bf16(s) >= bf16(thr)`` on einsum
    scores over every key, causal, not only the planned tiles).  The
    kernel sums each score in its own fixed order, the recompute in the
    GEMM's, so a score on a bf16 rounding boundary can land on either
    side.  Reported, not asserted."""
    from repro_torch.core.blockmap import bisect_select, stream_score_chunks
    sel = c["sel"]
    bh, s, _ = c["q"].shape
    causal = bool(sel.get("causal"))
    pos = sel["q_pos"][0, :, 0] if causal else None
    kpos = sel["k_pos"][0, :, 0] if causal else None
    with torch.no_grad():
        n = stream_score_chunks(
            c["q"], c["k"], lambda sc, adm, t: (bisect_select(sc, t) & adm)
            .sum(-1, dtype=torch.int32), chunk=min(1024, s), causal=causal,
            q_pos=pos, k_pos=kpos, extras=(sel["thresholds"],))
    n = n.transpose(0, 1).reshape(bh, s)
    rows = int((n != admitted).sum())
    log(f"[attn-kernel] {name}: kernel vs backward recompute selection: "
        f"{rows} of {bh * s} rows differ, {int((n - admitted).abs().sum())} "
        f"keys ({int(admitted.sum())} admitted by the kernel, "
        f"{int(n.sum())} by the recompute) {tag}")
    return rows


def attn_cases(torch, dev):
    """Phase 6's inputs: the training shape in threshold mode, the
    dense-selection shape in mask mode, then edge cases: D in
    {16, 64, 128}, q/k blocks 16..128 (unequal too), every mode causal
    and not, fp32 and bf16."""
    f32, bf16 = torch.float32, torch.bfloat16
    yield "main_BH32_S4096_D128_blk128_threshold_causal_bf16", attn_case(
        torch, bh=32, s=4096, d=128, qb=128, kb=128, dtype=bf16,
        mode="threshold", causal=True, seed=0, device=dev, topk=64)
    yield "BH32_S2048_D128_blk128_mask_bf16", attn_case(
        torch, bh=32, s=2048, d=128, qb=128, kb=128, dtype=bf16,
        mode="mask", causal=False, seed=1, device=dev)
    specs = [  # (bh, s, d, qb, kb, dtype, mode, causal)
        (3, 64, 16, 16, 16, f32, "threshold", True),
        (2, 128, 64, 32, 32, f32, "threshold", False),
        (2, 256, 128, 64, 128, f32, "mask", False),
        (2, 128, 32, 32, 32, f32, "block", False),
        (2, 128, 32, 32, 16, f32, "block", True),
        (2, 256, 128, 128, 64, bf16, "block", True),
        (3, 512, 128, 128, 128, bf16, "threshold", True),
        (2, 192, 64, 64, 64, bf16, "mask", False),
        (2, 256, 64, 128, 128, bf16, "block", False),
    ]
    for n, (bh, s, d, qb, kb, dt, mode, causal) in enumerate(specs):
        yield (f"{mode}{'_causal' if causal else ''}_D{d}_qb{qb}_kb{kb}_"
               f"{str(dt).split('.')[-1]}"), attn_case(
            torch, bh=bh, s=s, d=d, qb=qb, kb=kb, dtype=dt, mode=mode,
            causal=causal, seed=10 + n, device=dev)


def check_attn_kernels(torch, sa, dev, tag):
    """Phase 6: both prefill kernels against their plain versions on
    every case, an empty plan, two launches bitwise equal, and the main
    case's selection against the backward recompute's."""
    main = None
    for name, c in attn_cases(torch, dev):
        if main is None:
            main, main_name = c, name
            log(f"[attn-kernel] main plan: {int(c['cnt'].sum())} planned "
                f"tiles of {c['bm'].numel()}, P {c['idx'].shape[-1]}")
            main_adm = check_attn_case(torch, sa, name, c)
        else:
            check_attn_case(torch, sa, name, c)
    recompute_flips(torch, main, main_adm, main_name, tag)
    c = attn_case(torch, bh=2, s=64, d=16, qb=16, kb=16, dtype=torch.float32,
                  mode="threshold", causal=True, seed=99, device=dev)
    idx0 = c["idx"][..., :0].contiguous()                     # P == 0
    got = run_attn(sa, c, plain=False, idx=idx0)
    assert got.shape == c["q"].shape and not got.any(), "P0: not zeros"
    log("[attn-kernel] P0: zeros")
    a = run_attn(sa, main, plain=False)
    b = run_attn(sa, main, plain=False)
    torch.cuda.synchronize()
    assert torch.equal(a, b), "two launches differ"
    log("[attn-kernel] main: two launches bitwise equal: True")


def main_path_cfg(base, **kernel):
    """qwen3-4b at full width through the SATA kernel route, 128-blocks."""
    from repro_torch.models.config import SataKernelConfig
    return dataclasses.replace(
        base, remat="full",
        sata=dataclasses.replace(base.sata, kernel=SataKernelConfig(
            use=True, block=128, **kernel)))


class FirstCall:
    """While open, ``kernels.ops.<name>`` (the kernel route's dispatch to
    one prefill kernel) keeps the arguments of its first call, which in a
    forward pass is layer 0's, and passes every call on unchanged.  It
    launches nothing itself, so the launch counts stay the main path's."""

    def __init__(self, name):
        from repro_torch.kernels import ops
        self.ops, self.name, self.args, self.kw = ops, name, None, None

    def __enter__(self):
        self.fn = getattr(self.ops, self.name)
        setattr(self.ops, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.fn)

    def __call__(self, *args, **kw):
        if self.args is None:
            self.args, self.kw = args, kw
        return self.fn(*args, **kw)


def planned_map(torch, idx, cnt, nkb):
    """(BH, nqb, nkb) bool: the k-blocks each row's plan visits (padding
    slots repeat a live index: reduce, never overwrite)."""
    live = (torch.arange(idx.shape[-1], device=idx.device)
            < cnt[..., None]).to(torch.int32)
    return torch.zeros(idx.shape[:2] + (nkb,), dtype=torch.int32,
                       device=idx.device).scatter_reduce_(
        2, idx.long(), live, reduce="amax").bool()


def recorded_case(torch, sa, rec, *, dense_grid):
    """A case as ``attn_case`` builds it, from the arguments a FirstCall
    recorded: the very tensors the main path handed the kernel."""
    import inspect
    from repro_torch.core.blockmap import compact_kv_plan
    fn = sa.sata_block_attention if dense_grid \
        else sa.sata_block_attention_compact
    bound = inspect.signature(fn).bind(*rec.args, **rec.kw)
    bound.apply_defaults()
    # q/k/v reach the kernel as the autograd Function's inputs: detach them
    # so phase 10's plain-version calls build no graph
    a = {n: x.detach() if isinstance(x, torch.Tensor) else x
         for n, x in bound.arguments.items()}
    kb = a["k_block"]
    sel = {n: a[n] for n in ("mask", "thresholds") if a.get(n) is not None}
    causal = bool(a.get("causal")) and a["mask"] is None
    if causal:
        sel.update(causal=True, q_pos=a["q_pos"], k_pos=a["k_pos"])
    if dense_grid:
        bm = a["block_map"].bool()
        idx, cnt = compact_kv_plan(bm)
    else:
        idx, cnt = a["kv_indices"], a["kv_counts"]
        bm = planned_map(torch, idx, cnt, a["k"].shape[1] // kb)
    mode = "mask" if "mask" in sel else \
        "threshold" if "thresholds" in sel else "block"
    return dict(q=a["q"], k=a["k"], v=a["v"], qb=a["q_block"], kb=kb,
                mode=mode, causal=causal, sel=sel, bm=bm, idx=idx, cnt=cnt)


def attended_pairs(torch, c):
    """(BH, Sq, Sk) bool: the pairs the kernel attends on case ``c``,
    planned tiles AND the mode's element selection.  Threshold mode
    scores with einsum here, so a score on a bf16 rounding boundary may
    fall on the other side than in the kernel (``recompute_flips``
    counts such rows)."""
    from repro_torch.core.blockmap import bisect_select
    q, k = c["q"], c["k"]
    bh, s, d = q.shape
    keep = c["bm"].repeat_interleave(c["qb"], 1).repeat_interleave(c["kb"], 2)
    sel = c["sel"]
    if "mask" in sel:
        keep &= sel["mask"].bool()
    if "thresholds" in sel:
        sc = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) \
            * (1.0 / np.sqrt(d))
        keep &= bisect_select(sc, sel["thresholds"])
        del sc
    if sel.get("causal"):
        keep &= (sel["k_pos"].reshape(bh, 1, -1)
                 <= sel["q_pos"].reshape(bh, -1, 1))
    return keep


def attn_bound(torch, c, admitted, keep):
    """Least time for the function's work on an H100: the larger of its
    flops over the peak for the input type and its bytes over
    3.35 TB/s, both counted from this input.  Flops: 2·D for each score
    the selection needs (mask mode: the selected pairs; threshold and
    block mode: the position-admissible pairs of the planned tiles) and
    2·D for each admitted key's PV product (``admitted``, the kernel's
    per-row counts).  Bytes, each once: q and the output; the K rows
    scored (mask mode: keys some row selects; else the planned k-blocks)
    and the V rows some row attends (``keep``); the plan, thresholds,
    positions and the mask bytes of planned tiles."""
    q = c["q"]
    bh, s, d = q.shape
    es = q.element_size()
    qb, kb, sel, planned = c["qb"], c["kb"], c["sel"], c["bm"]
    nqb, nkb = planned.shape[1:]
    tiles = int(planned.sum())
    pv = int(admitted.sum())
    v_rows = int(keep.any(dim=1).sum())
    if "mask" in sel:
        qk, k_rows = pv, v_rows
    else:
        k_rows = int(planned.any(dim=1).sum()) * kb
        if sel.get("causal"):
            qp = sel["q_pos"].reshape(bh, nqb, qb, 1)
            kp = sel["k_pos"].reshape(bh, nkb, 1, kb)
            qk = sum(int(((kp[:, None, j] <= qp).sum((-1, -2))
                          * planned[..., j]).sum()) for j in range(nkb))
        else:
            qk = tiles * qb * kb
    nbytes = ((2 * bh * s + k_rows + v_rows) * d * es
              + (c["idx"].numel() + c["cnt"].numel()) * 4)
    if "thresholds" in sel:
        nbytes += sel["thresholds"].numel() * 4
    if sel.get("causal"):
        nbytes += 4 * bh * s * 2
    if "mask" in sel:
        nbytes += tiles * qb * kb
    flops = 2 * d * (qk + pv)
    peak = BF16_FLOPS_PER_S if es == 2 else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            dict(tiles=tiles, qk_pairs=qk, pv_keys=pv, gflop=flops / 1e9,
                 mbytes=nbytes / 1e6))


def reset_attn_counts(sa):
    sa.sata_block_attention_compact.launches = 0
    sa.sata_block_attention.launches = 0


def attn_counts(sa):
    return (sa.sata_block_attention_compact.launches,
            sa.sata_block_attention.launches)


def train_main_path(torch, sa, dev, base, tag, *, steps=4, seq=4096):
    """Phase 7: ``train()`` on full-width qwen3-4b through the compacted
    grid; returns layer 0's recorded kernel arguments as a case for
    phase 10 and the kernel's launch count."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import train
    cfg = main_path_cfg(dataclasses.replace(base, topk_impl="bisect"))
    reset_attn_counts(sa)
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    with FirstCall("_block_attention_compact") as rec:
        out = train("qwen3-4b", cfg=cfg, steps=steps, batch=1, seq=seq,
                    log_every=1, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t
    n_b3, n_b4 = attn_counts(sa)
    want = cfg.n_layers * steps * 2
    log(f"[train] qwen3-4b full width, {cfg.n_layers} layers, batch 1, "
        f"S {seq}, chunked selection, remat full: losses "
        f"{[round(x, 4) for x in out['losses']]}, grad norms "
        f"{[round(x, 4) for x in out['gnorms']]}")
    log(f"[train] step seconds {[round(x, 3) for x in out['step_s']]}, "
        f"tokens/s {[round(seq / x, 1) for x in out['step_s']]}, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB, {wall:.1f} s in all; compacted-grid launches {n_b3} "
        f"(= {cfg.n_layers} layers x {steps} steps x 2: forward + remat "
        f"recompute), dense-grid launches {n_b4} {tag}")
    assert all(np.isfinite(out["losses"])) and all(np.isfinite(out["gnorms"]))
    assert n_b3 == want, f"compacted-grid launches {n_b3} != {want}"
    assert n_b4 == 0, f"the dense grid ran {n_b4} times on the main path"
    batch = {k: torch.from_numpy(a).to(dev) for k, a in
             SyntheticLM(cfg, 1, seq, seed=0).next_batch().items()}
    profile_step(torch, cfg, out["final_state"], batch, tag)
    return recorded_case(torch, sa, rec, dense_grid=False), n_b3


def profile_step(torch, cfg, state, batch, tag, top=12):
    """One more training step under ``torch.profiler``: device time by
    kernel (summed over launches; the top ones and the port's own) and
    the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import make_train_step
    step_fn = make_train_step(cfg, OptConfig())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t = time.time()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t)

    dev_ms = device_ms
    # kernels only: operator rows carry their kernels' device time too
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == cuda and dev_ms(e) > 0]
    busy = sum(dev_ms(e) for e in evs)
    log(f"[profile] one training step: wall {wall_ms:.1f} ms (profiler "
        f"on), device busy {busy:.1f} ms = {100 * busy / wall_ms:.1f}% of "
        f"it; idle {100 * (1 - busy / wall_ms):.1f}% {tag}")
    # the top kernels, and the port's own wherever they rank
    ranked = sorted(evs, key=dev_ms, reverse=True)
    for e in ranked[:top] + [e for e in ranked[top:] if "sata_" in e.key]:
        log(f"[profile]   {dev_ms(e):9.2f} ms {100 * dev_ms(e) / busy:5.1f}% "
            f"x{e.count:<6d} {e.key[:90]}")


def route_on_off(torch, sa, dev, base, tag, *, layers=4, seq=4096):
    """Phase 8: one forward + backward at full width with the kernel
    route on and off (``_attend``): the same loss and grad norm within
    ROUTE_RTOL, and layer 0's attention output on the same input within
    ROUTE_ATTN_RTOL (relative Frobenius norm)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.attention import attention_apply
    from repro_torch.models.config import SataKernelConfig
    from repro_torch.models.layers import _dtype, apply_norm, embed_apply
    from repro_torch.models.model import DenseModel, loss_fn
    on = main_path_cfg(dataclasses.replace(base, topk_impl="bisect",
                                           n_layers=layers))
    off = dataclasses.replace(on, sata=dataclasses.replace(
        on.sata, kernel=SataKernelConfig(use=False)))
    model = DenseModel(on, device=dev, seed=1)
    batch = {k: torch.from_numpy(a).to(dev) for k, a in
             SyntheticLM(on, 1, seq, seed=1).next_batch().items()}
    p0 = model["layers"][0]
    with torch.no_grad():
        x0 = apply_norm(p0["ln1"], on, embed_apply(
            model["embed"], batch["tokens"]).to(_dtype(on)))
    res = {}
    for name, cfg in (("kernel route", on), ("_attend", off)):
        model.zero_grad(set_to_none=True)
        reset_attn_counts(sa)
        t = time.time()
        loss, _ = loss_fn(model, cfg, batch)
        loss.backward()
        torch.cuda.synchronize()
        secs, counts = time.time() - t, attn_counts(sa)
        gn = float(torch.sqrt(sum(torch.sum(p.grad.float() ** 2)
                                  for p in model.parameters())))
        with torch.no_grad():
            attn0 = attention_apply(p0["attn"], cfg, x0).float()
        res[name] = (loss.item(), gn, attn0)
        log(f"[route] {name}: loss {res[name][0]:.6f}, grad norm {gn:.6f}, "
            f"fwd+bwd {secs:.2f} s, launches (B3, B4) {counts} {tag}")
    (l1, g1, a1), (l0, g0, a0) = res["kernel route"], res["_attend"]
    rel = {"loss": abs(l1 - l0) / abs(l0),
           "grad norm": abs(g1 - g0) / abs(g0),
           "layer-0 attention output": float(
               torch.linalg.vector_norm(a1 - a0)
               / torch.linalg.vector_norm(a0))}
    lim = {"loss": ROUTE_RTOL, "grad norm": ROUTE_RTOL,
           "layer-0 attention output": ROUTE_ATTN_RTOL}
    log("[route] kernel route vs _attend, relative: " + ", ".join(
        f"{n} {rel[n]:.3e} (limit {lim[n]:g})" for n in rel))
    bad = [n for n in rel if not rel[n] <= lim[n]]
    assert not bad, f"kernel route vs _attend differ in {bad}: {rel}"


def prefill_schedules(torch, sa, dev, base, tag, *, layers=4, seq=2048):
    """Phase 9: the dense-selection route through ``make_prefill_step`` on
    both grids: equal logits bitwise.  Returns layer 0's recorded
    dense-grid arguments as a case for phase 10 and B4's launch count on
    its own run."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.ops import kernel_fetch_stats
    from repro_torch.models.model import DenseModel
    from repro_torch.train.step import make_prefill_step
    cfgs = {sch: main_path_cfg(dataclasses.replace(
        base, topk_impl="sort", n_layers=layers), schedule=sch)
        for sch in ("compact", "dense")}
    model = DenseModel(cfgs["compact"], device=dev, seed=2)
    tokens = torch.from_numpy(SyntheticLM(cfgs["compact"], 1, seq, seed=2)
                              .next_batch()["tokens"]).to(dev)
    logits, counts = {}, {}
    for sch, cfg in cfgs.items():
        reset_attn_counts(sa)
        t = time.time()
        with FirstCall("_block_attention_dense") as rec:
            logits[sch] = make_prefill_step(cfg)(model, {"tokens": tokens})
        torch.cuda.synchronize()
        counts[sch] = attn_counts(sa)
        log(f"[prefill] topk sort, {sch} grid, {layers} layers, S {seq}: "
            f"{time.time() - t:.2f} s, launches (B3, B4) {counts[sch]} {tag}")
        if sch == "dense":
            case = recorded_case(torch, sa, rec, dense_grid=True)
    assert counts["compact"] == (layers, 0), counts
    assert counts["dense"] == (0, layers), counts
    assert torch.isfinite(logits["compact"]).all()
    same = torch.equal(logits["compact"], logits["dense"])
    log(f"[prefill] compact == dense grid logits bitwise: {same}")
    assert same, "compacted and dense grid logits differ"
    stats = kernel_fetch_stats(case["bm"], q_block=case["qb"],
                               k_block=case["kb"], d=case["q"].shape[-1],
                               dtype_bytes=case["q"].element_size())
    log(f"[prefill] layer 0 kernel_fetch_stats: {json.dumps(stats)}")
    return case, counts["dense"][1]


def time_attn(torch, sa, c, name, tag, *, dense_grid=False):
    """Phase 10 for one kernel on a recorded case: kernel vs plain
    version (phase 6's limits), then the kernel, the plain version and
    SDPA with the equivalent mask timed, and the bound.  Returns the
    ``kernels`` row's numbers and the kernel's admitted-key counts."""
    a_k, a_p = admitted_buffer(torch, c), admitted_buffer(torch, c)
    got = run_attn(sa, c, plain=False, dense_grid=dense_grid, admitted=a_k)
    want = run_attn(sa, c, plain=True, dense_grid=dense_grid, admitted=a_p)
    torch.cuda.synchronize()
    err = compare(torch, f"{name} on the main path's layer-0 arguments",
                  got, want, a_k, a_p, attn_window(torch, sa, c))
    del got, want
    ms = time_ms(torch, lambda: run_attn(sa, c, plain=False,
                                         dense_grid=dense_grid))
    plain_ms = time_ms(torch, lambda: run_attn(sa, c, plain=True,
                                               dense_grid=dense_grid),
                       reps=3, warm=1)
    bh, s, d = c["q"].shape
    keep = attended_pairs(torch, c)
    q4, k4, v4 = (c[n].reshape(1, bh, s, d) for n in ("q", "k", "v"))
    lib_ms = time_ms(torch, lambda: torch.nn.functional
                     .scaled_dot_product_attention(q4, k4, v4,
                                                   attn_mask=keep[None]))
    bound_ms, bound_by, n = attn_bound(torch, c, a_k, keep)
    del keep
    body, smem = attn_body(torch, c, dense_grid)
    if c["q"].dtype == torch.bfloat16:
        assert body == "tensor cores", f"{name}: bf16 on the {body}"
    log(f"[timing] {name}: BH {bh}, S {s}, D {d}, {c['qb']}x{c['kb']} "
        f"tiles, {c['mode']} mode, {n['tiles']} planned tiles of "
        f"{c['bm'].numel()}, {n['qk_pairs']} scores and {n['pv_keys']} "
        f"admitted keys needed ({n['gflop']:.2f} GFLOP, "
        f"{n['mbytes']:.1f} MB), {body}, {smem} bytes of dynamic shared "
        f"memory: kernel {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.2f} ms, "
        f"SDPA+mask {lib_ms:.4f} ms {tag}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms), a_k


def prefill_phases(torch, sa, dev, base, tag):
    """Phases 7-10; returns the two prefill kernels' ``kernels`` rows."""
    c3, n_b3 = train_main_path(torch, sa, dev, base, tag)
    torch.cuda.empty_cache()
    route_on_off(torch, sa, dev, base, tag)
    torch.cuda.empty_cache()
    c4, n_b4 = prefill_schedules(torch, sa, dev, base, tag)
    torch.cuda.empty_cache()
    rows = []
    for fn, c, launches, dense_grid in (
            (sa.sata_block_attention_compact, c3, n_b3, False),
            (sa.sata_block_attention, c4, n_b4, True)):
        t, adm = time_attn(torch, sa, c, fn.__name__, tag,
                           dense_grid=dense_grid)
        if c["mode"] == "threshold":
            recompute_flips(torch, c, adm, f"{fn.__name__} main path", tag)
        rows.append({"name": fn.__name__, "route": "cuda",
                     "source": SRC_ATTN_CU,
                     "replaces": REPLACES["dense" if dense_grid
                                          else "compact"],
                     "launches": launches, **t})
    return rows


# one-line faults of the kernels that phases 2 and 6 must catch:
# name -> (source, line, mutated line)
MUTANTS = {
    "fp32_predicate": (SRC_CU, "return bf16_rn(s) >= thr; }",
                       "return s >= thr; }"),
    "unrounded_p": (SRC_CU, "const float pr = to_f32(from_f32<T>(p));",
                    "const float pr = p;"),
    "decode_pos_lt": (SRC_CU, "const bool live = tok <= pos_b;",
                      "const bool live = tok < pos_b;"),
    # the tensor-core body (bf16): an fp32 predicate, `<` for `<=` on the
    # causal test, l summed from the rounded p
    "attn_fp32_predicate": (SRC_ATTN_CU, "edge[h] = admit_edge(t);",
                            "edge[h] = t;"),
    "attn_causal_lt": (SRC_ATTN_CU,
                       "if constexpr (kPos) sel = sel && kpos[key] <= qpos[h];",
                       "if constexpr (kPos) sel = sel && kpos[key] < qpos[h];"),
    "attn_l_of_rounded_p": (SRC_ATTN_CU, "rs[e >> 1] += pe[e];",
                            "rs[e >> 1] += bf16_rn(pe[e]);"),
    # the CUDA-core body (fp32): an fp32 predicate
    "attn_fma_fp32_predicate": (SRC_ATTN_CU,
                                "if (p.thr) sel = bf16_rn(sc) >= thr_sh[r];",
                                "if (p.thr) sel = sc >= thr_sh[r];"),
}
# prefill-kernel mutants also run through phase 8; these must fail it too
# (l of the rounded p moves single bf16 roundings, below its limits; the
# fp32 body does not run there)
PHASE8_MUST_CATCH = ("attn_fp32_predicate", "attn_causal_lt")
# decode mutants that a named phase-2 case must catch (any case of that
# name's prefix)
CASE_MUST_CATCH = {"decode_pos_lt": "pos_inside_page"}
PHASE8 = "phase8_route"

_MUTANT_CHILD = """
import sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
import chip_smoke as cs
from repro_torch.configs.archs import ARCHS
from repro_torch.kernels import sata_attention as sa
from repro_torch.kernels import sata_decode as sd
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
failed = []
if sys.argv[2] == "decode":
    suites = [(n, lambda c=c: cs.check_case(torch, sd, n, c))
              for n, c in cs.kernel_cases(torch, dev)]
else:
    suites = [(n, lambda n=n, c=c: cs.check_attn_case(torch, sa, n, c))
              for n, c in cs.attn_cases(torch, dev)]
    suites.append((cs.PHASE8, lambda: cs.route_on_off(
        torch, sa, dev, ARCHS["qwen3-4b"], "")))
for name, run in suites:
    try:
        run()
    except AssertionError as e:
        failed.append(name)
        print("[mutant] fails:", e, flush=True)
print("FAILED", ",".join(failed))
"""


def run_mutants(root: str) -> int:
    """``--mutants``: build each of ``MUTANTS`` in a temporary copy of the
    tree and run its kernel's cases (phase 2, or phase 6 and phase 8) on
    it.  Fails unless phase 2 or 6 catches every mutant and phase 8
    catches those of PHASE8_MUST_CATCH."""
    import shutil
    import tempfile
    missed = []
    for name, (src, old, new) in MUTANTS.items():
        with tempfile.TemporaryDirectory() as d:
            shutil.copytree(os.path.join(root, "src"), os.path.join(d, "src"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(os.path.abspath(__file__), d)
            cu = os.path.join(d, src)
            with open(cu) as f:
                text = f.read()
            assert text.count(old) == 1, f"{name}: {old!r} not found once"
            with open(cu, "w") as f:
                f.write(text.replace(old, new))
            suite = "decode" if src == SRC_CU else "attention"
            res = subprocess.run(
                [sys.executable, "-c", _MUTANT_CHILD, d, suite],
                capture_output=True, text=True, cwd=d)
        lines = res.stdout.splitlines()
        for line in lines[:-1]:
            log(f"[{name}] {line}")
        if res.returncode or not lines or not lines[-1].startswith("FAILED"):
            log(res.stderr[-4000:])
            return 1
        failed = [c for c in lines[-1].split(" ", 1)[-1].split(",") if c]
        kernel_cases = [c for c in failed if c != PHASE8]
        log(f"[{name}] caught by {len(kernel_cases)} kernel case(s): "
            f"{kernel_cases}" + ("" if suite == "decode" else
                                 f"; by phase 8: {PHASE8 in failed}"))
        if not kernel_cases:
            missed.append(name)
        want = CASE_MUST_CATCH.get(name)
        if want and not any(c.startswith(want) for c in kernel_cases):
            missed.append(f"{name} ({want})")
        if name in PHASE8_MUST_CATCH and PHASE8 not in failed:
            missed.append(f"{name} (phase 8)")
    log(f"mutants missed: {missed}")
    return 1 if missed else 0


def build_variant(build, src: str, lib) -> str:
    """Compile the kernel source ``src`` (a path; it may include the
    checkout's shared ``csrc/*.cuh``) into the library ``lib``; returns
    ptxas's report."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                          "-I", str(build.CSRC), "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stderr


def ptxas_lines(text: str, key: str):
    """ptxas -v's register and spill lines for each kernel whose mangled
    name holds ``key``, each prefixed with that name."""
    out, entry = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif entry and key in entry and ("registers" in line
                                         or "spill" in line):
            out.append(f"{entry}: {line.strip()}")
    return out


def parent_kernel(build, parent: str, name: str, symbol: str, argtypes):
    """Build ``parent``'s ``csrc/<name>.cu`` (an earlier checkout) and
    return its C entry point ``symbol`` typed with ``argtypes`` (which
    must be the parent's signature too) and ptxas's report."""
    import ctypes
    import re
    src = os.path.join(parent, os.path.dirname(SRC_CU), f"{name}.cu")
    with open(src) as f:
        sig = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)",
                        f.read(), re.S).group(1)
    kinds = [ctypes.c_void_p if "*" in a else ctypes.c_int
             for a in sig.split(",")]
    assert kinds == argtypes, f"{parent}: {symbol} has another C interface"
    lib = build.BUILD_DIR / "parent" / f"lib{name}_parent.so"
    report = build_variant(build, src, lib)
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn, report


@contextlib.contextmanager
def launching(module, fn):
    """While open, ``module``'s CUDA wrappers launch ``fn``, another build
    of their C entry point."""
    old = module._launcher
    module._launcher = lambda: fn
    try:
        yield
    finally:
        module._launcher = old


def run_ab(root: str, parent: str) -> int:
    """``--ab PARENT``: phase 2 on this tree's decode kernel, then this
    kernel and PARENT's timed in turns (parent, this, this, parent) at
    phase 5's three shapes, both layouts, and the decode probes; then
    ``ab_prefill``.  One process on one card."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import sata_attention as sa
    from repro_torch.kernels import sata_decode as sd
    dev = torch.device("cuda")
    card = card_line()
    tag = f"[{card}]"
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    build_all(build, root)
    old, _ = parent_kernel(build, parent, "sata_decode",
                           "sata_decode_attention", sd.ARGTYPES)
    main_case, _ = check_kernels(torch, sd, dev)
    cases = [("main_B8_KV8_G4_D128_page64_bf16", main_case),
             *extra_decode_cases(torch, dev)]
    rows = []
    for name, c in cases:
        for paged in (True, False):
            with launching(sd, old):
                got = run_kernel(sd, c, paged)
            want = run_plain(sd, c, paged)
            torch.cuda.synchronize()
            e = float((got.float() - want.float()).abs().max())
            assert e <= TOL["bfloat16"], f"parent {name}: {e}"
            ts = {"parent": [], "change": []}
            for who in ("parent", "change", "change", "parent"):
                with launching(sd, old) if who == "parent" \
                        else contextlib.nullcontext():
                    ts[who].append(time_ms(
                        torch, lambda: run_kernel(sd, c, paged)))
            bound_ms = kernel_bound(torch, c, paged)[0]
            lay = "paged" if paged else "contiguous"
            log(f"[ab] {name} {lay}: parent {ts['parent']} ms, change "
                f"{ts['change']} ms (in turns: parent, change, change, "
                f"parent); bound {bound_ms:.5f} ms {tag}")
            rows.append(dict(case=name, layout=lay, bound_ms=bound_ms, **ts))
    probes = probe_decode(torch, sd, build, root, main_case, tag)
    del main_case, cases
    prefill = ab_prefill(torch, sa, build, parent, dev, tag)
    log(card)
    log(json.dumps({"ab": rows, "probes": probes, "ab_prefill": prefill}))
    return 0


def ab_prefill(torch, sa, build, parent, dev, tag):
    """``--ab`` for the prefill kernels: PARENT's ``sata_attention.cu``
    beside this tree's, ptxas's registers and spills for each body of
    both, then phase 6's two main cases (BH32 S4096 threshold causal:
    B3; BH32 S2048 mask: B3 and B4): this kernel against its plain
    version (phase 6's checks), the parent against this kernel, both
    timed in turns (parent, change, change, parent), SDPA with the
    equivalent mask and the bound beside them."""
    old, report = parent_kernel(build, parent, "sata_attention",
                                "sata_block_attention", sa.ARGTYPES)
    mine = build.library_path("sata_attention")
    for who, text in (("parent", report), ("change", (
            mine.parent / f"{mine.stem}.ptxas.txt").read_text())):
        for line in ptxas_lines(text, "sata_block"):
            log(f"[ab] ptxas {who}: {line}")
    rows = []
    for name, c in itertools.islice(attn_cases(torch, dev), 2):
        check_attn_case(torch, sa, name, c)
        keep = attended_pairs(torch, c)
        bh, s, d = c["q"].shape
        q4, k4, v4 = (c[n].reshape(1, bh, s, d) for n in ("q", "k", "v"))
        lib_ms = time_ms(torch, lambda: torch.nn.functional
                         .scaled_dot_product_attention(
                             q4, k4, v4, attn_mask=keep[None]))
        for dense_grid in (False, True) if c["mode"] == "mask" else (False,):
            kname = "B4" if dense_grid else "B3"
            adm = admitted_buffer(torch, c)
            got = run_attn(sa, c, plain=False, dense_grid=dense_grid,
                           admitted=adm)
            with launching(sa, old):
                ref = run_attn(sa, c, plain=False, dense_grid=dense_grid)
            torch.cuda.synchronize()
            e = float((got.float() - ref.float()).abs().max())
            assert e <= TOL["bfloat16"], f"parent {kname} {name}: {e}"
            del got, ref
            ts = {"parent": [], "change": []}
            for who in ("parent", "change", "change", "parent"):
                with launching(sa, old) if who == "parent" \
                        else contextlib.nullcontext():
                    ts[who].append(time_ms(torch, lambda: run_attn(
                        sa, c, plain=False, dense_grid=dense_grid)))
            bound_ms, bound_by, _ = attn_bound(torch, c, adm, keep)
            body, smem = attn_body(torch, c, dense_grid)
            log(f"[ab] {kname} {name}: parent {ts['parent']} ms, change "
                f"{ts['change']} ms (in turns: parent, change, change, "
                f"parent); SDPA+mask {lib_ms:.4f} ms; bound "
                f"{bound_ms:.4f} ms ({bound_by}); this tree's body: {body}, "
                f"{smem} bytes of dynamic shared memory; parent vs change "
                f"max abs {e:.3e} {tag}")
            rows.append(dict(kernel=kname, case=name, sdpa_ms=lib_ms,
                             bound_ms=bound_ms, body=body, smem=smem, **ts))
        del keep, q4, k4, v4
        rows.append(dict(kernel="B3", case=name, probes=probe_prefill(
            torch, sa, build, c, name, tag)))
        del c
        torch.cuda.empty_cache()
    return rows


# changes of the prefill kernel's tensor-core body that take a part of its
# work away, timed by ``--ab`` (their outputs are wrong)
PREFILL_PROBES = {
    "copies_and_barriers_only": (
        "    {\n      // S = Q K^T for the warp's 16 rows",
        "    issue(j + kStages - 1);\n    if (false) {\n"
        "      // S = Q K^T for the warp's 16 rows"),
    "no_near_test": ("            near |= fabsf(s[nt][e] - edge[e >> 1]) <=",
                     "            near |= false && fabsf(s[nt][e] - edge[e >> 1]) <="),
    "no_recheck": ("        if (__any_sync(0xffffffffu, near)) {",
                   "        if (__any_sync(0xffffffffu, near) && p.n_bh < 0) {"),
    "no_qk": ("      for (int ks = 0; ks < kMaxD / 16; ++ks) {\n        uint32_t a[4], b",
              "      for (int ks = 0; ks < 0; ++ks) {\n        uint32_t a[4], b"),
    "no_pv": ("      if (__any_sync(0xffffffffu, (selb[0] | selb[1]) != 0u)) {",
              "      if (false) {"),
    "no_kv_copies": ("      for (int x = tid; x < KB * cpr; x += kTcThreads) {",
                     "      for (int x = tid; x < 0; x += kTcThreads) {"),
}


def probe_prefill(torch, sa, build, c, name, tag):
    """Where B3's time goes on case ``c``: the kernel as built, with every
    plan row's count 0 (launch, prologue, epilogue), and with each of
    PREFILL_PROBES taken out.  Returns {label: ms}."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    run = lambda case=c: run_attn(sa, case, plain=False)  # noqa: E731
    out = {"as_built": time_ms(torch, run)}
    c0 = dict(c, cnt=torch.zeros_like(c["cnt"]))
    out["count_0_rows"] = time_ms(torch, lambda: run(c0))
    src = open(os.path.join(build.CSRC, "sata_attention.cu")).read()
    pdir = build.BUILD_DIR / "probe"
    pdir.mkdir(parents=True, exist_ok=True)
    # the probes of this source, built once per source
    stem = build.library_path("sata_attention").stem

    def compile_probe(probe):
        old, new = PREFILL_PROBES[probe]
        assert src.count(old) == 1, f"probe {probe}: {old!r} not found once"
        so = pdir / f"{stem}_{probe}.so"
        if not so.exists():
            (pdir / f"{stem}_{probe}.cu").write_text(src.replace(old, new))
            build_variant(build, pdir / f"{stem}_{probe}.cu", so)

    with ThreadPoolExecutor(len(PREFILL_PROBES)) as ex:
        list(ex.map(compile_probe, PREFILL_PROBES))
    for probe in PREFILL_PROBES:
        fn = ctypes.CDLL(str(pdir / f"{stem}_{probe}.so")).sata_block_attention
        fn.argtypes, fn.restype = sa.ARGTYPES, ctypes.c_int
        with launching(sa, fn):
            out[probe] = time_ms(torch, run)
    for k, v in out.items():
        log(f"[probe] B3 {name}, {k}: {v:.4f} ms {tag}")
    return out


# one-line changes of the decode kernel that take a part of its work away,
# timed by ``--ab`` to show where the time goes (their outputs are wrong)
PROBES = {
    "no_scoring": ("      for (int mt = warp; mt * 16 < C; mt += kWarps) {",
                   "      for (int mt = C; mt * 16 < C; mt += kWarps) {"),
    "no_k_copies": ("        one(x, [](void* d, const void* g) { copy_async(d, g, 16); });",
                    "        one(x, [](void* d, const void* g) {});"),
}
# (chunk, stages) at the main shape, with a 20-block window and 128 V rows
PROBE_RINGS = [(64, 2), (64, 4), (64, 8), (192, 2), (256, 2)]


def probe_decode(torch, sd, build, root, c, tag):
    """What bounds the decode kernel on main-path case ``c`` (paged):
    the kernel with rows of count 0 (launch, prologue, epilogue), with
    the L2 warm (no flush, launches back to back), at other ring sizes,
    and with the PROBES taken out.  Returns {label: ms}."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    run = lambda case=c: run_kernel(sd, case, True)  # noqa: E731
    out = {"launch_config": time_ms(torch, run)}
    c0 = dict(c, cnt=torch.zeros_like(c["cnt"]))
    out["count_0_rows"] = time_ms(torch, lambda: run(c0))
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(30):
        run()
    z.record()
    torch.cuda.synchronize()
    out["warm_l2_back_to_back"] = a.elapsed_time(z) / 30
    base = sd.launch_config
    g, d = c["q"].shape[2:]
    try:
        for chunk, stages in PROBE_RINGS:
            n = sd.smem_bytes(g, d, c["page"], 2, chunk, stages, 20, 128)
            sd.launch_config = lambda *_, cfg=sd.LaunchConfig(
                chunk, stages, 20, 128, n): cfg
            out[f"chunk_{chunk}_stages_{stages}"] = time_ms(torch, run)
    finally:
        sd.launch_config = base
    src = open(os.path.join(root, SRC_CU)).read()
    pdir = build.BUILD_DIR / "probe"
    pdir.mkdir(parents=True, exist_ok=True)

    def compile_probe(name):
        old, new = PROBES[name]
        assert src.count(old) == 1, f"probe {name}: {old!r} not found once"
        (pdir / f"{name}.cu").write_text(src.replace(old, new))
        build_variant(build, pdir / f"{name}.cu", pdir / f"{name}.so")

    with ThreadPoolExecutor(len(PROBES)) as ex:
        list(ex.map(compile_probe, PROBES))
    for name in PROBES:
        fn = ctypes.CDLL(str(pdir / f"{name}.so")).sata_decode_attention
        fn.argtypes, fn.restype = sd.ARGTYPES, ctypes.c_int
        with launching(sd, fn):
            out[name] = time_ms(torch, run)
    for k, v in out.items():
        log(f"[probe] decode kernel, main shape, paged, {k}: {v:.4f} ms {tag}")
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    # the training phase holds ~53 GB of parameters, gradients and moments
    # beside large transient buffers: let the allocator grow segments in
    # place rather than fragment
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        return run_ab(root, sys.argv[2])
    from repro_torch.configs.archs import ARCHS
    from repro_torch.kernels import build
    from repro_torch.kernels import sata_attention as sa
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
    build_all(build, root)

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

    # --- 5. kernel timing at the main-path shape, at B1 and at a long row
    kernels = []
    for layout in ("paged", "contiguous"):
        t = time_decode(torch, sd, main_case, "B8 KV8 G4 D128 page64 bf16",
                        layout == "paged", tag)
        fn = sd.sata_decode_attention_paged_kernel if layout == "paged" \
            else sd.sata_decode_attention_kernel
        kernels.append({
            "name": fn.__name__, "route": "cuda", "source": SRC_CU,
            "replaces": REPLACES[layout], "launches": runs[layout][1],
            "max_abs_err": max(errs.values()), **t})
    for cname, c in extra_decode_cases(torch, dev):
        check_case(torch, sd, cname, c)
        for paged in (True, False):
            time_decode(torch, sd, c, cname, paged, tag)
        del c
    c = main_case
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

    plan_ms = wall_ms(torch, planner, reps=20)
    step_ms = runs["paged"][0]["step_ms_mean"]
    per_layer = plan_ms + kernels[0]["ms"]
    log(f"[timing] per layer (paged, B8, exact re-plan over S=4096): "
        f"planner {plan_ms:.4f} ms (host clock) + decode kernel {kernels[0]['ms']:.4f} ms;"
        f" x {cfg.n_layers} layers = {cfg.n_layers * per_layer:.2f} ms of "
        f"the {step_ms:.2f} ms mean decode step "
        f"({100 * cfg.n_layers * per_layer / step_ms:.1f}%) {tag}")
    # --- 6. the SATA prefill kernels against their plain versions
    check_attn_kernels(torch, sa, dev, tag)

    # --- 7.-10. the training path and the prefill kernels' timing
    kernels += prefill_phases(torch, sa, dev, base, tag)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
