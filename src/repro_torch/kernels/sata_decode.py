"""SATA decode gather attention — the hand-written CUDA kernel for Hopper
(``csrc/sata_decode.cu``), its plain PyTorch version, and the wrappers.

Replaces ``repro/kernels/sata_decode.py``'s two Pallas kernels
(``sata_decode_attention_kernel`` over the contiguous cache and
``sata_decode_attention_paged_kernel`` over the page pool).  One CUDA
body serves both: a null page-table pointer means the contiguous layout.
For each (slot, KV head) row the kernel walks the ``kv_counts`` planned
LOGICAL k-blocks, scores the G grouped query heads in fp32 × 1/√D,
keeps ``bf16(s) >= bf16(thr)`` AND ``token <= pos[b]``, and runs an
online softmax; a row with no admissible key (and ``P == 0``) gives
zeros.  Its partial mode (``partial=True``, a rank's share of the keys
under context-parallel decode) writes the fp32 output unrounded and each
head's log-sum-exp instead, for the ranks' partials to be combined.

``launch_config`` picks the kernel's staging for a shape (the K rows a
ring stage holds, the ring's depth, the k-blocks a softmax window holds,
the V rows copied at once), the shared memory that takes, and the
thread-block cluster a row is split over (``cluster_for``).

``sata_decode_attention_ref`` is the same function as a per-tile loop in
plain PyTorch, with the kernel's predicate, finite sentinel and p
rounding; its ``splits`` models the kernel's split of a row over a
cluster (each share's own online softmax, combined in rank order).  The CUDA wrappers launch the kernel for CUDA tensors and
raise on anything else; ``kernels.ops.sata_decode_attention`` picks the
plain version only for CPU tensors.  Each CUDA wrapper counts its
launches in ``<wrapper>.launches`` (a plain int) so a run can show that
its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.blockmap import bisect_select
from repro_torch.core.selection import NEG_INF

MAX_G, MAX_D, MAX_BLOCK = 16, 128, 128    # csrc/sata_decode.cu limits
# csrc/sata_decode.cu's plan window and ring limit, and the shared memory
# a block may use on an H100 (sm_90: 227 KB)
PLAN_WIN, MAX_STAGES = 1024, 8
SMEM_MAX = 232_448
# a block of a row split over a cluster: two fit an SM's 228 KB (each
# with the 1 KB the system reserves a block)
SMEM_SPLIT = 115_712
CHUNK_BYTES = 49152         # K bytes a ring stage holds, at most
RING_BYTES = 98304          # K bytes the ring holds
V_BYTES = 49152             # V bytes a window's PV product takes at once


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """How the decode kernel stages its work: ``chunk`` K rows per ring
    stage (whole k-blocks, or a divisor of one), ``stages`` ring stages,
    a window of up to ``win_blocks`` k-blocks' scores between two
    softmax steps, its selected V rows ``v_rows`` at a time, the
    dynamic shared memory that layout takes, and the ``cluster`` of
    blocks each row's plan entries are split over."""
    chunk: int
    stages: int
    win_blocks: int
    v_rows: int
    smem_bytes: int
    cluster: int = 1


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def threads_for(g: int) -> int:
    """csrc/sata_decode.cu's block size for G grouped heads."""
    return 512 if g <= 4 else 256


def head_groups(g: int) -> int:
    """csrc/sata_decode.cu's head groups in the PV product on the CUDA
    cores: a thread accumulates the heads of one group, at most 8."""
    return 1 if g <= 8 else 2


def tc_pv(g: int, elem_bytes: int) -> bool:
    """csrc/sata_decode.cu runs the PV product on the tensor cores: bf16
    with G in 9..16 (the padded 16 heads are one m16 tile)."""
    return g > 8 and elem_bytes == 2


def cluster_for(g: int, elem_bytes: int) -> int:
    """The blocks of a cluster each (slot, KV head) row's plan entries are
    split over (portable cluster sizes): one at G = 1 (a model with as
    many KV heads as heads has rows enough to fill the card), four where
    two blocks fit an SM (the tensor cores' PV, ``tc_pv``: at most 128
    registers a thread, staged within SMEM_SPLIT), else two.  A function
    of the shape alone, never of the grid, so a row's result does not
    depend on the batch or on how many KV heads a rank holds."""
    return 1 if g == 1 else 4 if tc_pv(g, elem_bytes) else 2


def smem_bytes(g: int, d: int, k_block: int, elem_bytes: int, chunk: int,
               stages: int, win_blocks: int, v_rows: int) -> int:
    """Shared-memory bytes of ``csrc/sata_decode.cu``'s layout
    (``make_layout``), each region rounded up to 16 bytes."""
    rs = _round16(d * elem_bytes)            # a K/V row, 16-byte vectors
    # a K row in the ring: bf16 rows padded to the tensor cores' k-step
    # and 16 bytes more (ldmatrix without bank conflicts)
    rk = (-(-d * 2 // 32) * 32 + 16) if elem_bytes == 2 else rs
    tc = tc_pv(g, elem_bytes)
    rv = rk if tc else rs                    # a V row (ldmatrix: as K's)
    # PV row subsets on the CUDA cores; the tensor cores keep one sum
    nrs = 1 if tc else threads_for(g) // (rs // 16 * head_groups(g))
    wrows = win_blocks * k_block
    regions = [
        max(stages * chunk * rk,             # K ring, then the final
            nrs * g * (rs // elem_bytes) * 4),   # reduction of the subsets
        stages * chunk,                      # the ring's row flags
        v_rows * rv,                         # V rows
        # scores (a head's at an odd stride), selected, any head
        g * (wrows + 1) * 4, g * wrows, wrows,
        wrows * 2, -(-wrows // 32) * 4,      # packed rows, their offsets
        win_blocks * g * 4, win_blocks * g * 4, win_blocks * g * 4,
        g * 4, g * 4, g * 4, g * 4,          # m, l, thresholds, rescale
        PLAN_WIN * 4, PLAN_WIN * 4,          # plan: logical, physical block
        4,                                   # V rows packed
        (win_blocks + 1) * 4 if tc else 0,   # the blocks' packed rows
        16 * rk if tc else 0,                # q of the 16 heads
    ]
    return sum(_round16(x) for x in regions)


def launch_config(g: int, d: int, k_block: int,
                  dtype: torch.dtype) -> LaunchConfig:
    """The staging for one shape.  A chunk is as many whole k-blocks as
    fit CHUNK_BYTES of K (at most 256 rows), or the largest divisor
    of a k-block that does; a ring of RING_BYTES of chunks (2 to
    MAX_STAGES); V_BYTES of V rows at a time; and a window of as many
    k-blocks' scores as the rest of SMEM_MAX holds.  A row is split over
    ``cluster_for`` blocks; with the tensor cores' PV each is staged at
    half those sizes within SMEM_SPLIT, so that two blocks fit an SM.
    Raises ValueError,
    naming G, D and k_block, for a shape outside the kernel's limits or
    one no layout fits."""
    return _launch_config(g, d, k_block, dtype.itemsize)


@functools.cache
def _launch_config(g: int, d: int, k_block: int, es: int) -> LaunchConfig:
    if not (1 <= g <= MAX_G and 1 <= d <= MAX_D and 1 <= k_block <= MAX_BLOCK):
        raise ValueError(f"no decode kernel layout at G={g}, D={d}, "
                         f"k_block={k_block}: the kernel takes G <= {MAX_G}, "
                         f"D <= {MAX_D}, k_block <= {MAX_BLOCK}")
    div, limit = (2, SMEM_SPLIT) if tc_pv(g, es) else (1, SMEM_MAX)
    chunk_bytes, ring_bytes = CHUNK_BYTES // div, RING_BYTES // div
    rs = _round16(d * es)
    if k_block * rs <= chunk_bytes:
        chunk = k_block * max(1, min(chunk_bytes // (k_block * rs),
                                     256 // k_block))
    else:
        chunk = max(c for c in range(1, k_block + 1)
                    if k_block % c == 0 and c * rs <= chunk_bytes)
    stages = max(2, min(MAX_STAGES, ring_bytes // (chunk * rs)))
    blocks = max(1, chunk // k_block)        # k-blocks a window grows by
    rk = (-(-d * 2 // 32) * 32 + 16) if es == 2 else rs
    vr = max(1, V_BYTES // div // (rk if tc_pv(g, es) else rs))

    def size(wp):
        return smem_bytes(g, d, k_block, es, chunk, stages, wp, vr)

    while size(blocks) > limit and (stages > 2 or vr > 32):
        if vr > 32:
            vr //= 2
        else:
            stages -= 1
    if size(blocks) > limit:
        raise ValueError(f"no decode kernel layout fits {limit} bytes "
                         f"at G={g}, D={d}, k_block={k_block}")
    wp = blocks
    while size(wp + blocks) <= limit and (wp + blocks) * k_block \
            <= 32767 and wp + blocks <= PLAN_WIN:
        wp += blocks
    return LaunchConfig(chunk, stages, wp, vr, size(wp), cluster_for(g, es))


def copy_bytes(row_bytes: int, *ptrs: int) -> int:
    """The widest copy (16, 8, 4 or 2 bytes) that divides a row and the
    alignment of every base pointer: the kernel's asynchronous copies
    take 16, 8 or 4 bytes; 2 is a plain copy."""
    for n in (16, 8, 4):
        if row_bytes % n == 0 and all(p % n == 0 for p in ptrs):
            return n
    return 2


def sata_decode_attention_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, kv_indices: torch.Tensor,
                              kv_counts: torch.Tensor,
                              thresholds: torch.Tensor, pos: torch.Tensor,
                              *, k_block: int,
                              page_table: Optional[torch.Tensor] = None,
                              partial: bool = False, splits: int = 1):
    """Plain PyTorch version of the decode gather kernel: the reference's
    flash loop tile by tile, vectorized over (slot, KV head) rows.

    q: (B, KV, G, D); k/v: (B, S, KV, D) cache, or the pool
    (n_pages, page, KV, D) with ``page_table`` (B, max_pages) and
    page == k_block; kv_indices (B, KV, P) logical block ids; kv_counts
    (B, KV); thresholds (B, KV, G, 1) fp32; pos (B,).  Returns
    (B, KV, G, D) in q's dtype.  Both layouts gather the same values
    and run the same arithmetic, so they agree bitwise.

    ``partial`` (context-parallel decode, a rank's share of the keys):
    returns (out (B, KV, G, D) fp32, o / l not rounded; lse (B, KV, G,
    1) fp32, m + log(l), −inf where l == 0), for
    ``distributed.sharding.KeySplit.combine``.

    ``splits`` models the kernel's split of a row over a thread-block
    cluster (``launch_config(...).cluster``; tests and ``chip_smoke.py``
    only): share r of a row holds its plan entries [r·per, min(count,
    (r + 1)·per)), per = ⌈count / splits⌉, runs the flash loop on its
    own (p rounded against the share's own running max) and the shares
    combine in rank order: M the largest m of the shares with l > 0,
    y = Σ exp(m_r − M)·acc_r / Σ exp(m_r − M)·l_r, 0 where that is 0.
    ``splits=1`` is the unsplit function."""
    b, n_kv, g, d = q.shape
    p = kv_indices.shape[-1]
    if p == 0:
        if partial:
            return (torch.zeros(q.shape, dtype=torch.float32,
                                device=q.device),
                    torch.full((b, n_kv, g, 1), float("-inf"),
                               device=q.device))
        return torch.zeros_like(q)
    count = kv_counts.long().clamp(max=p)
    per = (count + splits - 1) // splits
    shares = []
    for r in range(splits):
        lo = torch.minimum(count, r * per)
        shares.append(_flash_share(q, k, v, kv_indices, lo,
                                   torch.minimum(count, lo + per),
                                   thresholds, pos, k_block=k_block,
                                   page_table=page_table))
    # the combine, in rank order; a share with l == 0 contributes nothing
    m, l, acc = (torch.stack(x) for x in zip(*shares))
    live = l > 0
    big = torch.where(live, m, float("-inf")).amax(dim=0)
    w = torch.where(live, torch.exp(m - big), 0.0)
    num = torch.zeros_like(acc[0])
    den = torch.zeros_like(l[0])
    for r in range(splits):
        num = num + w[r] * acc[r]
        den = den + w[r] * l[r]
    out = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    if partial:
        return out, torch.where(
            den > 0, big + torch.log(torch.where(den > 0, den, 1.0)),
            float("-inf"))
    return out.to(q.dtype)


def _flash_share(q, k, v, kv_indices, lo, hi, thresholds, pos, *,
                 k_block, page_table):
    """The flash loop over each row's plan entries [lo, hi): its running
    max m and sum l (B, KV, G, 1) and unnormalised output acc
    (B, KV, G, D), all fp32."""
    b, n_kv, g, d = q.shape
    scale = float(1.0 / np.sqrt(d))
    dev = q.device
    qf = q.float()
    thr = thresholds.float()
    acc = torch.zeros((b, n_kv, g, d), dtype=torch.float32, device=dev)
    m = torch.full((b, n_kv, g, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, n_kv, g, 1), dtype=torch.float32, device=dev)
    ti = torch.arange(k_block, device=dev)
    hi_ = torch.arange(n_kv, device=dev)[None, :, None]
    for j in range(int(lo.min()) if lo.numel() else 0,
                   int(hi.max()) if hi.numel() else 0):
        blk = kv_indices[..., j].long()                       # (B, KV)
        kpos = blk[..., None] * k_block + ti                  # (B, KV, kb)
        if page_table is None:
            bi = torch.arange(b, device=dev)[:, None, None]
            kt, vt = k[bi, kpos, hi_], v[bi, kpos, hi_]       # (B,KV,kb,D)
        else:
            phys = torch.gather(page_table.long(), 1, blk)[..., None]
            kt, vt = k[phys, ti, hi_], v[phys, ti, hi_]
        s = torch.einsum("bkgd,bktd->bkgt", qf, kt.float()) * scale
        mask = bisect_select(s, thr) & (kpos <= pos[:, None, None])[:, :, None]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # the finite sentinel gives exp(0) = 1 on a row masked so far:
        # zero masked entries explicitly so such rows keep l == 0
        pe = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + pe.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum(
            "bkgt,bktd->bkgd", pe.to(v.dtype).float(), vt.float())
        live = ((j >= lo) & (j < hi))[..., None, None]       # the share's
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    return m, l, acc


# the C interface of csrc/sata_decode.cu::sata_decode_attention: 9
# pointers, 15 ints, the stream; ``sata_decode_attention_partial``'s
# takes the lse pointer after the output
ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
PARTIAL_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 15 + \
    [ctypes.c_void_p]


@functools.cache
def _launcher(partial: bool = False):
    from repro_torch.kernels import build
    lib = build.load("sata_decode")
    fn = lib.sata_decode_attention_partial if partial \
        else lib.sata_decode_attention
    fn.argtypes = PARTIAL_ARGTYPES if partial else ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(owner, q, k, v, page_table, kv_indices, kv_counts, thresholds,
            pos, *, k_block: int, nkb: int, partial: bool = False):
    """Validate, allocate the output (and, ``partial``, the fp32 output
    and lse of the partial mode), launch on the current stream and
    count the launch on ``owner.launches``.  Raises on anything the
    kernel does not take, and when the launch reports an error."""
    b, n_kv, g, d = q.shape
    p = kv_indices.shape[-1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA decode kernel needs CUDA tensors, got "
                         f"q on {dev}")
    for name, t in (("k", k), ("v", v), ("kv_indices", kv_indices),
                    ("kv_counts", kv_counts), ("thresholds", thresholds),
                    ("pos", pos)) + ((("page_table", page_table),)
                                     if page_table is not None else ()):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        f"bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}/{k.dtype}/{v.dtype}")
    if thresholds.dtype != torch.float32:
        raise TypeError(f"thresholds must be float32, got {thresholds.dtype}")
    if kv_indices.shape != (b, n_kv, p) or kv_counts.shape != (b, n_kv) \
            or thresholds.shape != (b, n_kv, g, 1) or pos.shape != (b,):
        raise ValueError(f"plan shapes {tuple(kv_indices.shape)}, "
                         f"{tuple(kv_counts.shape)}, "
                         f"{tuple(thresholds.shape)}, {tuple(pos.shape)} "
                         f"do not match q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("thresholds", thresholds)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    cfg = launch_config(g, d, k_block, q.dtype)     # raises past the limits
    out = torch.empty(q.shape, dtype=torch.float32, device=dev) if partial \
        else torch.empty_like(q)
    # the kernel writes every lse (no fill kernel ahead of its launch)
    lse = torch.empty((b, n_kv, g, 1), device=dev) if partial else None
    if p == 0 or b * n_kv == 0:
        return (out.zero_(), lse.fill_(float("-inf"))) if partial \
            else out.zero_()
    i32 = [t.to(torch.int32).contiguous()
           for t in (kv_indices, kv_counts, pos)]
    tbl = None if page_table is None else \
        page_table.to(torch.int32).contiguous()
    err = _launcher(partial)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if tbl is None else tbl.data_ptr(),
        i32[0].data_ptr(), i32[1].data_ptr(), thresholds.data_ptr(),
        i32[2].data_ptr(), out.data_ptr(),
        *((lse.data_ptr(),) if partial else ()), b, n_kv, g, d, p, k_block,
        nkb,
        1 if q.dtype == torch.bfloat16 else 0, cfg.chunk, cfg.stages,
        cfg.win_blocks, cfg.v_rows, cfg.smem_bytes,
        copy_bytes(d * q.element_size(), k.data_ptr(), v.data_ptr()),
        cfg.cluster, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sata_decode kernel launch failed: cudaError {err}")
    owner.launches += 1
    return (out, lse) if partial else out


def sata_decode_attention_kernel(q, k, v, kv_indices, kv_counts, thresholds,
                                 pos, *, k_block: int = 128,
                                 partial: bool = False):
    """CUDA kernel over the contiguous cache: q (B, KV, G, D); k/v
    (B, S, KV, D) with S % k_block == 0; plan as the plain version;
    ``partial`` as the plain version's (the kernel's partial mode)."""
    b, s = k.shape[:2]
    if k.shape != (b, s, q.shape[1], q.shape[3]) or v.shape != k.shape \
            or s % k_block:
        raise ValueError(f"cache {tuple(k.shape)} / {tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)} at k_block={k_block}")
    return _launch(sata_decode_attention_kernel, q, k, v, None, kv_indices,
                   kv_counts, thresholds, pos, k_block=k_block,
                   nkb=s // k_block, partial=partial)


def sata_decode_attention_paged_kernel(q, k_pages, v_pages, page_table,
                                       kv_indices, kv_counts, thresholds,
                                       pos) -> torch.Tensor:
    """CUDA kernel over the page pool: k_pages/v_pages
    (n_pages, page, KV, D); page_table (B, max_pages); kv_indices hold
    LOGICAL page ids.  The k-block edge IS the page size."""
    page = k_pages.shape[1]
    if k_pages.shape[2:] != (q.shape[1], q.shape[3]) \
            or v_pages.shape != k_pages.shape \
            or page_table.dim() != 2 or page_table.shape[0] != q.shape[0]:
        raise ValueError(f"pool {tuple(k_pages.shape)} / table "
                         f"{tuple(page_table.shape)} do not match q "
                         f"{tuple(q.shape)}")
    return _launch(sata_decode_attention_paged_kernel, q, k_pages, v_pages,
                   page_table, kv_indices, kv_counts, thresholds, pos,
                   k_block=page, nkb=page_table.shape[1])


sata_decode_attention_kernel.launches = 0
sata_decode_attention_paged_kernel.launches = 0
