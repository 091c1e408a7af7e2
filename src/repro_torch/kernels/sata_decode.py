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
zeros.

``launch_config`` picks the kernel's staging for a shape (the K rows a
ring stage holds, the ring's depth, the k-blocks a softmax window holds,
the V rows copied at once) and the shared memory that takes.

``sata_decode_attention_ref`` is the same function as a per-tile loop in
plain PyTorch, with the kernel's predicate, finite sentinel and p
rounding.  The CUDA wrappers launch the kernel for CUDA tensors and
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

MAX_G, MAX_D, MAX_BLOCK = 8, 128, 128     # csrc/sata_decode.cu limits
# csrc/sata_decode.cu's plan window and ring limit, and the shared memory
# a block may use on an H100 (sm_90: 227 KB)
PLAN_WIN, MAX_STAGES = 1024, 8
SMEM_MAX = 232_448
CHUNK_BYTES = 49152         # K bytes a ring stage holds, at most
RING_BYTES = 98304          # K bytes the ring holds
V_BYTES = 49152             # V bytes a window's PV product takes at once


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """How the decode kernel stages its work: ``chunk`` K rows per ring
    stage (whole k-blocks, or a divisor of one), ``stages`` ring stages,
    a window of up to ``win_blocks`` k-blocks' scores between two
    softmax steps, its selected V rows ``v_rows`` at a time, and the
    dynamic shared memory that layout takes."""
    chunk: int
    stages: int
    win_blocks: int
    v_rows: int
    smem_bytes: int


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def threads_for(g: int) -> int:
    """csrc/sata_decode.cu's block size for G grouped heads."""
    return 512 if g <= 4 else 256


def smem_bytes(g: int, d: int, k_block: int, elem_bytes: int, chunk: int,
               stages: int, win_blocks: int, v_rows: int) -> int:
    """Shared-memory bytes of ``csrc/sata_decode.cu``'s layout
    (``make_layout``), each region rounded up to 16 bytes."""
    rs = _round16(d * elem_bytes)            # a K/V row, 16-byte vectors
    # a K row in the ring: bf16 rows padded to the tensor cores' k-step
    # and 16 bytes more (ldmatrix without bank conflicts)
    rk = (-(-d * 2 // 32) * 32 + 16) if elem_bytes == 2 else rs
    nrs = threads_for(g) // (rs // 16)       # PV row subsets
    wrows = win_blocks * k_block
    regions = [
        max(stages * chunk * rk,             # K ring, then the final
            nrs * g * (rs // elem_bytes) * 4),   # reduction of the subsets
        stages * chunk,                      # the ring's row flags
        v_rows * rs,                         # V rows
        g * wrows * 4, g * wrows, wrows,     # scores, selected, any head
        wrows * 2, -(-wrows // 32) * 4,      # packed rows, their offsets
        win_blocks * g * 4, win_blocks * g * 4, win_blocks * g * 4,
        g * 4, g * 4, g * 4, g * 4,          # m, l, thresholds, rescale
        PLAN_WIN * 4, PLAN_WIN * 4,          # plan: logical, physical block
        4,                                   # V rows packed
    ]
    return sum(_round16(x) for x in regions)


def launch_config(g: int, d: int, k_block: int,
                  dtype: torch.dtype) -> LaunchConfig:
    """The staging for one shape.  A chunk is as many whole k-blocks as
    fit CHUNK_BYTES of K (at most 256 rows), or the largest divisor
    of a k-block that does; a ring of RING_BYTES of chunks (2 to
    MAX_STAGES); V_BYTES of V rows at a time; and a window of as many
    k-blocks' scores as the rest of SMEM_MAX holds."""
    return _launch_config(g, d, k_block, dtype.itemsize)


@functools.cache
def _launch_config(g: int, d: int, k_block: int, es: int) -> LaunchConfig:
    rs = _round16(d * es)
    if k_block * rs <= CHUNK_BYTES:
        chunk = k_block * max(1, min(CHUNK_BYTES // (k_block * rs),
                                     256 // k_block))
    else:
        chunk = max(c for c in range(1, k_block + 1)
                    if k_block % c == 0 and c * rs <= CHUNK_BYTES)
    stages = max(2, min(MAX_STAGES, RING_BYTES // (chunk * rs)))
    blocks = max(1, chunk // k_block)        # k-blocks a window grows by
    vr = max(1, V_BYTES // rs)

    def size(wp):
        return smem_bytes(g, d, k_block, es, chunk, stages, wp, vr)

    while size(blocks) > SMEM_MAX and (stages > 2 or vr > 32):
        if vr > 32:
            vr //= 2
        else:
            stages -= 1
    if size(blocks) > SMEM_MAX:
        raise ValueError(f"no decode kernel layout fits {SMEM_MAX} bytes "
                         f"at G={g}, D={d}, k_block={k_block}")
    wp = blocks
    while size(wp + blocks) <= SMEM_MAX and (wp + blocks) * k_block \
            <= 32767 and wp + blocks <= PLAN_WIN:
        wp += blocks
    return LaunchConfig(chunk, stages, wp, vr, size(wp))


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
                              page_table: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of the decode gather kernel: the reference's
    flash loop tile by tile, vectorized over (slot, KV head) rows.

    q: (B, KV, G, D); k/v: (B, S, KV, D) cache, or the pool
    (n_pages, page, KV, D) with ``page_table`` (B, max_pages) and
    page == k_block; kv_indices (B, KV, P) logical block ids; kv_counts
    (B, KV); thresholds (B, KV, G, 1) fp32; pos (B,).  Returns
    (B, KV, G, D) in q's dtype.  Both layouts gather the same values
    and run the same arithmetic, so they agree bitwise."""
    b, n_kv, g, d = q.shape
    p = kv_indices.shape[-1]
    if p == 0:
        return torch.zeros_like(q)
    scale = float(1.0 / np.sqrt(d))
    dev = q.device
    qf = q.float()
    thr = thresholds.float()
    acc = torch.zeros((b, n_kv, g, d), dtype=torch.float32, device=dev)
    m = torch.full((b, n_kv, g, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, n_kv, g, 1), dtype=torch.float32, device=dev)
    ti = torch.arange(k_block, device=dev)
    hi = torch.arange(n_kv, device=dev)[None, :, None]
    for j in range(p):
        blk = kv_indices[..., j].long()                       # (B, KV)
        kpos = blk[..., None] * k_block + ti                  # (B, KV, kb)
        if page_table is None:
            bi = torch.arange(b, device=dev)[:, None, None]
            kt, vt = k[bi, kpos, hi], v[bi, kpos, hi]         # (B,KV,kb,D)
        else:
            phys = torch.gather(page_table.long(), 1, blk)[..., None]
            kt, vt = k[phys, ti, hi], v[phys, ti, hi]
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
        live = (j < kv_counts)[..., None, None]               # padding: skip
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    out = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
    return out.to(q.dtype)


# the C interface of csrc/sata_decode.cu::sata_decode_attention: 9
# pointers, 14 ints, the stream
ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 14 + [ctypes.c_void_p]


@functools.cache
def _launcher():
    from repro_torch.kernels import build
    fn = build.load("sata_decode").sata_decode_attention
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(owner, q, k, v, page_table, kv_indices, kv_counts, thresholds,
            pos, *, k_block: int, nkb: int) -> torch.Tensor:
    """Validate, allocate the output, launch on the current stream and
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
    if not (g <= MAX_G and d <= MAX_D and 1 <= k_block <= MAX_BLOCK):
        raise ValueError(f"kernel limits: G <= {MAX_G}, D <= {MAX_D}, "
                         f"k_block <= {MAX_BLOCK}; got G={g}, D={d}, "
                         f"k_block={k_block}")
    if kv_indices.shape != (b, n_kv, p) or kv_counts.shape != (b, n_kv) \
            or thresholds.shape != (b, n_kv, g, 1) or pos.shape != (b,):
        raise ValueError(f"plan shapes {tuple(kv_indices.shape)}, "
                         f"{tuple(kv_counts.shape)}, "
                         f"{tuple(thresholds.shape)}, {tuple(pos.shape)} "
                         f"do not match q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("thresholds", thresholds)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(q)
    if p == 0 or b * n_kv == 0:
        return out.zero_()
    i32 = [t.to(torch.int32).contiguous()
           for t in (kv_indices, kv_counts, pos)]
    tbl = None if page_table is None else \
        page_table.to(torch.int32).contiguous()
    cfg = launch_config(g, d, k_block, q.dtype)
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if tbl is None else tbl.data_ptr(),
        i32[0].data_ptr(), i32[1].data_ptr(), thresholds.data_ptr(),
        i32[2].data_ptr(), out.data_ptr(), b, n_kv, g, d, p, k_block, nkb,
        1 if q.dtype == torch.bfloat16 else 0, cfg.chunk, cfg.stages,
        cfg.win_blocks, cfg.v_rows, cfg.smem_bytes,
        copy_bytes(d * q.element_size(), k.data_ptr(), v.data_ptr()),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sata_decode kernel launch failed: cudaError {err}")
    owner.launches += 1
    return out


def sata_decode_attention_kernel(q, k, v, kv_indices, kv_counts, thresholds,
                                 pos, *, k_block: int = 128) -> torch.Tensor:
    """CUDA kernel over the contiguous cache: q (B, KV, G, D); k/v
    (B, S, KV, D) with S % k_block == 0; plan as the plain version."""
    b, s = k.shape[:2]
    if k.shape != (b, s, q.shape[1], q.shape[3]) or v.shape != k.shape \
            or s % k_block:
        raise ValueError(f"cache {tuple(k.shape)} / {tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)} at k_block={k_block}")
    return _launch(sata_decode_attention_kernel, q, k, v, None, kv_indices,
                   kv_counts, thresholds, pos, k_block=k_block,
                   nkb=s // k_block)


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
