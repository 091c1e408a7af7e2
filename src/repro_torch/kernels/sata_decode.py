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
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.blockmap import bisect_select
from repro_torch.core.selection import NEG_INF

MAX_G, MAX_D, MAX_BLOCK = 8, 128, 128     # csrc/sata_decode.cu limits


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
# pointers, 8 ints, the stream
ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


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
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if tbl is None else tbl.data_ptr(),
        i32[0].data_ptr(), i32[1].data_ptr(), thresholds.data_ptr(),
        i32[2].data_ptr(), out.data_ptr(), b, n_kv, g, d, p, k_block, nkb,
        1 if q.dtype == torch.bfloat16 else 0,
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
