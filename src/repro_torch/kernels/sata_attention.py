"""SATA block-sparse flash attention — the hand-written CUDA kernel for
Hopper (``csrc/sata_attention.cu``), its plain PyTorch versions, and the
wrappers.

Replaces ``repro/kernels/sata_attention.py``'s two Pallas kernels:
``sata_block_attention_compact`` (the compacted grid: each (bh, q-block)
row walks its ascending list of occupied k-blocks, ``kv_indices[...,
:kv_counts]``) and ``sata_block_attention`` (the dense-grid baseline:
every k-block, computed only where ``block_map`` is set).  One CUDA body
serves both, visiting the occupied tiles in the same ascending order,
so the two agree bitwise on the same plan.

Selection, one of: ``thresholds`` (BH, Sq, 1) fp32 — the tile mask is
re-derived as ``bf16(s) >= bf16(thr)`` and, with ``causal``, AND-ed with
``k_pos <= q_pos``; ``mask`` (BH, Sq, Sk) — an element mask that carries
causality itself; or neither (block mode: every key of an occupied tile,
gated by positions when ``causal``).

The plain versions (``*_ref``) are the same function as a per-tile loop
in PyTorch with the kernel's predicate, finite sentinel, p rounding and
the CUDA-core body's dot-product order (fp32, and bf16 off the 16-grid),
so there both select the same keys.  bf16 on the 16-grid runs on the
tensor cores, which sum each score in their own order; that body
recomputes, in the plain version's order, every score within
``admitted_window``'s bound of its row's admission edge, so it admits the
same keys too, and the checks hold its counts to that window.  The CUDA wrappers launch for
CUDA tensors and raise on anything else; ``kernels.ops`` picks a plain
version only for CPU tensors.  Each CUDA wrapper counts its launches in
``<wrapper>.launches``.  Both take an optional ``admitted`` (BH, Sq)
int32 tensor that receives each row's count of admitted keys, so a
check can hold the kernel's selection to the plain version's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.blockmap import bisect_select
from repro_torch.core.selection import NEG_INF

MAX_D, MAX_BLOCK = 128, 128          # csrc/sata_attention.cu limits


def _scores(qt: torch.Tensor, kt: torch.Tensor) -> torch.Tensor:
    """q·k over the last dim in the kernel's order: one product then one
    add per element of D, d = 0, 1, … (each rounded to fp32; a bf16
    operand's product is exact).  qt (..., Q, D), kt (..., K, D) →
    (..., Q, K) fp32."""
    q32, k32 = qt.float(), kt.float()
    s = torch.zeros(q32.shape[:-1] + (k32.shape[-2],), dtype=torch.float32,
                    device=q32.device)
    for d in range(q32.shape[-1]):
        s = s + q32[..., :, d, None] * k32[..., None, :, d]
    return s


def _flash_plain(q, k, v, kblk, live, *, q_block, k_block, mask=None,
                 thresholds=None, q_pos=None, k_pos=None, admitted=None):
    """The flash loop of both kernels, tile by tile, vectorized over the
    (bh, q-block) rows.  kblk (BH, nqb, J) is the k-block each row visits
    at step j, live (BH, nqb, J) whether it visits it at all."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    nqb, nkb = sq // q_block, sk // k_block
    dev = q.device
    scale = float(1.0 / np.sqrt(d))
    qt = q.reshape(bh, nqb, q_block, d)
    kt_all = k.reshape(bh, nkb, k_block, d)
    vt_all = v.reshape(bh, nkb, k_block, d)
    bi = torch.arange(bh, device=dev)[:, None]
    ni = torch.arange(nqb, device=dev)[None, :]
    thr = None if thresholds is None else \
        thresholds.float().reshape(bh, nqb, q_block, 1)
    qp = None if q_pos is None else q_pos.reshape(bh, nqb, q_block, 1)
    kp_all = None if k_pos is None else k_pos.reshape(bh, nkb, 1, k_block)
    mask_t = None if mask is None else \
        mask.bool().reshape(bh, nqb, q_block, nkb, k_block).transpose(2, 3)
    acc = torch.zeros((bh, nqb, q_block, d), dtype=torch.float32, device=dev)
    m = torch.full((bh, nqb, q_block, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    n_adm = torch.zeros((bh, nqb, q_block), dtype=torch.int32, device=dev)
    for j in range(kblk.shape[-1]):
        blk = kblk[..., j].long()                               # (BH, nqb)
        s = _scores(qt, kt_all[bi, blk]) * scale                # (BH,nqb,qb,kb)
        if mask_t is not None:
            sel = mask_t[bi, ni, blk]
        else:
            sel = torch.ones_like(s, dtype=torch.bool)
            if thr is not None:
                sel = bisect_select(s, thr)
            if qp is not None:
                sel = sel & (kp_all[bi, blk] <= qp)
        s = torch.where(sel, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # the finite sentinel gives exp(0) = 1 on a row masked so far:
        # zero masked entries explicitly so such rows keep l == 0
        pe = torch.where(sel, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + pe.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum(
            "bnqk,bnkd->bnqd", pe.to(v.dtype).float(),
            vt_all[bi, blk].float())
        on = live[..., j][..., None, None]                      # skip: keep
        m = torch.where(on, m_new, m)
        l = torch.where(on, l_new, l)
        acc = torch.where(on, acc_new, acc)
        n_adm += torch.where(on[..., 0], sel.sum(-1, dtype=torch.int32), 0)
    if admitted is not None:
        admitted.copy_(n_adm.reshape(bh, sq))
    out = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
    return out.to(q.dtype).reshape(bh, sq, d)


def _check_operands(q, k, v, mask, thresholds, q_pos, k_pos, *, causal,
                    q_block, k_block):
    """The reference's argument checks, raised; returns the operands the
    kernel reads (positions only where they gate)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, d) or v.shape != k.shape:
        raise ValueError(f"q/k/v shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match")
    if sq % q_block or sk % k_block:
        raise ValueError(f"S must tile by the block edge: {(sq, sk)} vs "
                         f"{(q_block, k_block)}")
    if mask is not None and thresholds is not None:
        raise ValueError("mask and thresholds are mutually exclusive "
                         "selection modes")
    if mask is not None and mask.shape != (bh, sq, sk):
        raise ValueError(f"mask shape {tuple(mask.shape)} != {(bh, sq, sk)}")
    if thresholds is not None and thresholds.shape != (bh, sq, 1):
        raise ValueError(f"thresholds shape {tuple(thresholds.shape)} != "
                         f"{(bh, sq, 1)}")
    use_pos = causal and mask is None
    if use_pos:
        if q_pos is None or k_pos is None:
            raise ValueError("causal threshold/block mode needs q_pos/k_pos")
        if q_pos.shape != (bh, sq, 1) or k_pos.shape != (bh, sk, 1):
            raise ValueError(f"position shapes {tuple(q_pos.shape)}, "
                             f"{tuple(k_pos.shape)} != {(bh, sq, 1)}, "
                             f"{(bh, sk, 1)}")
    return (q_pos, k_pos) if use_pos else (None, None)


def sata_block_attention_compact_ref(
        q, k, v, kv_indices, kv_counts, mask=None, thresholds=None,
        q_pos=None, k_pos=None, *, causal: bool = False, q_block: int = 128,
        k_block: int = 128, admitted: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain version of the compacted-grid kernel.  q (BH, Sq, D); k/v
    (BH, Sk, D); kv_indices (BH, nqb, P) / kv_counts (BH, nqb) from
    ``compact_kv_plan``; selection as the module docstring.  Returns
    (BH, Sq, D) in q's dtype; ``P == 0`` gives zeros."""
    q_pos, k_pos = _check_operands(q, k, v, mask, thresholds, q_pos, k_pos,
                                   causal=causal, q_block=q_block,
                                   k_block=k_block)
    p = kv_indices.shape[-1]
    if p == 0:
        if admitted is not None:
            admitted.zero_()
        return torch.zeros_like(q)
    live = torch.arange(p, device=q.device) < kv_counts[..., None]
    return _flash_plain(q, k, v, kv_indices, live, q_block=q_block,
                        k_block=k_block, mask=mask, thresholds=thresholds,
                        q_pos=q_pos, k_pos=k_pos, admitted=admitted)


def sata_block_attention_ref(q, k, v, block_map, mask=None, *,
                             q_block: int = 128, k_block: int = 128,
                             admitted: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain version of the dense-grid kernel: every k-block in order,
    computed where ``block_map`` (BH, nqb, nkb) is set, optional element
    mask (BH, Sq, Sk)."""
    _check_operands(q, k, v, mask, None, None, None, causal=False,
                    q_block=q_block, k_block=k_block)
    bh, nqb, nkb = block_map.shape
    kblk = torch.arange(nkb, device=q.device).expand(bh, nqb, nkb)
    return _flash_plain(q, k, v, kblk, block_map.bool(), q_block=q_block,
                        k_block=k_block, mask=mask, admitted=admitted)


# half-width of admitted_window's score window, in units of
# (D + 16) · 2^-24 · Σ_d |q_d·k_d|
WINDOW_SLACK = 4.0


def admitted_window(q, k, kv_indices, kv_counts, mask=None, thresholds=None,
                    q_pos=None, k_pos=None, *, causal: bool = False,
                    q_block: int = 128, k_block: int = 128,
                    slack: float = WINDOW_SLACK):
    """The range of admitted-key counts per row that a kernel summing each
    score's products in another order may give (the tensor-core body
    recomputes the scores inside this bound in the plain version's order,
    with |q|·|k| in place of Σ_d |q_d·k_d|, so it gives the plain count).  Returns (lo, hi), int32
    (BH, Sq): the keys the compacted-grid plain version admits when every
    dot product q·k of the planned tiles is moved down (lo), or up (hi),
    by ε = slack · (D + 16) · 2^-24 · Σ_d |q_d·k_d| before the scale and
    the predicate.  Arguments as ``sata_block_attention_compact_ref``.

    Why that ε: the products of bf16 operands are exact in fp32, so two
    kernels differ only in how they sum them.  The plain version rounds D
    times in sequence, each time by at most 2^-24 · Σ|q_d·k_d|; the
    tensor cores align each k16 step's 16 products and the accumulator to
    the largest and truncate, losing under 2 ulps (2^-23 relative) of each
    of the 17 addends, D / 16 times.  Together that is under
    3.2 · D · 2^-24 · Σ|q_d·k_d|, inside ε at slack 4.  The predicate
    ``bf16(s) >= bf16(thr)`` is monotone in s and fl(x · scale) in x, so
    a kernel whose dot products lie within ε admits between lo and hi
    keys.  An fp32 predicate (``s >= bf16(thr)``) moves admission by up
    to half a bf16 ulp, 2^-9 relative, orders of magnitude wider.  Mask
    and block mode, and ``slack=0``, give the plain version's counts.
    Used by the checks, never by the main path."""
    q_pos, k_pos = _check_operands(q, k, k, mask, thresholds, q_pos, k_pos,
                                   causal=causal, q_block=q_block,
                                   k_block=k_block)
    bh, sq, d = q.shape
    sk = k.shape[1]
    nqb, nkb = sq // q_block, sk // k_block
    dev = q.device
    lo = torch.zeros((bh, nqb, q_block), dtype=torch.int32, device=dev)
    hi = torch.zeros_like(lo)
    scale = float(1.0 / np.sqrt(d))
    eps_unit = slack * (d + 16) * 2.0 ** -24
    qt = q.reshape(bh, nqb, q_block, d)
    kt_all = k.reshape(bh, nkb, k_block, d)
    bi = torch.arange(bh, device=dev)[:, None]
    ni = torch.arange(nqb, device=dev)[None, :]
    thr = None if thresholds is None else \
        thresholds.float().reshape(bh, nqb, q_block, 1)
    qp = None if q_pos is None else q_pos.reshape(bh, nqb, q_block, 1)
    kp_all = None if k_pos is None else k_pos.reshape(bh, nkb, 1, k_block)
    mask_t = None if mask is None else \
        mask.bool().reshape(bh, nqb, q_block, nkb, k_block).transpose(2, 3)
    n_slots = kv_indices.shape[-1]
    live = torch.arange(n_slots, device=dev) < kv_counts[..., None]
    for j in range(n_slots):
        blk = kv_indices[..., j].long()
        kt = kt_all[bi, blk]
        if mask_t is not None:
            sel_lo = sel_hi = mask_t[bi, ni, blk]
        elif thr is not None:
            dot = _scores(qt, kt)
            eps = eps_unit * torch.einsum("bnqd,bnkd->bnqk",
                                          qt.float().abs(), kt.float().abs())
            sel_lo = bisect_select((dot - eps) * scale, thr)
            sel_hi = bisect_select((dot + eps) * scale, thr)
        else:
            sel_lo = sel_hi = torch.ones(qt.shape[:3] + (k_block,),
                                         dtype=torch.bool, device=dev)
        if qp is not None:
            gate = kp_all[bi, blk] <= qp
            sel_lo, sel_hi = sel_lo & gate, sel_hi & gate
        on = live[..., j][..., None]
        lo += torch.where(on, sel_lo.sum(-1, dtype=torch.int32), 0)
        hi += torch.where(on, sel_hi.sum(-1, dtype=torch.int32), 0)
    return lo.reshape(bh, sq), hi.reshape(bh, sq)


# the C interface of csrc/sata_attention.cu::sata_block_attention: 12
# pointers, 8 ints, the stream
ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


@functools.cache
def _launcher():
    from repro_torch.kernels import build
    fn = build.load("sata_attention").sata_block_attention
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _i32(t: torch.Tensor, shape) -> torch.Tensor:
    return t.to(torch.int32).reshape(shape).contiguous()


def _u8(t: torch.Tensor) -> torch.Tensor:
    """A bool/int8/uint8 tensor as bytes whose nonzero means set."""
    t = t.contiguous()
    if t.dtype in (torch.bool, torch.int8):
        return t.view(torch.uint8)
    return (t != 0).view(torch.uint8)


def _launch(owner, q, k, v, *, kv_indices=None, kv_counts=None,
            block_map=None, mask=None, thresholds=None, q_pos=None,
            k_pos=None, q_block, k_block, admitted=None) -> torch.Tensor:
    """Validate what the kernel takes, allocate the output, launch on the
    current stream and count the launch on ``owner.launches``."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA SATA attention kernel needs CUDA "
                         f"tensors, got q on {dev}")
    for name, t in (("k", k), ("v", v), ("kv_indices", kv_indices),
                    ("kv_counts", kv_counts), ("block_map", block_map),
                    ("mask", mask), ("thresholds", thresholds),
                    ("q_pos", q_pos), ("k_pos", k_pos),
                    ("admitted", admitted)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        f"bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}/{k.dtype}/{v.dtype}")
    if thresholds is not None and thresholds.dtype != torch.float32:
        raise TypeError(f"thresholds must be float32, got {thresholds.dtype}")
    if not (d <= MAX_D and 1 <= q_block <= MAX_BLOCK
            and 1 <= k_block <= MAX_BLOCK):
        raise ValueError(f"kernel limits: D <= {MAX_D}, q_block and k_block "
                         f"<= {MAX_BLOCK}; got D={d}, q_block={q_block}, "
                         f"k_block={k_block}")
    if admitted is not None and (admitted.shape != (bh, sq)
                                 or admitted.dtype != torch.int32
                                 or not admitted.is_contiguous()):
        raise ValueError(f"admitted must be a contiguous int32 {(bh, sq)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nqb = sq // q_block
    if block_map is None:
        p = kv_indices.shape[-1]
        if kv_indices.shape[:2] != (bh, nqb) or kv_counts.shape != (bh, nqb):
            raise ValueError(f"plan shapes {tuple(kv_indices.shape)}, "
                             f"{tuple(kv_counts.shape)} do not match "
                             f"{(bh, nqb)}")
        plan = (_i32(kv_indices, (bh, nqb, p)), _i32(kv_counts, (bh, nqb)))
    else:
        p = 0
        if block_map.shape != (bh, nqb, sk // k_block):
            raise ValueError(f"block_map shape {tuple(block_map.shape)} != "
                             f"{(bh, nqb, sk // k_block)}")
        plan = (None, None)
    out = torch.empty_like(q)
    if block_map is None and p == 0:
        # an empty plan visits nothing: zeros, as the reference returns
        if admitted is not None:
            admitted.zero_()
        return out.zero_()
    ops = dict(bm=None if block_map is None else _u8(block_map),
               mask=None if mask is None else _u8(mask),
               thr=None if thresholds is None
               else thresholds.reshape(bh, sq).contiguous(),
               qp=None if q_pos is None else _i32(q_pos, (bh, sq)),
               kp=None if k_pos is None else _i32(k_pos, (bh, sk)))
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(plan[0]),
        _ptr(plan[1]), _ptr(ops["bm"]), _ptr(ops["mask"]), _ptr(ops["thr"]),
        _ptr(ops["qp"]), _ptr(ops["kp"]), out.data_ptr(), _ptr(admitted),
        bh, sq, sk, d, p, q_block, k_block,
        1 if q.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sata_attention kernel launch failed: "
                           f"cudaError {err}")
    owner.launches += 1
    return out


def sata_block_attention_compact(
        q, k, v, kv_indices, kv_counts, mask=None, thresholds=None,
        q_pos=None, k_pos=None, *, causal: bool = False, q_block: int = 128,
        k_block: int = 128, admitted: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """CUDA compacted-grid kernel; arguments as the plain version."""
    q_pos, k_pos = _check_operands(q, k, v, mask, thresholds, q_pos, k_pos,
                                   causal=causal, q_block=q_block,
                                   k_block=k_block)
    return _launch(sata_block_attention_compact, q, k, v,
                   kv_indices=kv_indices, kv_counts=kv_counts, mask=mask,
                   thresholds=thresholds, q_pos=q_pos, k_pos=k_pos,
                   q_block=q_block, k_block=k_block, admitted=admitted)


def sata_block_attention(q, k, v, block_map, mask=None, *,
                         q_block: int = 128, k_block: int = 128,
                         admitted: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """CUDA dense-grid kernel; arguments as the plain version."""
    _check_operands(q, k, v, mask, None, None, None, causal=False,
                    q_block=q_block, k_block=k_block)
    return _launch(sata_block_attention, q, k, v, block_map=block_map,
                   mask=mask, q_block=q_block, k_block=k_block,
                   admitted=admitted)


sata_block_attention_compact.launches = 0
sata_block_attention.launches = 0
