"""Public kernel entry points of the port — ``repro.kernels.ops``'s
decode half.

Dispatch follows the device of the tensors: CPU tensors take the plain
PyTorch version, CUDA tensors take the hand-written kernel, and a build
or launch failure raises.  Nothing falls back.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.sata_decode import (
    sata_decode_attention_kernel, sata_decode_attention_paged_kernel,
    sata_decode_attention_ref)


def sata_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_indices: torch.Tensor, kv_counts: torch.Tensor,
                          thresholds: torch.Tensor, pos: torch.Tensor, *,
                          k_block: int = 128,
                          page_table: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Decode-path selective attention: fetch only the planned k-blocks
    of the KV cache for one generated token per slot.

    q: (B, KV, G, D) — the G = H//KV query heads grouped per KV head;
    k/v: (B, S, KV, D) serving cache; kv_indices/kv_counts: the per-slot
    plan from ``core.decode_plan``; thresholds: (B, KV, G, 1) fp32;
    pos: (B,).  Returns (B, KV, G, D).  With ``page_table``
    (B, max_pages) given, k/v are the pool (n_pages, page, KV, D) and
    page must equal ``k_block``."""
    if page_table is not None:
        # the plan's logical block edge must BE the page size, or the
        # kernel would dereference block-granular indices as page ids
        assert k.shape[1] == k_block, (
            f"paged decode needs k_block == page size "
            f"({k_block} != {k.shape[1]})")
    if q.device.type == "cpu":
        return sata_decode_attention_ref(q, k, v, kv_indices, kv_counts,
                                         thresholds, pos, k_block=k_block,
                                         page_table=page_table)
    if page_table is not None:
        return sata_decode_attention_paged_kernel(
            q, k, v, page_table, kv_indices, kv_counts, thresholds, pos)
    return sata_decode_attention_kernel(q, k, v, kv_indices, kv_counts,
                                        thresholds, pos, k_block=k_block)


def decode_fetch_stats(kv_counts, pos, *, k_block: int, d: int,
                       dtype_bytes: int = 4, replan=None,
                       nkb: Optional[int] = None) -> Dict:
    """Per-step K/V fetch accounting for the decode route (numpy, a copy
    of the reference's fp32 / exact-re-plan accounting).  kv_counts:
    (..., B, KV) int; pos: (B,) per-slot positions.

    Kernel side: dense decode streams every valid block of the prefix
    per (slot, kv head); the planned kernel fetches ``kv_counts`` tiles.
    Plan side (``replan`` given — the fraction of this step's layer
    plans that ran the full re-plan, a scalar or a (B,) vector): an
    exact full re-plan streams all valid cached K; an incremental step
    reads the fp32 block summaries (``nkb`` sizes them) plus the planned
    blocks' keys."""
    cnt = np.asarray(kv_counts)
    pos = np.asarray(pos).reshape(-1)
    b = pos.shape[0]
    kv = cnt.shape[-1]
    valid_blocks = (pos + 1 + k_block - 1) // k_block          # (B,)
    dense_tiles = int(valid_blocks.sum()) * kv * (cnt.size // (b * kv))
    plan_tiles = int(cnt.sum())
    tile_bytes = 2 * k_block * d * dtype_bytes                 # K + V tile
    out = {
        "kv_fetch_tiles_dense": dense_tiles,
        "kv_fetch_tiles_plan": plan_tiles,
        "kv_fetch_bytes_dense": dense_tiles * tile_bytes,
        "kv_fetch_bytes_plan": plan_tiles * tile_bytes,
        "fetch_reduction": dense_tiles / max(plan_tiles, 1),
    }
    if replan is not None:
        k_tile_bytes = k_block * d * dtype_bytes               # K only
        layers = cnt.size // (b * kv)
        s_head = 0 if nkb is None else 2 * nkb * d * 4         # fp32 bounds
        sum_head_slot = np.full(b, s_head, np.int64)
        summaries_b = int(sum_head_slot.sum()) * kv * layers
        full_slot = valid_blocks * kv * layers * k_tile_bytes
        full_b = int(full_slot.sum())
        incr_b = summaries_b + plan_tiles * k_tile_bytes
        rep = np.asarray(replan, np.float64).reshape(-1)
        if rep.size == 1:
            step_b = int(round(float(rep[0]) * full_b
                               + (1.0 - float(rep[0])) * incr_b))
        else:
            assert rep.size == b, (rep.size, b)
            cnt_slot = cnt.reshape(-1, b, kv).sum(axis=(0, 2))  # (B,)
            incr_slot = sum_head_slot * kv * layers + cnt_slot * k_tile_bytes
            step_b = int(round(float(
                (rep * full_slot + (1.0 - rep) * incr_slot).sum())))
        out["plan_fetch_bytes_full"] = full_b
        out["plan_fetch_bytes_incremental"] = incr_b
        out["plan_fetch_bytes_step"] = step_b
        out["step_bytes_plan_route"] = (out["kv_fetch_bytes_plan"]
                                        + out["plan_fetch_bytes_step"])
        out["step_bytes_dense_route"] = out["kv_fetch_bytes_dense"]
    return out
