"""Plain dense oracles — port of ``repro.kernels.ref``: masked softmax
attention computed in one piece, with no tiling or online softmax."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -2.0 ** 30


def ref_block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_map: torch.Tensor,
                        mask: Optional[torch.Tensor] = None, *,
                        q_block: int = 128, k_block: int = 128
                        ) -> torch.Tensor:
    """Masked softmax attention where a (q_block × k_block) tile takes
    part iff its ``block_map`` entry is set, with an optional element
    mask on top.  Rows with no admissible key return zeros."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (
        1.0 / np.sqrt(d))
    bm = block_map.bool().repeat_interleave(q_block, dim=1) \
        .repeat_interleave(k_block, dim=2)
    keep = bm if mask is None else (bm & mask.bool())
    s = torch.where(keep, s, NEG_INF)
    any_key = keep.any(dim=-1, keepdim=True)
    p = torch.where(any_key, torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def ref_dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> torch.Tensor:
    bm = torch.ones((q.shape[0], 1, 1), dtype=torch.bool, device=q.device)
    return ref_block_attention(q, k, v, bm, q_block=q.shape[1],
                               k_block=k.shape[1])
