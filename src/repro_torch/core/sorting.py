"""SATA key sorting (Algo 1, lines 4-12) — port of
``repro.core.sorting.sort_keys_jax``, the batched sorter the dense
selection route's planner runs.

The greedy order walks the column Gram matrix ``G = maskᵀ·mask``: start
at key ``seed % N_k``, and at each step add the last chosen key's Gram
row to a partial-sum register per key (the paper's Psum registers, Eq. 2)
and take the unsorted key with the largest sum.  In fp32 the Gram matrix
and the registers are exact integers (below 2^24), and ``torch.argmax``
returns the first maximum, as ``jnp.argmax`` does, so the order equals
the reference's exactly.  The numpy sorters and the query classification
of the reference are paper analytics and are not ported here.
"""
from __future__ import annotations

import torch


def sort_keys(mask: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Batched greedy key order.  mask: (..., N_q, N_k) bool →
    (..., N_k) int32.  N_k − 1 sequential argmax steps, each batched
    over every leading dimension (heads)."""
    *batch, _, n_k = mask.shape
    m = mask.reshape(-1, *mask.shape[-2:]).float()
    gram = torch.einsum("bqi,bqj->bij", m, m)                # (H, N_k, N_k)
    h = gram.shape[0]
    dev = mask.device
    rows = torch.arange(h, device=dev)
    start = seed % n_k
    order = torch.empty((h, n_k), dtype=torch.int64, device=dev)
    order[:, 0] = start
    in_set = torch.zeros((h, n_k), dtype=torch.bool, device=dev)
    in_set[:, start] = True
    psum = torch.zeros((h, n_k), dtype=torch.float32, device=dev)
    last = order[:, 0]
    for step in range(1, n_k):
        psum += gram[rows, last]
        nxt = torch.argmax(psum.masked_fill(in_set, -1.0), dim=-1)
        in_set[rows, nxt] = True
        order[:, step] = nxt
        last = nxt
    return order.to(torch.int32).reshape(*batch, n_k)
