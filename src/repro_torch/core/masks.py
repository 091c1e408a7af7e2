"""Top-k selective attention masks (the SATA workload) — port of
``repro.core.masks``.

The input to SATA is the top-k index set of keys relevant to each query
(paper Sec. III-A).  ``topk_mask`` builds it from scores; the synthetic,
locality-structured score generator (``synthetic_scores``) reproduces
the paper's workload traces.

A seed's masks differ from the reference's: the reference draws from
``jax.random``'s threefry generator, this module from a CPU
``torch.Generator``.  The draws are made on the host whatever the device,
and ``_compose_scores`` turns them into scores with elementwise
operations only (the cluster product as an explicit sum over the rank,
the band computed on the host), so a seed gives bitwise the same scores,
and the same masks, on the CPU and on the card.  The tests feed
``_compose_scores`` JAX's own draws to hold it to the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean selection mask of the top-``k`` keys per query row.

    scores: (..., n_q, n_k) attention logits.  Returns bool (..., n_q, n_k)
    with exactly ``k`` True entries per row.  Ties go to the lower key
    index, as ``jax.lax.top_k`` breaks them: a stable descending sort
    keeps equal scores in key order (``torch.topk`` promises no order on
    ties)."""
    n_k = scores.shape[-1]
    if k >= n_k:
        return torch.ones(scores.shape, dtype=torch.bool,
                          device=scores.device)
    idx = torch.sort(scores, dim=-1, descending=True,
                     stable=True).indices[..., :k]
    mask = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    return mask.scatter_(-1, idx, True)


def apply_selective_mask(scores: torch.Tensor, mask: torch.Tensor,
                         neg: float = -1e30) -> torch.Tensor:
    """Mask non-selected logits to ``neg`` (pre-softmax)."""
    return torch.where(mask, scores,
                       torch.tensor(neg, dtype=scores.dtype,
                                    device=scores.device))


@dataclasses.dataclass(frozen=True)
class SyntheticTrace:
    """Generator spec for locality-structured selective masks.

    Real selective-attention masks are not i.i.d.: queries cluster around
    shared salient keys (CLS-like tokens, local windows).  Scores are
    ``low-rank cluster structure + distance band + noise``, then top-k.
    ``cluster_rank``/``band_width``/``noise`` steer how sortable the
    resulting mask is, calibrated per workload in configs/workloads.py
    to match the paper's Tab. I post-schedule statistics.
    """
    n_tokens: int
    k: int
    cluster_rank: int = 4
    cluster_scale: float = 1.0
    band_width: float = 0.0          # 0 disables the locality band
    band_scale: float = 1.0
    block_quant: int = 0             # >0: quantize positions to blocks
                                     # (window/group attention, DRSformer-like)
    discrete_clusters: int = 0       # >0: queries share per-cluster key
                                     # sets (object-region attention) —
                                     # raster order is uninformative, the
                                     # regime SATA sorting targets
    noise: float = 0.35
    causal: bool = False


def _draws(generator: torch.Generator, trace: SyntheticTrace, n_heads: int
           ) -> tuple:
    """The random draws of one trace, on the host: query and key cluster
    ids (int64) or factors (fp32, (n_heads, N, rank)), then the noise
    (n_heads, N, N), in that order."""
    n = trace.n_tokens
    if trace.discrete_clusters > 0:
        c = trace.discrete_clusters
        q = torch.randint(0, c, (n_heads, n), generator=generator)
        k = torch.randint(0, c, (n_heads, n), generator=generator)
    else:
        shape = (n_heads, n, trace.cluster_rank)
        q = torch.randn(shape, generator=generator)
        k = torch.randn(shape, generator=generator)
    return q, k, torch.randn((n_heads, n, n), generator=generator)


def _band(trace: SyntheticTrace) -> torch.Tensor:
    """(N, N) fp32 ``band_scale · exp(-(dist / band_width)²)`` on the
    host (one ``exp`` implementation whatever the scores' device)."""
    pos = torch.arange(trace.n_tokens)
    if trace.block_quant > 0:
        pos = (pos // trace.block_quant) * trace.block_quant
    dist = (pos[:, None] - pos[None, :]).abs().to(torch.float32)
    return trace.band_scale * torch.exp(-(dist / trace.band_width) ** 2)


def _compose_scores(trace: SyntheticTrace, q_draw: torch.Tensor,
                    k_draw: torch.Tensor, noise: torch.Tensor
                    ) -> torch.Tensor:
    """(n_heads, N, N) fp32 scores from the draws, on ``noise``'s device:
    cluster term (``cluster_scale`` on same-cluster pairs, or the scaled
    rank-r factor product), the band, the noise, the causal fill — the
    reference's steps in its order."""
    dev = noise.device
    if trace.discrete_clusters > 0:
        same = (q_draw[:, :, None] == k_draw[:, None, :]).to(torch.float32)
        scores = trace.cluster_scale * same
    else:
        prod = q_draw[:, :, None, 0] * k_draw[:, None, :, 0]
        for r in range(1, trace.cluster_rank):
            prod = prod + q_draw[:, :, None, r] * k_draw[:, None, :, r]
        scores = trace.cluster_scale * prod
        # a device tensor, not a Python scalar: CUDA divides by a host
        # scalar through its reciprocal, which would move the last bit
        scores = scores / torch.tensor(np.sqrt(trace.cluster_rank),
                                       dtype=torch.float32, device=dev)
    if trace.band_width > 0:
        scores = scores + _band(trace).to(dev)[None]
    scores = scores + trace.noise * noise
    if trace.causal:
        n = trace.n_tokens
        causal = torch.tril(torch.ones((n, n), dtype=torch.bool, device=dev))
        scores = torch.where(causal[None], scores,
                             torch.tensor(-1e30, device=dev))
    return scores


def synthetic_scores(generator: torch.Generator, trace: SyntheticTrace,
                     n_heads: int, device="cuda") -> torch.Tensor:
    """(n_heads, N, N) synthetic attention scores for ``trace`` on
    ``device``, drawn from ``generator`` (a CPU ``torch.Generator``)."""
    dev = resolve_device(device)
    q, k, noise = _draws(generator, trace, n_heads)
    return _compose_scores(trace, q.to(dev), k.to(dev), noise.to(dev))


def synthetic_masks(seed: int, trace: SyntheticTrace, n_heads: int, *,
                    device="cuda") -> np.ndarray:
    """(n_heads, N, N) boolean selective masks for a synthetic workload,
    made on ``device`` and returned as a numpy array."""
    dev = resolve_device(device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    scores = synthetic_scores(g, trace, n_heads, device=dev)
    return topk_mask(scores, trace.k).cpu().numpy()
