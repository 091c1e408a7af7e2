"""Shared neural layers — port of ``repro.models.layers``.

Functions take their parameters as a mapping (``p["scale"]``): a plain
dict of tensors or a ``ParamModule`` (an ``nn.Module`` whose parameters
and submodules also read by key), so the JAX functions' signatures carry
over.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class ParamModule(nn.Module):
    """``nn.Module`` whose parameters and submodules read by key, so the
    layer functions accept it wherever the reference passes a params
    dict."""

    def __getitem__(self, name: str):
        try:
            return getattr(self, name)
        except AttributeError:
            raise KeyError(name) from None

    def get(self, name: str, default=None):
        return getattr(self, name, default)


def argsort_descending(x: torch.Tensor) -> torch.Tensor:
    """Indices sorting the last dim in descending order (int32, no
    gradient).  As the reference's: a stable ascending sort, then
    flipped, so among equal values the HIGHER index comes first
    (``torch.argsort(descending=True, stable=True)`` would put the lower
    one first and route ties to other experts)."""
    idx = torch.argsort(x.detach(), dim=-1, stable=True)
    return torch.flip(idx, dims=(-1,)).to(torch.int32)


def apply_norm(params, cfg, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        rms = torch.sqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        out = xf / rms * params["scale"]
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps)
        if cfg.norm_type == "layernorm":
            out = out * params["scale"] + params["bias"]
    return out.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """Per-head RMS norm over head_dim (Qwen3 qk-norm)."""
    xf = x.float()
    rms = torch.sqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf / rms * scale).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, *, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)           # (hd/2,)
    ang = positions[..., :, None].float() * freqs            # (..., S, hd/2)
    sin = torch.sin(ang)[..., :, None, :]                    # broadcast heads
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_apply(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """A ``params`` view with a ``tp`` region holds the rank's d_ff
    block (columns of ``wi``/``wg``, rows of ``wo``): the partial
    outputs are summed over the region's ranks."""
    tp = getattr(params, "tp", None)
    if tp is not None:
        x = tp.enter(x)
    if cfg.mlp_variant == "swiglu":
        h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    else:
        h = F.gelu(x @ params["wi"], approximate="tanh")
    return h @ params["wo"] if tp is None \
        else tp.row_parallel(h, params["wo"])


def embed_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    """A ``params`` view with a ``VocabParallel`` region holds the
    rank's vocab rows: the rows are summed over the region's ranks."""
    tp = getattr(params, "tp", None)
    if tp is not None:
        return tp.embed(params["embedding"], tokens)
    return params["embedding"][tokens.long()]


def unembed_apply(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Logits stay fp32: the operands are upcast exactly, so a bf16
    model's products are exact and accumulate in fp32.  In a
    ``VocabParallel`` region they are the rank's (B, S, V / m)."""
    w = params.get("unembed")
    if w is None:
        w = params["embedding"].T
    tp = getattr(params, "tp", None)
    if tp is not None:
        return tp.logits(x, w)
    return torch.matmul(x.float(), w.float())
