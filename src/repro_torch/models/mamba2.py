"""Mamba2 (SSD) block — port of ``repro.models.mamba2``: the chunked
matmul form for training and prefill, and the O(1) recurrent step for
decode.

Within a chunk the output is a masked, decay-weighted attention-like
product; across chunks a small recurrent state (B, H, N, P) is carried
by a Python loop over the chunks (the reference's ``lax.scan``).  The
recurrence has no Pallas kernel in the reference, so it stays plain
PyTorch here: einsums and elementwise ops.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamModule


class Mamba2(ParamModule):
    """The reference's leaves: ``in_proj`` (d, 2·di + 2·n + h) → [z (di),
    x (di), B (n), C (n), dt (h)], the depthwise causal ``conv_w`` (K,
    di + 2·n), ``a_log`` / ``d_skip`` / ``dt_bias`` (h,) and
    ``norm_scale`` (di,) in fp32, ``out_proj`` (di, d).  ``init`` is the
    model's weight factory."""

    def __init__(self, cfg, init):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        self.in_proj = init.dense(d, 2 * di + 2 * n + h)
        self.conv_w = init.normal((cfg.ssm_conv, di + 2 * n), 0.1)
        self.a_log = init.fixed(torch.log(torch.linspace(1.0, 16.0, h)))
        self.d_skip = init.ones(h)
        self.dt_bias = init.zeros(h)
        self.norm_scale = init.ones(di)
        self.out_proj = init.dense(di, d)


def _split_proj(cfg, zxbcdt: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time.  xbc: (B, S, C), w: (K, C)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(k))
    return F.silu(out)


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6, tp=None) -> torch.Tensor:
    """RMS norm over the whole of d_inner; in a region ``y`` holds the
    rank's heads, and their sum of squares is summed over the ranks."""
    y = y * F.silu(z.float())
    if tp is None:
        rms = torch.sqrt((y * y).mean(dim=-1, keepdim=True) + eps)
    else:
        ss = tp.sum_shares((y * y).sum(dim=-1, keepdim=True))
        rms = torch.sqrt(ss / (y.shape[-1] * tp.size) + eps)
    return y / rms * scale


def _region_proj(tp, cfg, x: torch.Tensor, params):
    """The rank's (z, x, B|C, dt) from its ``Packed`` blocks of
    ``in_proj`` and ``conv_w``: its heads' z / x / dt columns and its
    1/m of B|C; the conv runs on those, then B|C is gathered whole."""
    dr, bcr = cfg.d_inner // tp.size, 2 * cfg.ssm_state // tp.size
    zxbcdt = x @ params["in_proj"]
    z, xbc, dt = (zxbcdt[..., :dr], zxbcdt[..., dr:2 * dr + bcr],
                  zxbcdt[..., 2 * dr + bcr:])
    xbc = _causal_conv(xbc, params["conv_w"])
    bc = tp.gather_shared(xbc[..., dr:], xbc.dim() - 1)
    return z, xbc[..., :dr], bc, dt


def mamba2_apply(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Training / prefill forward.  x: (B, S, D).  A ``params`` view
    with a ``tp`` region (``distributed.sharding``) runs the rank's
    ``ssm_heads / m`` heads: B and C, which every head reads, are
    gathered after the conv, the gated norm's statistic is summed over
    the ranks and the out-projection's partial products too.  Under
    context parallelism (``x`` the rank's rows) the scan needs the
    whole sequence: the region enters through its all-gather and leaves
    through the reduce-scatter to the rank's rows; without a region the
    rank gathers the sequence, computes it whole and keeps its rows."""
    tp = getattr(params, "tp", None)
    seq = getattr(params, "seq", None)
    if tp is None and seq is not None:
        return seq.take(_mamba2(params, cfg, seq.gather(x), None))
    return _mamba2(params, cfg, x, tp)


def _mamba2(params, cfg, x: torch.Tensor, tp) -> torch.Tensor:
    if tp is not None:
        x = tp.enter(x)
    b, s, _ = x.shape
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s)
    if s % q != 0:
        q = s
    nc = s // q

    if tp is None:
        z, xbc, dt_raw = _split_proj(cfg, x @ params["in_proj"])
        xbc = _causal_conv(xbc, params["conv_w"])
        xin, bc, heads = xbc[..., :di], xbc[..., di:], slice(None)
    else:
        z, xin, bc, dt_raw = _region_proj(tp, cfg, x, params)
        heads = tp.share(h)
        h = heads.stop - heads.start
    xs = xin.reshape(b, s, h, p).float()
    bmat = bc[..., :n].float()                                # (B,S,N)
    cmat = bc[..., n:].float()                                # (B,S,N)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][heads])  # (B,S,H)
    a = -torch.exp(params["a_log"][heads])                    # (H,) < 0
    log_decay = dt * a                                        # (B,S,H) <= 0

    xs_c = xs.reshape(b, nc, q, h, p)
    b_c = bmat.reshape(b, nc, q, n)
    c_c = cmat.reshape(b, nc, q, n)
    dt_c = dt.reshape(b, nc, q, h)
    lcum = torch.cumsum(log_decay.reshape(b, nc, q, h), dim=2)  # (B,C,Q,H)

    # intra-chunk: decay(i, j) = exp(lcum_i - lcum_j) for i >= j.  The
    # upper triangle is set to -inf BEFORE exp, so it gives exact zeros
    # and zero gradients (exp of a positive difference could overflow)
    dec = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]     # (B,C,Qi,Qj,H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    dec = torch.where(causal[None, None, :, :, None], dec, float("-inf"))
    gij = torch.exp(dec)
    cb = torch.einsum("bcin,bcjn->bcij", c_c, b_c)            # (B,C,Qi,Qj)
    w_ij = cb[..., None] * gij * dt_c[:, :, None, :, :]       # × dt_j
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w_ij, xs_c)

    # chunk states S_c = Σ_j exp(lQ - l_j)·dt_j·B_j ⊗ x_j, then the
    # inter-chunk recurrence over the states BEFORE each chunk
    tail = torch.exp(lcum[:, :, -1:, :] - lcum)               # (B,C,Q,H)
    sc = torch.einsum("bcjh,bcjn,bcjhp->bchnp", tail * dt_c, b_c, xs_c)
    chunk_decay = torch.exp(lcum[:, :, -1, :])                # (B,C,H)
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + sc[:, c]
    h_prev = torch.stack(h_prev, dim=1)                       # (B,C,H,N,P)

    y_inter = torch.einsum("bcin,bchnp->bcihp", c_c, h_prev) \
        * torch.exp(lcum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)
    y = y + params["d_skip"][heads][None, None, :, None] * xs
    if tp is None:
        y = _gated_rmsnorm(y.reshape(b, s, di), z, params["norm_scale"])
        return y.to(x.dtype) @ params["out_proj"]
    y = _gated_rmsnorm(y.reshape(b, s, h * p), z,
                       params["norm_scale"][tp.share(di)], tp=tp)
    return tp.row_parallel(y.to(x.dtype), params["out_proj"])


# ---------------------------------------------------------------------------
# Decode (recurrent, O(1) per token)
# ---------------------------------------------------------------------------

def init_mamba_cache(cfg, batch: int, dtype, *, device
                     ) -> Dict[str, torch.Tensor]:
    """One layer's decode state: the SSM state (B, H, N, P) in fp32 and
    the last K - 1 conv inputs (B, K - 1, di + 2·n) in the model dtype."""
    di, n = cfg.d_inner, cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, cfg.ssm_heads, n, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n),
                            dtype=dtype, device=device),
    }


def mamba2_decode(params, cfg, x: torch.Tensor, cache: Dict
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step.  x: (B, 1, D) → (out (B, 1, D), the new
    state {"ssm", "conv"}); ``cache`` is not modified.  A ``params``
    view with a ``tp`` region runs the rank's ssm heads in
    ``_region_proj``'s order: its ``Packed`` projection columns, the
    conv over its own channels (its ``conv`` state holds the same
    ``Packed`` channels, ``ShardLayout.cache_specs``), then B|C gathered
    whole; its state (B, H / m, N, P), the gated norm's sum of squares
    summed over the ranks, and the out-projection's partial products
    too."""
    b = x.shape[0]
    n, h, p = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    tp = getattr(params, "tp", None)
    m = 1 if tp is None else tp.size
    dr, bcr = cfg.d_inner // m, 2 * n // m      # the rank's x and B|C
    if tp is not None:
        x = tp.enter(x)
    zxbcdt = x @ params["in_proj"]
    z, xbc, dt_raw = (zxbcdt[..., :dr], zxbcdt[..., dr:2 * dr + bcr],
                      zxbcdt[..., 2 * dr + bcr:])
    hist = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)],
                     dim=1)                                   # (B, K, C)
    conv_out = F.silu((hist * params["conv_w"][None]).sum(dim=1,
                                                          keepdim=True))
    bc, heads = conv_out[:, 0, dr:], slice(None)
    if tp is not None:
        bc, heads = tp.gather_shared(bc, 1), tp.share(h)
        h //= m
    xs = conv_out[..., :dr].reshape(b, h, p).float()
    bvec = bc[:, :n].float()
    cvec = bc[:, n:].float()
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"][heads])
    decay = torch.exp(dt * -torch.exp(params["a_log"][heads]))  # (B,H)
    state = cache["ssm"] * decay[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dt, bvec, xs)
    y = torch.einsum("bn,bhnp->bhp", cvec, state)
    y = y + params["d_skip"][heads][None, :, None] * xs
    new = {"ssm": state, "conv": hist[:, 1:]}
    if tp is None:
        y = _gated_rmsnorm(y.reshape(b, 1, dr), z, params["norm_scale"])
        return y.to(x.dtype) @ params["out_proj"], new
    y = _gated_rmsnorm(y.reshape(b, 1, dr), z,
                       params["norm_scale"][tp.share(cfg.d_inner)], tp=tp)
    return tp.row_parallel(y.to(x.dtype), params["out_proj"]), new
