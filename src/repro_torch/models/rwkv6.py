"""RWKV6 "Finch" block — port of ``repro.models.rwkv6``.

Attention-free: per head a (hd × hd) state carries the kᵀv outer-product
history with a data-dependent per-channel decay w_t.  Training and
prefill run a time scan (a Python loop over positions; in chunks under
``torch.utils.checkpoint`` when autograd records and the sequence tiles
by ``rwkv_chunk``), decode a single O(1) state update.  SATA does not
apply (no query-key selection), and the reference's scan is
``lax.scan``, not a Pallas kernel, so everything here is plain PyTorch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import ParamModule


class RWKV6(ParamModule):
    """The reference's leaves: the time-mix ratios ``mix_{r,k,v,g,w}``
    (d,) fp32, the projections ``wr``/``wk``/``wv``/``wg``/``wo`` (d, d),
    the Finch decay ``w0`` (d,) fp32 and its LoRA ``wa`` (d, lora) /
    ``wb`` (lora, d), ``bonus_u`` (h, hd) and ``ln_scale`` (d,) fp32;
    the channel mix ``cmix_k``/``cmix_r`` (d,) fp32, ``ck`` (d, d_ff),
    ``cv`` (d_ff, d), ``cr`` (d, d)."""

    def __init__(self, cfg, init):
        super().__init__()
        d, hd = cfg.d_model, cfg.rwkv_head_dim
        lora = max(32, d // 64)
        for name in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w"):
            setattr(self, name, init.full(d, 0.5))
        self.wr = init.dense(d, d)
        self.wk = init.dense(d, d)
        self.wv = init.dense(d, d)
        self.wg = init.dense(d, d)
        self.wo = init.dense(d, d)
        self.w0 = init.full(d, -6.0)
        self.wa = init.dense(d, lora)
        self.wb = init.dense(lora, d)
        self.bonus_u = init.zeros(d // hd, hd)
        self.ln_scale = init.ones(d)
        self.cmix_k = init.full(d, 0.5)
        self.cmix_r = init.full(d, 0.5)
        self.ck = init.dense(d, cfg.d_ff)
        self.cv = init.dense(cfg.d_ff, d)
        self.cr = init.dense(d, d)


def _shift(x: torch.Tensor, last: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Token shift: the previous token's features (zeros, or the cached
    last token, at t = 0)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, xs: torch.Tensor, ratio: torch.Tensor
         ) -> torch.Tensor:
    # back to the activation dtype: the fp32 ratios must not promote a
    # bf16 residual stream
    return (x * ratio + xs * (1.0 - ratio)).to(x.dtype)


def _decay(params, xw: torch.Tensor, ch=slice(None)) -> torch.Tensor:
    """Finch decay: w = exp(-exp(w0 + tanh(x·A)·B)) in (0, 1), on the
    channels ``ch``."""
    lora = torch.tanh(xw @ params["wa"]) @ params["wb"][:, ch]
    return torch.exp(-torch.exp(params["w0"][ch] + lora.float()))


def _group_norm(x: torch.Tensor, scale: torch.Tensor, hd: int,
                eps: float = 1e-5) -> torch.Tensor:
    b, s, d = x.shape
    xg = x.reshape(b, s, d // hd, hd).float()
    mu = xg.mean(dim=-1, keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=-1, keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(b, s, d) * scale


def _scan(bonus_u: torch.Tensor, state: torch.Tensor, r: torch.Tensor,
          k: torch.Tensor, v: torch.Tensor, w: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over the time axis (axis 1 of the (B, T, H, hd)
    inputs) → (final state, outputs (B, T, H, hd))."""
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B,H,hd,hd)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 state + bonus_u[..., None] * kv))
        state = state * w[:, t, :, :, None] + kv
    return state, torch.stack(outs, dim=1)


def rwkv6_time_mix(params, cfg, x: torch.Tensor,
                   state: Optional[torch.Tensor] = None,
                   last_x: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out, final state (B, H, hd, hd), last token's x).
    A ``params`` view with a ``tp`` region (``distributed.sharding``)
    runs the rank's H / m heads (their columns of ``wr`` / ``wk`` /
    ``wv`` / ``wg`` and of the decay, their rows of ``bonus_u`` and
    ``wo``): the per-head scan and group norm need nothing of the
    other ranks, and the out-projection's partials are summed.  Under
    context parallelism (``x`` the rank's rows) the scan needs the whole
    sequence: the region enters through its all-gather and leaves
    through the reduce-scatter to the rank's rows; without a region the
    rank gathers the sequence, scans it whole and keeps its rows."""
    tp = getattr(params, "tp", None)
    seq = getattr(params, "seq", None)
    if tp is None and seq is not None:
        out, state, last = _time_mix(params, cfg, seq.gather(x), state,
                                     last_x, None)
        return seq.take(out), state, last
    return _time_mix(params, cfg, x, state, last_x, tp)


def _time_mix(params, cfg, x, state, last_x, tp):
    hd = cfg.rwkv_head_dim
    ch = slice(None) if tp is None else tp.share(cfg.d_model)
    if tp is not None:
        x = tp.enter(x)
    b, s, _ = x.shape
    d = params["wr"].shape[-1]                # the rank's channels
    h = d // hd
    xs = _shift(x, last_x)
    r = _mix(x, xs, params["mix_r"]) @ params["wr"]
    k = _mix(x, xs, params["mix_k"]) @ params["wk"]
    v = _mix(x, xs, params["mix_v"]) @ params["wv"]
    g = _mix(x, xs, params["mix_g"]) @ params["wg"]
    w = _decay(params, _mix(x, xs, params["mix_w"]), ch)      # (B,S,D)

    rh = r.reshape(b, s, h, hd).float()
    kh = k.reshape(b, s, h, hd).float()
    vh = v.reshape(b, s, h, hd).float()
    wh = w.reshape(b, s, h, hd)
    if state is None:
        state = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                            device=x.device)
    u = params["bonus_u"]
    chunk = cfg.rwkv_chunk
    if s > chunk and s % chunk == 0:
        # an unchunked backward would keep the (B, H, hd, hd) state of
        # every position; the checkpoint keeps one per chunk and replays
        # the chunk's steps in the backward
        outs = []
        for c0 in range(0, s, chunk):
            part = [t[:, c0:c0 + chunk] for t in (rh, kh, vh, wh)]
            if torch.is_grad_enabled():
                state, o = checkpoint(_scan, u, state, *part,
                                      use_reentrant=False)
            else:
                state, o = _scan(u, state, *part)
            outs.append(o)
        outs = torch.cat(outs, dim=1)
    else:
        state, outs = _scan(u, state, rh, kh, vh, wh)
    y = _group_norm(outs.reshape(b, s, d), params["ln_scale"][ch], hd)
    y = (y * F.silu(g.float())).to(x.dtype)
    out = y @ params["wo"] if tp is None else tp.row_parallel(y, params["wo"])
    return out, state, x[:, -1, :]


def rwkv6_channel_mix(params, cfg, x: torch.Tensor,
                      last_x: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In a ``tp`` region a rank holds d_ff / m columns of ``ck`` (rows
    of ``cv``) and d / m columns of ``cr``: its partial ``k @ cv`` is
    reduce-scattered to its d / m channels in fp32, gated there, and
    the gated channels are all-gathered (the bytes of one all-reduce).
    Under context parallelism (``x`` the rank's rows) the region enters
    through the sequence's all-gather and the rank keeps its rows of the
    gathered channels; without a region the rank gathers the sequence,
    computes it whole and keeps its rows (the token shift reads the
    row before each)."""
    tp = getattr(params, "tp", None)
    seq = getattr(params, "seq", None)
    if tp is None and seq is not None:
        out, last = _channel_mix(params, cfg, seq.gather(x), last_x, None)
        return seq.take(out), last
    return _channel_mix(params, cfg, x, last_x, tp)


def _channel_mix(params, cfg, x, last_x, tp):
    if tp is not None:
        x = tp.enter(x)
    xs = _shift(x, last_x)
    k = _mix(x, xs, params["cmix_k"]) @ params["ck"]
    k = torch.square(F.relu(k))
    r = torch.sigmoid((_mix(x, xs, params["cmix_r"]) @ params["cr"])
                      .float()).to(x.dtype)
    if tp is None:
        return r * (k @ params["cv"]), x[:, -1, :]
    last = x.dim() - 1
    kv = tp.scatter_sum(torch.matmul(k.float(), params["cv"].float()), last)
    return tp.gather_out(r * kv.to(x.dtype), last), x[:, -1, :]


def init_rwkv_cache(cfg, batch: int, dtype, *, device
                    ) -> Dict[str, torch.Tensor]:
    """One layer's decode state: the time-mix state (B, H, hd, hd) fp32
    and the last token of each mix (B, d) in the model dtype."""
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    return {"state": torch.zeros((batch, d // hd, hd, hd),
                                 dtype=torch.float32, device=device),
            "tm_x": torch.zeros((batch, d), dtype=dtype, device=device),
            "cm_x": torch.zeros((batch, d), dtype=dtype, device=device)}


def rwkv6_decode(params, cfg, x: torch.Tensor, cache: Dict
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token time-mix step (B, 1, D) through the scan with S = 1;
    ``cache`` is not modified."""
    y, state, tm_x = rwkv6_time_mix(params, cfg, x, state=cache["state"],
                                    last_x=cache["tm_x"])
    return y, {"state": state, "tm_x": tm_x, "cm_x": cache["cm_x"]}
