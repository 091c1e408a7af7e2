"""AdamW — port of ``repro.optim.adamw``: fp32 moments, global gradient
clipping, the cosine LR schedule with warmup, and optional int8
error-feedback gradient compression.

The update runs tensor by tensor, in place: moments are updated with
in-place ops and each parameter is overwritten with its new value in
its own dtype (the reference returns new arrays).  The arithmetic is the
reference's, in fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False   # int8 error-feedback compression


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine decay to ``min_lr_frac·lr``
    at ``decay_steps`` (fp32, as the reference)."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr \
        * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Dict[str, torch.Tensor]) -> Dict:
    """fp32 zero moments per parameter name, and the step counter."""
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    dev = next(iter(params.values())).device
    return {"m": zeros, "v": {n: torch.zeros_like(z) for n, z in
                              zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _global_norm(grads: Dict[str, torch.Tensor], mesh=None,
                 specs=None) -> torch.Tensor:
    """The whole gradient's L2 norm.  On a mesh ``grads`` are the rank's
    blocks (``specs`` per name): the per-leaf sums of squares are summed
    over the mesh, each block counted once (a leaf replicated over an
    axis counts only at coordinate 0 of it)."""
    sq = torch.stack([torch.sum(torch.square(g.float()))
                      for g in grads.values()])
    if mesh is not None:
        from repro_torch.distributed.sharding import counted_once
        from repro_torch.launch.mesh import _all_reduce
        own = torch.tensor([counted_once(specs[n], mesh) for n in grads],
                           device=sq.device)
        sq = _all_reduce(torch.where(own, sq, 0.0), mesh,
                         tuple(mesh.axis_names))
    return torch.sqrt(sq.sum())


def compress_int8(g: torch.Tensor, err: torch.Tensor,
                  absmax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 quantization: returns (dequantized g, new err).
    The residual feeds back next step, so the compression is unbiased
    over time.  ``absmax``: the max |g + err| over the whole leaf, when
    ``g`` is one rank's block of it (default: over ``g``)."""
    gf = g.float() + err
    if absmax is None:
        absmax = torch.max(torch.abs(gf))
    scale = absmax / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, gf - deq


@torch.no_grad()
def adamw_update(opt: OptConfig, params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: Dict,
                 err: Optional[Dict[str, torch.Tensor]] = None, *,
                 mesh=None, specs=None
                 ) -> Tuple[Dict, Dict, Optional[Dict], Dict]:
    """One AdamW step over name-keyed tensors, updating ``params`` and
    the moments in place.  Returns (params, state, err, metrics).

    On a ``mesh`` every tensor is the rank's block of its leaf
    (``specs`` per name, ``distributed.sharding``): the update is
    elementwise, and the two global quantities — the gradient norm for
    clipping and each leaf's int8 absmax — are reduced over the mesh."""
    step = state["step"] + 1
    if opt.compress_grads and err is not None:
        amax = None
        if mesh is not None:
            from repro_torch.launch.mesh import _all_reduce
            amax = _all_reduce(torch.stack([
                torch.max(torch.abs(g.float() + err[n]))
                for n, g in grads.items()]), mesh, tuple(mesh.axis_names),
                op="max")
        pairs = {n: compress_int8(g, err[n],
                                  None if amax is None else amax[i])
                 for i, (n, g) in enumerate(grads.items())}
        grads = {n: pr[0] for n, pr in pairs.items()}
        err = {n: pr[1] for n, pr in pairs.items()}
    gnorm = _global_norm(grads, mesh, specs)
    scale = torch.clamp(opt.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(opt, step)
    stepf = step.float()
    b1c = 1 - opt.b1 ** stepf
    b2c = 1 - opt.b2 ** stepf
    for n, p in params.items():
        g = grads[n].float() * scale
        m, v = state["m"][n], state["v"][n]
        m.mul_(opt.b1).add_((1 - opt.b1) * g)
        v.mul_(opt.b2).add_((1 - opt.b2) * g * g)
        p32 = p.float()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + opt.eps) \
            + opt.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, err, {"grad_norm": gnorm, "lr": lr}
