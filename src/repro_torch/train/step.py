"""Training and prefill step functions — port of ``repro.train.step``.

The train state is ``{"params": model, "opt": {"m", "v", "step"}}`` (and
``"err"`` with gradient compression): the model's parameters and the
fp32 moments, all updated in place by the step.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.models import model as mdl
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptConfig, adamw_update, init_opt_state


def make_train_step(cfg: ModelConfig, opt: OptConfig, micro_steps: int = 1):
    """→ train_step(state, batch) -> (state, metrics).  ``batch`` holds
    tensors on the model's device.  ``micro_steps > 1`` splits the batch
    and accumulates the microbatch gradients in fp32 before the update,
    as the reference's scan does."""

    def grads_of(model, params, batch):
        loss, parts = mdl.loss_fn(model, cfg, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        parts = {n: t.detach() for n, t in parts.items()}
        return loss.detach(), parts, dict(zip(params, grads))

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        model = state["params"]
        params = dict(model.named_parameters())
        if micro_steps == 1:
            loss, parts, grads = grads_of(model, params, batch)
        else:
            n = next(iter(batch.values())).shape[0] // micro_steps
            dev = next(iter(params.values())).device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = {name: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                     for name, p in params.items()}
            for i in range(micro_steps):
                mb = {k: t[i * n:(i + 1) * n] for k, t in batch.items()}
                l_i, _, g_i = grads_of(model, params, mb)
                loss = loss + l_i
                for name, g in g_i.items():
                    grads[name] += g
            loss = loss / micro_steps
            grads = {name: g / micro_steps for name, g in grads.items()}
            parts = {"nll": loss, "aux": torch.zeros((), device=dev)}
        _, opt_state, err, om = adamw_update(opt, params, grads,
                                             state["opt"], state.get("err"))
        state["opt"] = opt_state
        if err is not None:
            state["err"] = err
        return state, {"loss": loss, **parts, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """Forward only: last-position logits (B, V) fp32 for a full batch."""
    def prefill_step(model, batch):
        with torch.no_grad():
            logits, _ = mdl.forward(model, cfg, batch)
        return logits[:, -1, :]
    return prefill_step


def init_train_state(cfg: ModelConfig, opt: OptConfig, *, seed: int = 0,
                     device="cuda", model=None) -> Dict[str, Any]:
    """A fresh train state: ``model`` or the family's ``Model`` with random
    weights from ``seed`` on ``device`` (default ``"cuda"``; raises
    without a GPU), zero fp32 moments, and zero error-feedback buffers
    with ``opt.compress_grads``."""
    dev = resolve_device(device)
    if model is None:
        model = mdl.Model(cfg, device=dev, seed=seed)
    params = dict(model.named_parameters())
    state = {"params": model, "opt": init_opt_state(params)}
    if opt.compress_grads:
        state["err"] = {n: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                        for n, p in params.items()}
    return state
