"""Meta-tensor stand-ins for every model input — port of
``repro.launch.inputs``.

PyTorch's counterpart of a ``jax.ShapeDtypeStruct`` is a tensor on the
``meta`` device: it has a shape, a dtype and strides, and no storage,
so nothing here is allocated.  The shapes, dtypes and keys are the
reference's; the train state is the family's ``Model`` on meta with its
fp32 moments and step counter (the port's state, ``train.step``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.archs import ShapeSpec
from repro_torch.models import decode as dec
from repro_torch.models import model as mdl
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptConfig, init_opt_state

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype``."""
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs_for(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Training/prefill batch inputs."""
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": sds((b, s), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = sds((b, s), torch.int32)
    if cfg.family == "vlm":
        batch["image_embeds"] = sds((b, cfg.n_image_tokens, cfg.d_model),
                                    torch.float32)
    if cfg.family == "audio":
        batch["audio_embeds"] = sds((b, cfg.encoder_len, cfg.d_model),
                                    torch.float32)
    return batch


def decode_specs_for(cfg: ModelConfig, shape: ShapeSpec
                     ) -> Tuple[Dict, torch.Tensor, torch.Tensor]:
    """(cache, tokens, pos) stand-ins for ``serve_step``."""
    b, s = shape.global_batch, shape.seq_len
    cache = dec.init_cache(cfg, b, s, device=META)
    tokens = sds((b, 1), torch.int32)
    pos = sds((), torch.int32)
    return cache, tokens, pos


def state_specs_for(cfg: ModelConfig, opt: OptConfig) -> Dict[str, Any]:
    """Abstract train state (the model, its fp32 moments and the step
    counter) on meta: no allocation.  ``opt`` is taken for the
    reference's signature: the state's shapes do not depend on it."""
    model = mdl.Model(cfg, device=META)
    return {"params": model,
            "opt": init_opt_state(dict(model.named_parameters()))}
