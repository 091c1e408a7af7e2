"""Activation-sharding context — port of ``repro.distributed.ctx``.

The reference installs ``NamedSharding``s here and its model code calls
``constrain(x, kind)``, a ``with_sharding_constraint`` that pins GSPMD's
propagation to batch-sharded activations.  The port has no GSPMD: a
rank computes on the tensors it holds, and ``train(mesh=)`` builds the
rank's layout explicitly (its batch rows, FSDP gathers, the
tensor-parallel regions: ``distributed.sharding``).  So the specs are
kept as tuples, for the caller to read and for parity with the
reference, and ``constrain`` returns ``x`` unchanged.

``mesh_installed()`` is not ported: it is the reference's route-off for
``pallas_call``'s missing SPMD rule (its mesh training runs ``_attend``
instead of its kernel); the port's mesh training keeps the kernel route,
on each rank's heads.

``set_context_parallel`` is the switch of the context-parallel layout,
as in the reference: with a mesh installed (``cp_enabled()``), the
train and prefill steps made then (``train.step.make_train_step`` /
``make_prefill_step``) compute each rank's layers on its contiguous
1/m of the sequence over "model" (``distributed.sharding.SeqShard``),
the attention on the rank's query rows against the whole sequence's
K/V, with the SATA kernel on those rows.  The specs ``cp_q_spec`` /
``cp_kv_spec`` / ``cp_scores_spec`` (the reference's
``constrain_cp_*``) are kept for the caller to read: that layout is
what the steps build.  The serving step never reads the switch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import _dp

_SPECS: Dict[str, Tuple] = {}
_MESH = None          # the mesh a launcher installed, or None
_CP = False


def set_activation_shardings(specs: Dict[str, Tuple], mesh=None) -> None:
    """Keep the activation specs (``make_activation_shardings``) and the
    mesh they were made for."""
    global _SPECS, _MESH
    _SPECS = dict(specs)
    if mesh is not None:
        _MESH = mesh


def clear() -> None:
    global _SPECS, _MESH
    _SPECS = {}
    _MESH = None


def set_context_parallel(on: bool) -> None:
    global _CP
    _CP = bool(on)


def cp_enabled() -> bool:
    """Context parallelism asked for, with a mesh installed."""
    return _CP and _MESH is not None


def activation_spec(kind: str) -> Optional[Tuple]:
    """The installed spec of ``kind`` (None when unset)."""
    return _SPECS.get(kind)


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` unchanged: a rank's tensors already have the layout the
    spec names (there is no propagation to pin)."""
    return x


def scores_spec(shape: Tuple[int, ...], mesh) -> Tuple:
    """The reference's ``constrain_scores`` layout for attention scores
    (B, KV, G, Q, S): batch over the data axes, "model" on the first of
    KV, G, S that divides."""
    m = mesh.shape["model"]
    _, kv, g, _, s = shape
    spec = [_dp(mesh), None, None, None, None]
    if kv % m == 0:
        spec[1] = "model"
    elif g % m == 0:
        spec[2] = "model"
    elif s % m == 0:
        spec[4] = "model"
    return tuple(spec)


def heads_spec(shape: Tuple[int, ...], mesh) -> Tuple:
    """The reference's ``constrain_heads`` layout for (B, Q, H, hd):
    batch over the data axes, heads (or head_dim) over "model"."""
    m = mesh.shape["model"]
    spec = [_dp(mesh), None, None, None]
    if shape[2] % m == 0:
        spec[2] = "model"
    elif shape[3] % m == 0:
        spec[3] = "model"
    return tuple(spec)


def _cp_spec(spec, mesh) -> Tuple:
    dp = _dp(mesh)
    return tuple(dp if a == "DP" else a for a in spec)


def cp_q_spec(shape: Tuple[int, ...], mesh) -> Optional[Tuple]:
    """The reference's ``constrain_cp_q`` layout for q (B, Q, H, hd):
    batch over the data axes, the query dim over "model"; None (left as
    it is) without context parallelism or where "model" does not divide
    Q."""
    if not cp_enabled() or shape[1] % mesh.shape["model"] != 0:
        return None
    return _cp_spec(("DP", "model", None, None), mesh)


def cp_kv_spec(shape: Tuple[int, ...], mesh) -> Optional[Tuple]:
    """The reference's ``constrain_cp_kv`` layout for k/v (B, S, KV, hd):
    batch over the data axes, replicated over "model"."""
    if not cp_enabled():
        return None
    return _cp_spec(("DP", None, None, None), mesh)


def cp_scores_spec(shape: Tuple[int, ...], mesh) -> Optional[Tuple]:
    """The reference's ``constrain_cp_scores`` layout for scores
    (B, KV, G, Q, S): batch over the data axes, the query dim over
    "model" where it divides."""
    if not cp_enabled() or shape[3] % mesh.shape["model"] != 0:
        return None
    return _cp_spec(("DP", None, None, "model", None), mesh)


def make_activation_shardings(mesh, cfg, seq_shard: bool = False
                              ) -> Dict[str, Tuple]:
    """The standard batch-sharded activation layout for a model config,
    as spec tuples.  ``seq_shard``: the residual stream's sequence dim
    over "model" at block boundaries (sequence parallelism)."""
    dp = _dp(mesh)
    specs = {
        "act": (dp, "model" if seq_shard else None, None),   # (B, S, D)
        "logits": (dp, None, "model"),                       # (B, S, V)
    }
    if cfg.moe:
        specs["moe_tokens"] = (dp, None, None)                 # (G, T, D)
        specs["moe_dispatch"] = (dp, None, None, None)         # (G, T, E, C)
        if cfg.expert_shard == "expert":
            specs["moe_expert_in"] = (dp, "model", None, None)   # (G,E,C,D)
            specs["moe_expert_h"] = (dp, "model", None, None)    # (G,E,C,F)
        else:
            specs["moe_expert_in"] = (dp, None, None, None)
            specs["moe_expert_h"] = (dp, None, None, "model")
    return specs
