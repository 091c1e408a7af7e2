"""Decode-path SATA: incremental per-slot KV-block plan — port of
``repro.core.decode_plan``.

Per batch slot and KV head the plan state keeps

  k_min / k_max  (B, KV, nkb, D) — elementwise key bounds per k-block,
                 absorbed incrementally as the cache grows.  Two storage
                 backends (``summary=`` on init):
                 * ``"fp32"``: exact bounds; min/max is associative, so
                   they equal a from-scratch recompute bit for bit
                   (``summaries_from_cache``);
                 * ``"int8"``: codes plus per-block fp32 ``k_scale`` /
                   ``k_zero`` (B, KV, nkb), rounded outward so the
                   dequantized bounds always CONTAIN the exact ones
                   (absorb = dequantize ∪ new key, requantize outward).
                   Quantized bounds only rank blocks; the token
                   threshold still runs over full-precision keys;
  kv_indices     (B, KV, P) int32 — ascending selected k-block indices
                 (``compact_kv_plan`` layout, the decode kernel's plan);
  kv_counts      (B, KV) int32    — live entries per row;
  step / churn / replans / active (B,) — the re-plan beat, the churn
                 trigger state, the cumulative re-plan counter and the
                 slot's liveness.

The state is a plain dict of tensors.  Functions that maintain it
(``update_block_summaries``, ``decode_plan_update``, the slot resets)
update the tensors IN PLACE — the serving cache stacks each field over
layers and hands every layer a dict of views, so an in-place update
lands in the stacked state without copying it — and return the dict.

Refreshes blend an exact full re-plan (score every cached key, bisect
each query row's top-k threshold, keep every block holding a selected
token) or, with ``replan_mode="sketch"``, the two-level
``sketch_replan`` (rank super-block sketches, then bisect over the
surviving candidate blocks only) with the incremental plan (rank blocks
by the Quest upper bound from the summaries, keep the top P, bisect the
token threshold over the planned blocks only).  The trigger is a fixed
integer interval or churn-adaptive (``churn_budget``: a slot re-plans
once the blocks entering and leaving its plan add up to
``churn_budget · P``).  A step that mixes triggered and untriggered
slots loops over the slots on the host, so only the triggering slots
stream their cache.

Per-slot QoS knobs (``init_decode_plan(..., qos=True)``): ``budget`` /
``interval`` (B,) int32 and ``quant`` / ``sketch`` (B,) bool, the
degradation-ladder rungs the serving loop's QoS controller pushes
between steps.  ``budget`` caps the blocks a plan keeps (a re-plan ranks
its selected blocks by best token score and re-bisects the threshold
over the survivors), ``interval`` is the slot's own re-plan beat,
``quant`` ranks the slot's blocks from an int8 round trip of its fp32
bounds, and ``sketch`` makes its re-plan hierarchical.  A step with the
knobs always loops over the slots on the host, one slot at a time, so
an undegraded slot's arithmetic (every product at batch 1) never
depends on its neighbours' rungs.

Cascade retirement (``retire=True``): ``imp`` (B, KV, nkb) fp32, the
decayed planned-set membership of each block, and ``live_blk`` (B, nkb)
bool, which every planner ANDs into its block validity; the serving
loop retires a slot's coldest blocks through ``retire_plan_blocks``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blockmap import bisect_select, compact_kv_plan
from repro_torch.core.paging import logical_kv_view
from repro_torch.core.selection import NEG_INF, kth_largest_bisect

PlanState = Dict[str, torch.Tensor]

SUMMARY_BACKENDS = ("fp32", "int8")

# int8 code range: block range endpoints land on ±126 so the ±1
# conservative-rounding margin never clips anti-conservatively
_INT8_LEVELS = 252.0

def summary_bytes(nkb: int, d: int, summary: str = "fp32") -> int:
    """Block-summary bytes per (slot, kv head) — what one incremental
    ranking pass reads.  fp32: 2·nkb·D·4.  int8: 2·nkb·D codes plus the
    per-block fp32 (scale, zero) pairs."""
    assert summary in SUMMARY_BACKENDS, summary
    if summary == "int8":
        return 2 * nkb * d + nkb * 2 * 4
    return 2 * nkb * d * 4


def quantize_summaries(k_min: torch.Tensor, k_max: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor, torch.Tensor]:
    """fp32 per-block bounds (..., D) → int8 codes plus per-block fp32
    (scale, zero) (...,).  Conservative: floor−1 / ceil+1 rounding leaves
    a whole quantization step of margin, so ``dequantize_summaries`` of
    the result contains the inputs elementwise (the scale floor keeps
    that step above a few ulps of ``zero`` for near-constant blocks).
    Empty blocks (±inf bounds) get the ``scale = -1`` sentinel."""
    empty = ~torch.isfinite(k_min[..., 0])
    lo = torch.where(empty[..., None], 0.0, k_min.float())
    hi = torch.where(empty[..., None], 0.0, k_max.float())
    rlo = lo.amin(dim=-1)
    rhi = hi.amax(dim=-1)
    zero = 0.5 * (rlo + rhi)
    rng = torch.maximum(rhi - rlo, torch.clamp(1e-4 * zero.abs(), min=1e-30))
    scale = rng / _INT8_LEVELS
    q_lo = torch.clamp(torch.floor((lo - zero[..., None]) / scale[..., None])
                       - 1, -128, 127).to(torch.int8)
    q_hi = torch.clamp(torch.ceil((hi - zero[..., None]) / scale[..., None])
                       + 1, -128, 127).to(torch.int8)
    return (q_lo, q_hi, torch.where(empty, -1.0, scale),
            torch.where(empty, 0.0, zero))


def dequantize_summaries(q_lo: torch.Tensor, q_hi: torch.Tensor,
                         scale: torch.Tensor, zero: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``quantize_summaries``: codes (..., D) + fp32 (scale,
    zero) (...,) → fp32 bounds; ``scale < 0`` (empty) → ±inf."""
    lo = zero[..., None] + q_lo.float() * scale[..., None]
    hi = zero[..., None] + q_hi.float() * scale[..., None]
    valid = (scale >= 0.0)[..., None]
    return (torch.where(valid, lo, float("inf")),
            torch.where(valid, hi, float("-inf")))


def plan_summary_bounds(plan: PlanState
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plan's block bounds as fp32 (±inf marks empty blocks),
    whatever backend stores them (``k_scale`` present ⇔ int8)."""
    if "k_scale" in plan:
        return dequantize_summaries(plan["k_min"], plan["k_max"],
                                    plan["k_scale"], plan["k_zero"])
    return plan["k_min"], plan["k_max"]


def degraded_summary_bounds(plan: PlanState,
                            quant: Optional[torch.Tensor]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``plan_summary_bounds`` with the per-slot ``quant`` rung: flagged
    slots rank from an int8 quantize → dequantize round trip of their
    fp32 bounds (conservative, so containment holds); unflagged slots
    pass through bitwise.  A no-op when the backend already stores
    int8 codes."""
    k_min, k_max = plan_summary_bounds(plan)
    if quant is None or "k_scale" in plan:
        return k_min, k_max
    d_lo, d_hi = dequantize_summaries(*quantize_summaries(k_min, k_max))
    m = quant[:, None, None, None]
    return torch.where(m, d_lo, k_min), torch.where(m, d_hi, k_max)


def clamp_plan_budget(occ: torch.Tensor, blk_score: torch.Tensor,
                      budget: torch.Tensor) -> torch.Tensor:
    """Cap the selected blocks per (slot, kv head) at the slot's QoS
    ``budget``: keep the top-``budget`` selected blocks by best token
    score.  occ: (B, KV, nkb) bool; blk_score: (B, KV, nkb) fp32;
    budget: (B,) int."""
    s = torch.where(occ, blk_score, NEG_INF)
    thr = kth_largest_bisect(s, budget[:, None, None])        # (B, KV, 1)
    return occ & bisect_select(s, thr)


def init_decode_plan(batch: int, n_kv_heads: int, max_len: int, d: int,
                     k_block: int, plan_blocks: Optional[int] = None,
                     summary: str = "fp32", *, device, qos: bool = False,
                     replan_interval: int = 1,
                     retire: bool = False) -> PlanState:
    """Empty plan over a ``max_len`` cache.  ``plan_blocks`` (P) is the
    plan width; ``None`` keeps the full ``nkb`` (exact).  ``summary``
    picks the bounds backend.  ``qos=True`` adds the knob vectors at
    full quality (budget P, interval ``replan_interval``, no quant, no
    sketch); ``retire=True`` adds ``imp`` (zeros) and ``live_blk``
    (all live).  Without them the state has neither field."""
    assert max_len % k_block == 0, (max_len, k_block)
    assert summary in SUMMARY_BACKENDS, summary
    nkb = max_len // k_block
    p = nkb if plan_blocks is None else min(int(plan_blocks), nkb)
    assert p >= 1, p
    f32, i32 = torch.float32, torch.int32
    shape = (batch, n_kv_heads, nkb, d)
    if summary == "int8":
        bounds = {
            "k_min": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_max": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.full(shape[:3], -1.0, dtype=f32,
                                  device=device),
            "k_zero": torch.zeros(shape[:3], dtype=f32, device=device),
        }
    else:
        bounds = {
            "k_min": torch.full(shape, float("inf"), dtype=f32,
                                device=device),
            "k_max": torch.full(shape, float("-inf"), dtype=f32,
                                device=device),
        }
    extra = {}
    if qos:
        extra.update(
            budget=torch.full((batch,), p, dtype=i32, device=device),
            interval=torch.full((batch,), max(int(replan_interval), 1),
                                dtype=i32, device=device),
            quant=torch.zeros((batch,), dtype=torch.bool, device=device),
            sketch=torch.zeros((batch,), dtype=torch.bool, device=device))
    if retire:
        extra.update(
            imp=torch.zeros(shape[:3], dtype=f32, device=device),
            live_blk=torch.ones((batch, nkb), dtype=torch.bool,
                                device=device))
    return {
        **bounds,
        **extra,
        "kv_indices": torch.zeros((batch, n_kv_heads, p), dtype=i32,
                                  device=device),
        "kv_counts": torch.zeros((batch, n_kv_heads), dtype=i32,
                                 device=device),
        "step": torch.zeros((batch,), dtype=i32, device=device),
        # cumulative over the slot's pool lifetime (NOT reset on claim):
        # serving accounts re-plan traffic by its monotone delta
        "churn": torch.zeros((batch,), dtype=f32, device=device),
        "replans": torch.zeros((batch,), dtype=i32, device=device),
        # only active slots age, fire re-plan beats and count re-plans
        "active": torch.ones((batch,), dtype=torch.bool, device=device),
    }


def reset_plan_slot(plan: PlanState, slot, *, batch_axis: int = 0
                    ) -> PlanState:
    """Reset one batch slot's plan to the init state, in place (a
    claimed slot must not inherit the previous request's summaries).
    ``batch_axis`` names the batch dimension of layer-stacked states.
    ``replans`` stays — it is the cumulative traffic counter."""
    ix = (slice(None),) * batch_axis + (slot,)
    if "k_scale" in plan:            # int8 backend: sentinel = empty
        plan["k_min"][ix] = 0
        plan["k_max"][ix] = 0
        plan["k_scale"][ix] = -1.0
        plan["k_zero"][ix] = 0.0
    else:
        plan["k_min"][ix] = float("inf")
        plan["k_max"][ix] = float("-inf")
    plan["kv_indices"][ix] = 0
    plan["kv_counts"][ix] = 0
    plan["step"][ix] = 0
    plan["churn"][ix] = 0.0
    plan["active"][ix] = True
    if "imp" in plan:                # retirement restarts with the occupant
        plan["imp"][ix] = 0.0
        plan["live_blk"][ix] = True
    return plan


def release_plan_slot(plan: PlanState, slot, *, batch_axis: int = 0
                      ) -> PlanState:
    """Mark one slot inactive in place: its request completed (or was
    preempted), so it stops aging and never fires a re-plan beat until
    a new claim re-activates it."""
    ix = (slice(None),) * batch_axis + (slot,)
    plan["active"][ix] = False
    return plan


# A slot's complete plan state — what host-swap preemption moves besides
# its pages: summaries, selected blocks, the re-plan beat (``step``),
# churn, the cumulative re-plan counter, liveness and the retirement
# state (a restored slot must not re-plan blocks whose pages were
# reclaimed); names absent from the plan are skipped.  The QoS knobs are
# not here: a rung belongs to the serving slot, and the serve loop
# pushes the knob vectors on every admission and rung change.
PLAN_SLOT_FIELDS = ("k_min", "k_max", "k_scale", "k_zero", "kv_indices",
                    "kv_counts", "step", "churn", "replans", "active",
                    "imp", "live_blk")


def capture_plan_slot(plan: PlanState, slot, *, batch_axis: int = 0
                      ) -> Dict[str, np.ndarray]:
    """Host snapshot of one slot's plan state.  Each field is an owning
    numpy copy taken synchronously (a CPU tensor's ``.numpy()`` would be
    a view of the live plan, which the slot's next occupant rewrites);
    ``install_plan_slot`` puts it back bitwise."""
    ix = (slice(None),) * batch_axis + (slot,)
    return {name: plan[name][ix].to("cpu", copy=True).numpy()
            for name in PLAN_SLOT_FIELDS if name in plan}


def install_plan_slot(plan: PlanState, slot, saved: Dict[str, np.ndarray],
                      *, batch_axis: int = 0) -> PlanState:
    """Reset-free reinstall of a ``capture_plan_slot`` snapshot into
    ``slot``, in place and bitwise — ``step`` included, so the first
    step after a restore keeps the slot's re-plan beat instead of
    running a cold full re-plan, and ``active`` (captured live)."""
    ix = (slice(None),) * batch_axis + (slot,)
    for name, val in saved.items():
        t = plan[name]
        t[ix] = torch.from_numpy(np.asarray(val)).to(t.device, t.dtype)
    return plan


def update_block_summaries(plan: PlanState, k_new: torch.Tensor,
                           pos: torch.Tensor, *, k_block: int) -> PlanState:
    """Absorb one appended key per slot into its block's bounds, in
    place.  k_new: (B, 1, KV, D) — the value actually written to the
    cache; pos: (B,) write positions.  A position past the cache (an
    idle slot's stale position) updates nothing, as the reference's
    out-of-bounds scatter drops it.  The int8 backend dequantizes the
    touched block, absorbs the key and requantizes outward, so
    containment of the exact bounds carries over every append."""
    kn = k_new[:, 0].float()                                  # (B, KV, D)
    b, kv, _ = kn.shape
    nkb = plan["k_min"].shape[2]
    blk = (pos // k_block).long()
    inb = (blk < nkb)[:, None]
    bi = torch.arange(b, device=kn.device)[:, None]
    ki = torch.arange(kv, device=kn.device)[None, :]
    bx = blk.clamp(max=nkb - 1)[:, None]
    ix = (bi, ki, bx)
    if "k_scale" not in plan:
        lo, hi = plan["k_min"][ix], plan["k_max"][ix]
        plan["k_min"][ix] = torch.where(inb[..., None],
                                        torch.minimum(lo, kn), lo)
        plan["k_max"][ix] = torch.where(inb[..., None],
                                        torch.maximum(hi, kn), hi)
        return plan
    old = [plan[n][ix] for n in ("k_min", "k_max", "k_scale", "k_zero")]
    lo, hi = dequantize_summaries(*old)
    new = quantize_summaries(torch.minimum(lo, kn), torch.maximum(hi, kn))
    for n, o, v in zip(("k_min", "k_max", "k_scale", "k_zero"), old, new):
        keep = inb[..., None] if v.dim() == 3 else inb
        plan[n][ix] = torch.where(keep, v, o)
    return plan


def summaries_from_cache(k_cache: torch.Tensor, pos: torch.Tensor, *,
                         k_block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """From-scratch reference for the incremental summaries: per-block
    elementwise min/max over the cached keys at positions ``<= pos``
    (empty blocks keep ±inf).  k_cache: (B, S, KV, D); pos: (B,).
    Returns (k_min, k_max) shaped (B, KV, nkb, D)."""
    b, s, kv, d = k_cache.shape
    nkb = s // k_block
    kf = k_cache.float().permute(0, 2, 1, 3)                  # (B, KV, S, D)
    valid = (torch.arange(s, device=k_cache.device)
             <= pos[:, None])[:, None, :, None]
    lo = torch.where(valid, kf, float("inf")).reshape(b, kv, nkb, k_block, d)
    hi = torch.where(valid, kf, float("-inf")).reshape(b, kv, nkb, k_block, d)
    return lo.amin(dim=3), hi.amax(dim=3)


def _compact_rows(occ: torch.Tensor, pad_to: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, KV, nkb) bool occupancy → ascending selected-block lists in
    ``compact_kv_plan``'s padded layout, clamped to ``pad_to`` slots."""
    b, kv, nkb = occ.shape
    idx, cnt = compact_kv_plan(occ.reshape(b * kv, 1, nkb),
                               pad_to=min(pad_to, nkb), truncate=True)
    return idx.reshape(b, kv, -1), cnt.reshape(b, kv)


def block_upper_bounds(q: torch.Tensor, k_min: torch.Tensor,
                       k_max: torch.Tensor, *, sm_scale: float
                       ) -> torch.Tensor:
    """Quest-style score upper bound per (slot, kv head, q row, block):
    ``sum_d max(q_d·k_min_d, q_d·k_max_d)`` — positive q components can
    at most hit ``k_max``, negative ones ``k_min``.
    q: (B, KV, G, D); k_min/k_max: (B, KV, nkb, D) (±inf pre-masked).
    Returns (B, KV, G, nkb) fp32."""
    lo = torch.einsum("bkgd,bknd->bkgn", torch.clamp(q, max=0.0), k_min)
    hi = torch.einsum("bkgd,bknd->bkgn", torch.clamp(q, min=0.0), k_max)
    return (lo + hi) * sm_scale


def _scores(q: torch.Tensor, keys: torch.Tensor, sm_scale: float
            ) -> torch.Tensor:
    """fp32 scores (B, KV, G, T) of q (B, KV, G, D) against contiguous
    keys (B, KV, T, D).  Every planner scores through this one GEMM
    layout, so a key set scores bitwise alike whichever planner gathered
    it (``sketch_replan`` covering every block equals ``full_replan``
    on the card, too)."""
    return torch.matmul(q.float(), keys.float().transpose(-1, -2)) * sm_scale


def full_replan(q: torch.Tensor, k_cache: torch.Tensor, pos: torch.Tensor,
                *, topk_k: int, k_block: int, plan_blocks: int,
                budget: Optional[torch.Tensor] = None,
                live_blk: Optional[torch.Tensor] = None, over=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact per-step plan: score all cached keys, bisect each query
    row's top-k threshold, keep every block with a selected token.
    q: (B, KV, G, D); k_cache: (B, S, KV, D) logical; pos: (B,).
    Returns (kv_indices (B, KV, P), kv_counts (B, KV),
    thresholds (B, KV, G, 1) fp32).

    ``budget`` (B,) caps the kept blocks per (slot, head): the selected
    blocks ranked by best token score, the top ``budget`` kept and the
    threshold re-bisected over their tokens only.  ``live_blk`` (B, nkb)
    takes retired blocks' tokens out of the score multiset.

    ``over`` (``distributed.sharding.KeySplit``): ``k_cache`` is a rank's
    share of every slot's keys and ``pos`` each slot's position in it
    (``KeySplit.local_pos``: below 0 or past the share where the slot's
    position lies before or after it), so validity is the global
    positions'; the threshold is bisected over the whole row
    (``kth_largest_bisect(over=)``) and the rank keeps its blocks that
    hold a selected token, in its own block ids."""
    b, s, kv, d = k_cache.shape
    nkb = s // k_block
    sm_scale = 1.0 / np.sqrt(d)
    # a fresh contiguous fp32 copy whatever the cache's dtype (``.to``
    # returns an fp32 cache's strided view as it is, and the CPU's BLAS
    # sums a strided operand in another order)
    keys = torch.empty((b, kv, s, d), dtype=torch.float32,
                       device=k_cache.device)
    keys.copy_(k_cache.permute(0, 2, 1, 3))
    sc = _scores(q, keys, sm_scale)                           # (B,KV,G,S)
    valid = (torch.arange(s, device=sc.device)
             <= pos[:, None])[:, None, None, :]               # (B,1,1,S)
    if live_blk is not None:
        valid = valid & live_blk.repeat_interleave(k_block, dim=-1)[
            :, None, None, :]
    sc = torch.where(valid, sc, NEG_INF)
    thr = kth_largest_bisect(sc, topk_k, over=over)           # (B, KV, G, 1)
    sel = bisect_select(torch.where(valid, sc, float("-inf")), thr) & valid
    occ = sel.reshape(b, kv, -1, nkb, k_block).any(dim=4).any(dim=2)
    if budget is not None:
        blk_score = sc.amax(dim=2).reshape(b, kv, nkb, k_block).amax(-1)
        occ = clamp_plan_budget(occ, blk_score, budget)
        keep = occ.repeat_interleave(k_block, dim=-1)         # (B, KV, S)
        thr = kth_largest_bisect(
            torch.where(keep[:, :, None, :], sc, NEG_INF), topk_k)
    kv_indices, kv_counts = _compact_rows(occ, plan_blocks)
    return kv_indices, kv_counts, thr


def gather_planned_keys(k_cache: torch.Tensor, kv_indices: torch.Tensor, *,
                        k_block: int,
                        page_table: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fetch only the planned blocks' keys: (B, KV, P·k_block, D) plus
    their logical token positions (B, KV, P·k_block).

    Contiguous: k_cache (B, S, KV, D).  Paged (``page_table``
    (B, max_pages) given): k_cache is the pool (n_pages, page, KV, D)
    with page == k_block, and each planned logical block dereferences
    the table to its physical page."""
    b, kv, p = kv_indices.shape
    dev = k_cache.device
    tok = (kv_indices.long()[..., None] * k_block
           + torch.arange(k_block, device=dev))               # (B,KV,P,kb)
    tok = tok.reshape(b, kv, -1)
    hi = torch.arange(kv, device=dev)[None, :, None]
    if page_table is None:
        bi = torch.arange(b, device=dev)[:, None, None]
        return k_cache[bi, tok, hi], tok                      # (B,KV,P·kb,D)
    phys = torch.gather(page_table.long(), 1,
                        kv_indices.long().reshape(b, -1)).reshape(b, kv, p)
    kg = k_cache.movedim(2, 0)[hi, phys]                      # (B,KV,P,pg,D)
    return kg.reshape(b, kv, p * k_block, k_cache.shape[-1]), tok


def _valid_blocks(plan: PlanState, pos: torch.Tensor, k_block: int
                  ) -> torch.Tensor:
    """(B, nkb) blocks holding a token at or before ``pos`` and, with
    retirement, not retired."""
    nkb = plan["k_min"].shape[2]
    valid = (torch.arange(nkb, device=pos.device) * k_block
             <= pos[:, None])
    if "live_blk" in plan:
        valid = valid & plan["live_blk"]
    return valid


def incremental_plan(q: torch.Tensor, k_cache: torch.Tensor,
                     plan: PlanState, pos: torch.Tensor, *, topk_k: int,
                     k_block: int, page_table: Optional[torch.Tensor] = None,
                     budget: Optional[torch.Tensor] = None,
                     quant: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Approximate per-step plan from the block summaries: rank valid
    blocks by their upper-bound score, keep the top P, then bisect the
    exact token threshold over the planned blocks only.  Shapes as
    ``full_replan``; with ``page_table`` set, ``k_cache`` is the pool.
    Cost: O(nkb·D) ranking + O(P·k_block·D) threshold.  ``budget`` (B,)
    ranks the top ``budget`` blocks instead of P; ``quant`` (B,) ranks
    flagged slots from int8-rounded bounds; a plan with ``live_blk``
    never ranks a retired block."""
    b, kv, _, d = q.shape
    p = plan["kv_indices"].shape[-1]
    sm_scale = 1.0 / np.sqrt(d)
    dev = q.device
    valid_blk = _valid_blocks(plan, pos, k_block)             # (B, nkb)
    vb = valid_blk[:, None, :, None]
    k_min, k_max = degraded_summary_bounds(plan, quant)       # fp32 either way
    ub = block_upper_bounds(q.float(),
                            torch.where(vb, k_min, 0.0),
                            torch.where(vb, k_max, 0.0),
                            sm_scale=sm_scale)                # (B,KV,G,nkb)
    ub_row = torch.where(valid_blk[:, None, :], ub.amax(dim=2), NEG_INF)
    # top-P blocks per (slot, kv head): the token-level bisect predicate
    # applied at block granularity (a budget narrows it per slot)
    p_row = p if budget is None else budget[:, None, None]
    thr_b = kth_largest_bisect(ub_row, p_row)                 # (B, KV, 1)
    occ = bisect_select(ub_row, thr_b) & valid_blk[:, None, :]
    kv_indices, kv_counts = _compact_rows(occ, p)
    kg, tok = gather_planned_keys(k_cache, kv_indices, k_block=k_block,
                                  page_table=page_table)
    sc = _scores(q, kg, sm_scale)
    slot = torch.arange(p * k_block, device=dev) // k_block
    live = slot[None, None, :] < kv_counts[..., None]         # no dup pads
    live = live & (tok <= pos[:, None, None])
    sc = torch.where(live[:, :, None, :], sc, NEG_INF)
    thr = kth_largest_bisect(sc, topk_k)                      # (B, KV, G, 1)
    return kv_indices, kv_counts, thr


def sketch_geometry(nkb: int, plan_blocks: int, sketch_factor: int
                    ) -> Tuple[int, int, int, int]:
    """Shape arithmetic shared by ``sketch_replan`` and the plan-traffic
    accounting: ``(F, nsb, C, C·F)`` — the super-block factor F (largest
    divisor of ``nkb`` ≤ ``sketch_factor``), the super-block count, the
    surviving super-block budget ``C = ceil(P / F)`` and the candidate
    blocks the exact threshold pass then reads."""
    f = max(1, min(int(sketch_factor), nkb))
    while nkb % f:
        f -= 1
    nsb = nkb // f
    c = min(max(1, -(-int(plan_blocks) // f)), nsb)
    return f, nsb, c, c * f


def sketch_replan(q: torch.Tensor, k_cache: torch.Tensor, plan: PlanState,
                  pos: torch.Tensor, *, topk_k: int, k_block: int,
                  sketch_factor: int = 4,
                  page_table: Optional[torch.Tensor] = None,
                  budget: Optional[torch.Tensor] = None,
                  quant: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-level re-plan, the sub-linear stand-in for ``full_replan``.

    Level 1 unions each run of F adjacent block summaries into a
    super-block sketch, ranks the sketches by the Quest upper bound and
    keeps the top ``C = ceil(P/F)``.  Level 2 gathers only those
    ``C·F`` candidate blocks, bisects the per-row token threshold over
    them and keeps every candidate block holding a selected token.
    Reads drop from O(S·D) to O(nkb·D + C·F·k_block·D).  Approximate by
    design; when ``C·F ≥ nkb`` every valid block is a candidate and the
    result equals ``full_replan`` bitwise.  Shapes as ``full_replan``;
    with ``page_table`` set, ``k_cache`` is the pool.  ``budget`` (B,)
    narrows both levels per slot (``ceil(budget/F)`` super-blocks, then
    the block cap of ``full_replan``); ``quant`` (B,) ranks flagged
    slots' sketches from int8-rounded bounds; retired blocks are never
    ranked nor scored."""
    b, kv, gq, d = q.shape
    k_min, k_max = degraded_summary_bounds(plan, quant)
    nkb = k_min.shape[2]
    p = plan["kv_indices"].shape[-1]
    f, nsb, c, _ = sketch_geometry(nkb, p, sketch_factor)
    sm_scale = 1.0 / np.sqrt(d)
    dev = q.device
    valid_blk = _valid_blocks(plan, pos, k_block)             # (B, nkb)
    vb = valid_blk[:, None, :, None]
    lo = torch.where(vb, k_min, 0.0)
    hi = torch.where(vb, k_max, 0.0)
    slo = lo.reshape(b, kv, nsb, f, d).amin(dim=3)            # sketch =
    shi = hi.reshape(b, kv, nsb, f, d).amax(dim=3)            # bound union
    ub = block_upper_bounds(q.float(), slo, shi,
                            sm_scale=sm_scale)                # (B,KV,G,nsb)
    valid_sb = valid_blk.reshape(b, nsb, f).any(dim=-1)
    ub_row = torch.where(valid_sb[:, None, :], ub.amax(dim=2), NEG_INF)
    # a budget narrows the surviving super-block count per slot
    c_row = c if budget is None else \
        torch.clamp((budget[:, None, None] + f - 1) // f, 1, c)
    thr_sb = kth_largest_bisect(ub_row, c_row)                # (B, KV, 1)
    occ_sb = bisect_select(ub_row, thr_sb) & valid_sb[:, None, :]
    sb_idx, sb_cnt = _compact_rows(occ_sb, c)                 # (B, KV, C)
    cand = (sb_idx.long()[..., None] * f
            + torch.arange(f, device=dev)).reshape(b, kv, c * f)
    # exact token threshold, restricted to the candidate blocks
    kg, tok = gather_planned_keys(k_cache, cand, k_block=k_block,
                                  page_table=page_table)
    sc = _scores(q, kg, sm_scale)
    sb_slot = torch.arange(c * f * k_block, device=dev) // (f * k_block)
    live = sb_slot[None, None, :] < sb_cnt[..., None]         # no dup pads
    live = live & (tok <= pos[:, None, None])
    if "live_blk" in plan:
        # a surviving super-block may straddle retired blocks, whose
        # freed pages must never reach the threshold multiset
        lv = torch.gather(plan["live_blk"][:, None, :].expand(b, kv, nkb),
                          2, cand)
        live = live & lv.repeat_interleave(k_block, dim=-1)
    live = live[:, :, None, :]
    sc = torch.where(live, sc, NEG_INF)
    thr = kth_largest_bisect(sc, topk_k)                      # (B, KV, G, 1)
    sel = bisect_select(torch.where(live, sc, float("-inf")), thr) & live
    sel_blk = sel.reshape(b, kv, gq, c * f, k_block).any(dim=4).any(dim=2)
    if budget is not None:
        cand_score = sc.amax(dim=2).reshape(b, kv, c * f, k_block).amax(-1)
        sel_blk = clamp_plan_budget(sel_blk, cand_score, budget)
        keep = sel_blk.repeat_interleave(k_block, dim=-1)     # (B,KV,C·F·kb)
        thr = kth_largest_bisect(
            torch.where(keep[:, :, None, :], sc, NEG_INF), topk_k)
    # scatter back to block occupancy; a padded (repeated) candidate
    # contributes nothing, and duplicates OR together
    occ = torch.zeros((b, kv, nkb), dtype=torch.int32, device=dev)
    occ.scatter_add_(2, cand, sel_blk.to(torch.int32))
    kv_indices, kv_counts = _compact_rows(occ > 0, p)
    return kv_indices, kv_counts, thr


def _plan_occupancy(kv_indices: torch.Tensor, kv_counts: torch.Tensor,
                    nkb: int) -> torch.Tensor:
    """(B, KV, P) padded index lists → (B, KV, nkb) bool occupancy
    (padding slots past the count are ignored)."""
    dev = kv_indices.device
    hit = kv_indices[..., None] == torch.arange(nkb, device=dev)
    live = (torch.arange(kv_indices.shape[-1], device=dev)
            < kv_counts[..., None])[..., None]
    return (hit & live).any(dim=-2)


def plan_churn(plan: PlanState, kv_indices: torch.Tensor,
               kv_counts: torch.Tensor) -> torch.Tensor:
    """Blocks entering + leaving between the carried plan and this
    step's, per slot (mean over kv heads) — the drift signal the
    churn-adaptive trigger integrates.  (B,) fp32."""
    nkb = plan["k_min"].shape[2]
    o_old = _plan_occupancy(plan["kv_indices"], plan["kv_counts"], nkb)
    o_new = _plan_occupancy(kv_indices, kv_counts, nkb)
    return (o_old ^ o_new).sum(dim=-1).float().mean(dim=-1)


_SUB_FIELDS = ("k_min", "k_max", "k_scale", "k_zero", "kv_indices",
               "live_blk")


def _check_key_split(plan: PlanState, replan_interval: int,
                     churn_budget: Optional[float], replan_mode: str,
                     page_table) -> None:
    """Refuse, by name, what context-parallel decode does not plan."""
    whole_row = "ranks blocks across the whole row, which no rank holds"
    refused = [
        (replan_interval > 1, f"the incremental plan (replan="
                              f"{replan_interval}) {whole_row}"),
        (churn_budget is not None, f"the churn-adaptive trigger "
                                   f"(replan='auto') {whole_row}"),
        (replan_mode == "sketch", f"the sketch re-plan (replan_mode="
                                  f"'sketch') {whole_row}"),
        ("budget" in plan, f"the QoS ladder's budget (sata.qos.ladder) "
                           f"{whole_row}"),
        ("live_blk" in plan, f"retirement (sata.retire.mode='on') "
                             f"{whole_row}"),
        (page_table is not None, "the paged layout has no sequence dim "
                                 "to split"),
    ]
    for bad, what in refused:
        if bad:
            raise ValueError(f"context-parallel decode (CACHE_SEQ_SHARD) "
                             f"re-plans exactly every step only: {what}")


def decode_plan_update(plan: PlanState, q: torch.Tensor,
                       k_cache: torch.Tensor, pos: torch.Tensor, *,
                       topk_k: int, k_block: int, replan_interval: int = 1,
                       churn_budget: Optional[float] = None,
                       page_table: Optional[torch.Tensor] = None,
                       replan_mode: str = "exact", sketch_factor: int = 4,
                       retire_decay: float = 0.9, over=None
                       ) -> Tuple[PlanState, torch.Tensor]:
    """One decode step of plan maintenance (the summaries must already
    hold the step's appended key — call ``update_block_summaries``
    first).  Updates ``plan`` in place and returns it with the per-row
    thresholds for the decode kernel.

    Trigger, per slot: with ``churn_budget`` set a slot re-plans at its
    step 0 and once the churn it accumulated over incremental steps
    reaches ``churn_budget · P``; otherwise every ``replan_interval``-th
    step of the slot re-plans (``1`` = exact every step).  The re-plan
    is ``full_replan`` or, with ``replan_mode="sketch"``,
    ``sketch_replan``; other steps run the incremental plan.  A step
    whose active slots disagree takes the partial re-plan — a host loop
    over slots that streams the cache only for the slots that trigger.
    ``replans`` counts the re-plans of active slots, as the reference
    does.

    With the QoS knobs in the plan each slot triggers on its own
    ``interval``, and every step loops over the slots one at a time:
    each plans at batch 1 under its own ``budget`` / ``quant``, and a
    ``sketch`` slot re-plans hierarchically.  The knobs own the beat, so
    the churn trigger is refused.  With the retirement state, active
    slots' importance decays and absorbs this step's planned blocks:
    ``imp ← retire_decay · imp + planned``.

    ``over`` (``distributed.sharding.KeySplit``, context-parallel
    decode): ``k_cache`` and the plan are a rank's share of the keys and
    ``pos`` the slots' local positions; only the exact re-plan every
    step runs (``full_replan(over=)``).  Every other mode ranks blocks
    across the whole row and raises: the incremental plan, the sketch
    re-plan, the churn trigger, the QoS knobs and retirement."""
    assert replan_mode in ("exact", "sketch"), replan_mode
    if over is not None:
        _check_key_split(plan, replan_interval, churn_budget, replan_mode,
                         page_table)
    p = plan["kv_indices"].shape[-1]
    qos = "budget" in plan
    assert not (qos and churn_budget is not None), \
        "QoS ladder owns the re-plan beat; use an integer interval"
    active = plan["active"]
    if qos:
        # each slot's own beat; step 0 lands on every beat, so a cold
        # slot re-plans first
        do_full = ((plan["step"] % plan["interval"].clamp(min=1)) == 0) \
            & active
    elif churn_budget is not None:
        do_full = ((plan["step"] == 0)
                   | (plan["churn"] >= churn_budget * p)) & active
    elif replan_interval <= 1:
        do_full = active
    else:
        do_full = (plan["step"] % replan_interval == 0) & active

    def _full(qb, kc, posb, sub, tbl, bud=None, qnt=None, skt=False):
        if replan_mode == "sketch" or skt:
            return sketch_replan(qb, kc, sub, posb, topk_k=topk_k,
                                 k_block=k_block,
                                 sketch_factor=sketch_factor,
                                 page_table=tbl, budget=bud, quant=qnt)
        kf = kc if tbl is None else logical_kv_view(kc, tbl)
        return full_replan(qb, kf, posb, topk_k=topk_k, k_block=k_block,
                           plan_blocks=p, budget=bud,
                           live_blk=sub.get("live_blk"), over=over)

    def _incr(qb, kc, posb, sub, tbl, bud=None, qnt=None, skt=False):
        return incremental_plan(qb, kc, sub, posb, topk_k=topk_k,
                                k_block=k_block, page_table=tbl,
                                budget=bud, quant=qnt)

    def _per_slot(flags, knobs):
        # a real per-slot branch at batch 1: untriggered slots never
        # stream their cache, and under the knobs each slot's products
        # keep one shape whatever its neighbours' rungs
        outs = []
        for i, f in enumerate(flags):
            sl = slice(i, i + 1)
            kc = k_cache if page_table is not None else k_cache[sl]
            tbl = None if page_table is None else page_table[sl]
            sub = {k: plan[k][sl] for k in _SUB_FIELDS if k in plan}
            kw = {}
            if knobs is not None:
                # an unflagged slot's bounds pass through quantization
                # bitwise, so it skips the round trip
                kw = dict(bud=plan["budget"][sl],
                          qnt=plan["quant"][sl] if knobs[0][i] else None,
                          skt=knobs[1][i])
            outs.append((_full if f else _incr)(q[sl], kc, pos[sl], sub,
                                                tbl, **kw))
        return (torch.cat(t) for t in zip(*outs))

    if qos:
        flags, *knobs = torch.stack(
            [do_full, plan["quant"], plan["sketch"]]).tolist()
        kv_indices, kv_counts, thr = _per_slot(flags, knobs)
    elif replan_interval <= 1 and churn_budget is None:
        # exact mode re-plans every slot (idle ones ride the batched
        # einsum for free); ``do_full`` still scopes the accounting
        sub = {k: plan[k] for k in _SUB_FIELDS if k in plan}
        kv_indices, kv_counts, thr = _full(q, k_cache, pos, sub, page_table)
    else:
        flags = do_full.tolist()
        sub = {k: plan[k] for k in _SUB_FIELDS if k in plan}
        if all(flags):
            kv_indices, kv_counts, thr = _full(q, k_cache, pos, sub,
                                               page_table)
        elif not any(flags):
            kv_indices, kv_counts, thr = _incr(q, k_cache, pos, sub,
                                               page_table)
        else:
            kv_indices, kv_counts, thr = _per_slot(flags, None)
    if churn_budget is not None:
        drift = plan_churn(plan, kv_indices, kv_counts)
        plan["churn"].copy_(torch.where(do_full, 0.0, plan["churn"] + drift))
    plan["kv_indices"].copy_(kv_indices)
    plan["kv_counts"].copy_(kv_counts)
    plan["step"] += active.to(torch.int32)
    plan["replans"] += do_full.to(torch.int32)
    if "imp" in plan:
        # cumulative importance from the plan's own output (no extra
        # cache reads); idle slots freeze
        sel = _plan_occupancy(kv_indices, kv_counts, plan["imp"].shape[-1])
        imp = plan["imp"] * retire_decay + sel.to(torch.float32)
        plan["imp"].copy_(torch.where(active[:, None, None], imp,
                                      plan["imp"]))
    return plan, thr


def retire_plan_blocks(plan: PlanState, slot, blocks, *,
                       batch_axis: int = 0) -> PlanState:
    """Plan repair after a retirement pass freed one slot's ``blocks``,
    in place: the blocks leave ``live_blk``, their summaries return to
    the empty sentinel of the backend, their importance is zeroed, and
    the slot's planned rows are compacted again over the survivors (the
    untouched entries round-trip bitwise).  Positions stay logical, so
    causality and RoPE are untouched.  ``batch_axis`` names the batch
    dimension of layer-stacked states."""
    assert "live_blk" in plan, "plan was not initialized with retire=True"
    ix = (slice(None),) * batch_axis + (slot,)
    nkb = plan["live_blk"].shape[-1]
    p = plan["kv_indices"].shape[-1]
    m = torch.zeros((nkb,), dtype=torch.bool,
                    device=plan["live_blk"].device)
    m[torch.as_tensor(np.asarray(blocks, np.int64), device=m.device)] = True
    plan["live_blk"][ix] &= ~m
    plan["imp"][ix].masked_fill_(m, 0.0)
    if "k_scale" in plan:            # int8 backend: sentinel = empty
        plan["k_min"][ix].masked_fill_(m[:, None], 0)
        plan["k_max"][ix].masked_fill_(m[:, None], 0)
        plan["k_scale"][ix].masked_fill_(m, -1.0)
        plan["k_zero"][ix].masked_fill_(m, 0.0)
    else:
        plan["k_min"][ix].masked_fill_(m[:, None], float("inf"))
        plan["k_max"][ix].masked_fill_(m[:, None], float("-inf"))
    idx, cnt = plan["kv_indices"][ix], plan["kv_counts"][ix]
    lead = idx.shape[:-2]                # () or (L,) layer-stacked
    occ = _plan_occupancy(idx.reshape((-1,) + idx.shape[-2:]),
                          cnt.reshape((-1,) + cnt.shape[-1:]), nkb)
    ni, nc = _compact_rows(occ & ~m, p)
    idx.copy_(ni.reshape(lead + ni.shape[-2:]))
    cnt.copy_(nc.reshape(lead + nc.shape[-1:]))
    return plan


def plan_from_prefill(k_cache: torch.Tensor, q_tail: torch.Tensor,
                      pos: torch.Tensor, *, topk_k: int, k_block: int,
                      plan_blocks: Optional[int] = None,
                      summary: str = "fp32") -> PlanState:
    """Seed a decode-plan state from prefill outputs: summaries from the
    written keys (bit-identical to incremental maintenance; the int8
    backend quantizes them once, so a page-summary copy of the same
    bounds is bit-identical too), the plan rows from the prompt tail's
    selected blocks, and ``step = 1`` — off the re-plan beat, so decode
    step 0 runs the planned incremental path instead of a cold full
    re-plan.
    k_cache: (B, S, KV, D) logical; q_tail: (B, KV, G, D); pos: (B,)."""
    b, s, kv, d = k_cache.shape
    plan = init_decode_plan(b, kv, s, d, k_block, plan_blocks,
                            summary=summary, device=k_cache.device)
    k_min, k_max = summaries_from_cache(k_cache, pos, k_block=k_block)
    p = plan["kv_indices"].shape[-1]
    kv_indices, kv_counts, _ = full_replan(q_tail, k_cache, pos,
                                           topk_k=topk_k, k_block=k_block,
                                           plan_blocks=p)
    plan.update(kv_indices=kv_indices, kv_counts=kv_counts)
    if summary == "int8":
        q_lo, q_hi, sc, zp = quantize_summaries(k_min, k_max)
        plan.update(k_min=q_lo, k_max=q_hi, k_scale=sc, k_zero=zp)
    else:
        plan.update(k_min=k_min, k_max=k_max)
    plan["step"].fill_(1)
    return plan
