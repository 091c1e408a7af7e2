"""Decode-path SATA: incremental per-slot KV-block plan — port of
``repro.core.decode_plan`` (fp32 summaries, exact re-plans, fixed
integer re-plan interval).

Per batch slot and KV head the plan state keeps

  k_min / k_max  (B, KV, nkb, D) fp32 — elementwise key bounds per
                 k-block, absorbed incrementally as the cache grows
                 (min/max is associative, so they equal a from-scratch
                 recompute bit for bit — ``summaries_from_cache``);
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

Two refresh modes blend by ``replan_interval``: an exact full re-plan
(score every cached key, bisect each query row's top-k threshold, keep
every block holding a selected token) and the incremental plan (rank
blocks by the Quest upper bound from the summaries, keep the top P,
bisect the exact token threshold over the planned blocks only).  A step
that mixes triggered and untriggered slots loops over the slots on the
host, so only the triggering slots stream their cache.

The int8 summary backend, sketch re-plans, the churn-adaptive trigger,
the QoS knob vectors and retirement are slice 3 of the port and raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blockmap import bisect_select, compact_kv_plan
from repro_torch.core.paging import logical_kv_view
from repro_torch.core.selection import NEG_INF, kth_largest_bisect

PlanState = Dict[str, torch.Tensor]

_SLICE3 = "slice 3 of the PyTorch port (serving features)"


def _unsupported(what: str):
    return NotImplementedError(f"{what} is not ported yet: {_SLICE3}")


def init_decode_plan(batch: int, n_kv_heads: int, max_len: int, d: int,
                     k_block: int, plan_blocks: Optional[int] = None,
                     summary: str = "fp32", *, device) -> PlanState:
    """Empty plan over a ``max_len`` cache.  ``plan_blocks`` (P) is the
    plan width; ``None`` keeps the full ``nkb`` (exact)."""
    if summary != "fp32":
        raise _unsupported(f"summary backend {summary!r}")
    assert max_len % k_block == 0, (max_len, k_block)
    nkb = max_len // k_block
    p = nkb if plan_blocks is None else min(int(plan_blocks), nkb)
    assert p >= 1, p
    f32, i32 = torch.float32, torch.int32
    return {
        "k_min": torch.full((batch, n_kv_heads, nkb, d), float("inf"),
                            dtype=f32, device=device),
        "k_max": torch.full((batch, n_kv_heads, nkb, d), float("-inf"),
                            dtype=f32, device=device),
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
    plan["k_min"][ix] = float("inf")
    plan["k_max"][ix] = float("-inf")
    plan["kv_indices"][ix] = 0
    plan["kv_counts"][ix] = 0
    plan["step"][ix] = 0
    plan["churn"][ix] = 0.0
    plan["active"][ix] = True
    return plan


def release_plan_slot(plan: PlanState, slot, *, batch_axis: int = 0
                      ) -> PlanState:
    """Mark one slot inactive in place: its request completed (or was
    preempted), so it stops aging and never fires a re-plan beat until
    a new claim re-activates it."""
    ix = (slice(None),) * batch_axis + (slot,)
    plan["active"][ix] = False
    return plan


def update_block_summaries(plan: PlanState, k_new: torch.Tensor,
                           pos: torch.Tensor, *, k_block: int) -> PlanState:
    """Absorb one appended key per slot into its block's min/max bounds,
    in place.  k_new: (B, 1, KV, D) — the value actually written to the
    cache; pos: (B,) write positions.  A position past the cache (an
    idle slot's stale position) updates nothing, as the reference's
    out-of-bounds scatter drops it."""
    if "k_scale" in plan:
        raise _unsupported("the int8 summary backend")
    kn = k_new[:, 0].float()                                  # (B, KV, D)
    b, kv, _ = kn.shape
    nkb = plan["k_min"].shape[2]
    blk = (pos // k_block).long()
    inb = (blk < nkb)[:, None, None]
    bi = torch.arange(b, device=kn.device)[:, None]
    ki = torch.arange(kv, device=kn.device)[None, :]
    bx = blk.clamp(max=nkb - 1)[:, None]
    lo, hi = plan["k_min"][bi, ki, bx], plan["k_max"][bi, ki, bx]
    plan["k_min"][bi, ki, bx] = torch.where(inb, torch.minimum(lo, kn), lo)
    plan["k_max"][bi, ki, bx] = torch.where(inb, torch.maximum(hi, kn), hi)
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


def full_replan(q: torch.Tensor, k_cache: torch.Tensor, pos: torch.Tensor,
                *, topk_k: int, k_block: int, plan_blocks: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact per-step plan: score all cached keys, bisect each query
    row's top-k threshold, keep every block with a selected token.
    q: (B, KV, G, D); k_cache: (B, S, KV, D) logical; pos: (B,).
    Returns (kv_indices (B, KV, P), kv_counts (B, KV),
    thresholds (B, KV, G, 1) fp32)."""
    b, s, kv, d = k_cache.shape
    nkb = s // k_block
    sm_scale = 1.0 / np.sqrt(d)
    sc = torch.einsum("bkgd,bskd->bkgs", q.float(),
                      k_cache.float()) * sm_scale
    valid = (torch.arange(s, device=sc.device)
             <= pos[:, None])[:, None, None, :]               # (B,1,1,S)
    sc = torch.where(valid, sc, NEG_INF)
    thr = kth_largest_bisect(sc, topk_k)                      # (B, KV, G, 1)
    sel = bisect_select(torch.where(valid, sc, float("-inf")), thr) & valid
    occ = sel.reshape(b, kv, -1, nkb, k_block).any(dim=4).any(dim=2)
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


def incremental_plan(q: torch.Tensor, k_cache: torch.Tensor,
                     plan: PlanState, pos: torch.Tensor, *, topk_k: int,
                     k_block: int, page_table: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Approximate per-step plan from the block summaries: rank valid
    blocks by their upper-bound score, keep the top P, then bisect the
    exact token threshold over the planned blocks only.  Shapes as
    ``full_replan``; with ``page_table`` set, ``k_cache`` is the pool.
    Cost: O(nkb·D) ranking + O(P·k_block·D) threshold."""
    if "k_scale" in plan:
        raise _unsupported("the int8 summary backend")
    b, kv, _, d = q.shape
    nkb = plan["k_min"].shape[2]
    p = plan["kv_indices"].shape[-1]
    sm_scale = 1.0 / np.sqrt(d)
    dev = q.device
    valid_blk = (torch.arange(nkb, device=dev) * k_block
                 <= pos[:, None])                             # (B, nkb)
    vb = valid_blk[:, None, :, None]
    ub = block_upper_bounds(q.float(),
                            torch.where(vb, plan["k_min"], 0.0),
                            torch.where(vb, plan["k_max"], 0.0),
                            sm_scale=sm_scale)                # (B,KV,G,nkb)
    ub_row = torch.where(valid_blk[:, None, :], ub.amax(dim=2), NEG_INF)
    # top-P blocks per (slot, kv head): the token-level bisect predicate
    # applied at block granularity
    thr_b = kth_largest_bisect(ub_row, p)                     # (B, KV, 1)
    occ = bisect_select(ub_row, thr_b) & valid_blk[:, None, :]
    kv_indices, kv_counts = _compact_rows(occ, p)
    kg, tok = gather_planned_keys(k_cache, kv_indices, k_block=k_block,
                                  page_table=page_table)
    sc = torch.einsum("bkgd,bktd->bkgt", q.float(), kg.float()) * sm_scale
    slot = torch.arange(p * k_block, device=dev) // k_block
    live = slot[None, None, :] < kv_counts[..., None]         # no dup pads
    live = live & (tok <= pos[:, None, None])
    sc = torch.where(live[:, :, None, :], sc, NEG_INF)
    thr = kth_largest_bisect(sc, topk_k)                      # (B, KV, G, 1)
    return kv_indices, kv_counts, thr


def decode_plan_update(plan: PlanState, q: torch.Tensor,
                       k_cache: torch.Tensor, pos: torch.Tensor, *,
                       topk_k: int, k_block: int, replan_interval: int = 1,
                       churn_budget: Optional[float] = None,
                       page_table: Optional[torch.Tensor] = None,
                       replan_mode: str = "exact"
                       ) -> Tuple[PlanState, torch.Tensor]:
    """One decode step of plan maintenance (the summaries must already
    hold the step's appended key — call ``update_block_summaries``
    first).  Updates ``plan`` in place and returns it with the per-row
    thresholds for the decode kernel.

    ``replan_interval=1`` runs the exact full re-plan every step.  An
    integer interval re-plans every ``interval``-th step of each slot
    and runs the incremental plan in between; a step whose active slots
    disagree takes the partial re-plan — a host loop over slots that
    streams the cache only for the slots that trigger.  ``replans``
    counts the full re-plans of active slots, as the reference does."""
    if replan_mode != "exact":
        raise _unsupported(f"replan_mode={replan_mode!r}")
    if churn_budget is not None:
        raise _unsupported("the churn-adaptive re-plan trigger")
    if "budget" in plan or "imp" in plan or "k_scale" in plan:
        raise _unsupported("QoS / retirement / int8 plan state")
    p = plan["kv_indices"].shape[-1]
    active = plan["active"]
    if replan_interval <= 1:
        do_full = active
    else:
        do_full = (plan["step"] % replan_interval == 0) & active

    def _full(qb, kc, posb, tbl):
        kf = kc if tbl is None else logical_kv_view(kc, tbl)
        return full_replan(qb, kf, posb, topk_k=topk_k, k_block=k_block,
                           plan_blocks=p)

    def _incr(qb, kc, posb, sub, tbl):
        return incremental_plan(qb, kc, sub, posb, topk_k=topk_k,
                                k_block=k_block, page_table=tbl)

    if replan_interval <= 1:
        # exact mode re-plans every slot (idle ones ride the batched
        # einsum for free); ``do_full`` still scopes the accounting
        kv_indices, kv_counts, thr = _full(q, k_cache, pos, page_table)
    else:
        flags = do_full.tolist()
        if all(flags):
            kv_indices, kv_counts, thr = _full(q, k_cache, pos, page_table)
        elif not any(flags):
            kv_indices, kv_counts, thr = _incr(q, k_cache, pos, plan,
                                               page_table)
        else:
            # partial re-plan: a real per-slot branch, so untriggered
            # slots never stream their cache
            outs = []
            for i, f in enumerate(flags):
                sl = slice(i, i + 1)
                kc = k_cache if page_table is not None else k_cache[sl]
                tbl = None if page_table is None else page_table[sl]
                if f:
                    outs.append(_full(q[sl], kc, pos[sl], tbl))
                else:
                    sub = {k: plan[k][sl] for k in
                           ("k_min", "k_max", "kv_indices")}
                    outs.append(_incr(q[sl], kc, pos[sl], sub, tbl))
            kv_indices, kv_counts, thr = (torch.cat(t) for t in zip(*outs))
    plan["kv_indices"].copy_(kv_indices)
    plan["kv_counts"].copy_(kv_counts)
    plan["step"] += active.to(torch.int32)
    plan["replans"] += do_full.to(torch.int32)
    return plan, thr


def plan_from_prefill(k_cache: torch.Tensor, q_tail: torch.Tensor,
                      pos: torch.Tensor, *, topk_k: int, k_block: int,
                      plan_blocks: Optional[int] = None,
                      summary: str = "fp32") -> PlanState:
    """Seed a decode-plan state from prefill outputs: summaries from the
    written keys (bit-identical to incremental maintenance), the plan
    rows from the prompt tail's selected blocks, and ``step = 1`` — off
    the re-plan beat, so decode step 0 runs the planned incremental
    path instead of a cold full re-plan.
    k_cache: (B, S, KV, D) logical; q_tail: (B, KV, G, D); pos: (B,)."""
    b, s, kv, d = k_cache.shape
    plan = init_decode_plan(b, kv, s, d, k_block, plan_blocks,
                            summary=summary, device=k_cache.device)
    k_min, k_max = summaries_from_cache(k_cache, pos, k_block=k_block)
    p = plan["kv_indices"].shape[-1]
    kv_indices, kv_counts, _ = full_replan(q_tail, k_cache, pos,
                                           topk_k=topk_k, k_block=k_block,
                                           plan_blocks=p)
    plan.update(k_min=k_min, k_max=k_max, kv_indices=kv_indices,
                kv_counts=kv_counts)
    plan["step"].fill_(1)
    return plan
