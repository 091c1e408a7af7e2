"""Serving driver — port of ``repro.launch.serve``'s core loop: batched
request decoding with top-k selective attention over a KV cache (fixed
batch slots, per-slot positions, new requests claim finished slots).

Covered: slot claim and ``reset_slot``; the prompt prefill handoff
(``prompt_len > 1``); with the paged layout, admission control with
deferral backoff, page-boundary stalls with re-feed, and requeue
preemption on livelock (a request preempted ``PREEMPT_RETRY_LIMIT``
times is protected: admission reserves its pages and victim selection
spares it).  The report carries outputs, tokens, tok/s, steps,
per-request latencies, the SATA decode fetch accounting and the page
occupancy.

The loop runs eagerly on ``device`` (default ``"cuda"``; the CPU only
when asked).  Not ported yet, each raising ``NotImplementedError``:
fault injection, resilience options (host swap, watchdog, checkpoints),
the shared-prefix cache and cross-replica index, the QoS ladder and
retirement (slice 3 of the port).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.archs import ARCHS, SMOKE
from repro_torch.core.paging import PageAllocator
from repro_torch.kernels.ops import decode_fetch_stats
from repro_torch.models import attention as attn
from repro_torch.models import decode as dec
from repro_torch.models.layers import _dtype
from repro_torch.models.model import DenseModel

# the reference's ResilienceOptions.preempt_retry_limit default
PREEMPT_RETRY_LIMIT = 3

_SLICE3 = "slice 3 of the PyTorch port (serving features)"


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    """Workload shape for one :func:`serve` run."""
    n_requests: int = 8
    batch_slots: int = 4
    gen_len: int = 16
    max_len: int = 64
    prompt_len: int = 1


def _pick_victim(stalled: List[int], slots: List[Optional[int]],
                 outputs: Dict[int, List[int]], admit_seq: Dict[int, int],
                 protected=()) -> int:
    """Preemption victim: the stalled slot with the least decoded
    progress; ties go to the youngest admission.  Protected requests
    are skipped unless every candidate is protected."""
    cands = [i for i in stalled if slots[i] not in protected]
    if not cands:
        cands = list(stalled)
    return min(cands, key=lambda i: (len(outputs[slots[i]]),
                                     -admit_seq[slots[i]]))


def serve(arch: str, smoke: bool = True, *, seed: int = 0, model=None,
          cfg=None, options: Optional[ServeOptions] = None,
          device="cuda", faults=None, resilience=None, prefix_index=None
          ) -> Dict[str, Any]:
    """Serve ``options.n_requests`` requests through ``batch_slots``
    decode slots on ``device``.  ``model`` defaults to a ``DenseModel``
    with random weights from ``seed``; prompts come from
    ``numpy.random.default_rng(seed)`` as in the reference, so a model
    built with ``params_from_jax`` serves the reference's exact
    workload."""
    for name, val in (("faults", faults), ("resilience", resilience),
                      ("prefix_index", prefix_index)):
        if val is not None:
            raise NotImplementedError(f"serve({name}=...) is not ported "
                                      f"yet: {_SLICE3}")
    dev = resolve_device(device)
    opt = options or ServeOptions()
    n_requests, batch_slots = opt.n_requests, opt.batch_slots
    gen_len, max_len = opt.gen_len, opt.max_len
    prompt_len = max(1, int(opt.prompt_len))
    cfg = cfg or (SMOKE if smoke else ARCHS)[arch]
    if cfg.sata.qos.ladder or cfg.sata.retire.mode == "on" \
            or cfg.kv.prefix_cache:
        raise NotImplementedError(
            f"the QoS ladder, retirement and the prefix cache: {_SLICE3}")
    if model is None:
        model = DenseModel(cfg, device=dev, seed=seed)
    rng = np.random.default_rng(seed)
    dtype_bytes = torch.tensor([], dtype=_dtype(cfg)).element_size()

    cache = dec.init_cache(cfg, batch_slots, max_len, device=dev)

    # --- paged-pool allocator (host-side; the device reads the table)
    alloc: Optional[PageAllocator] = None
    if attn.paged_kv_on(cfg):
        page = attn.kv_page_size(cfg, max_len)
        n_pages = int(cache["kv"]["k_pages"].shape[1])
        alloc = PageAllocator(n_pages, batch_slots, max_len // page, page)
        dec.set_page_table(cfg, cache, alloc.table)
        # backpressure only helps when ONE request's worst case fits
        need = alloc.pages_for(min(max_len, prompt_len + gen_len - 1))
        if need > alloc.free_pages:
            raise ValueError(
                f"kv.pool_pages={n_pages} ({alloc.free_pages} usable) "
                f"cannot hold one request's worst-case working set "
                f"({need} pages of {page} tokens)")

    use_prefill = prompt_len > 1
    prompts = rng.integers(0, cfg.vocab_size, (n_requests, prompt_len))
    queue: List[int] = list(range(n_requests))
    outputs: Dict[int, List[int]] = {}
    latency: Dict[int, float] = {}
    t_claim: Dict[int, float] = {}
    slots: List[Optional[int]] = [None] * batch_slots
    pos_h = np.zeros(batch_slots, np.int32)
    tokens_h = np.zeros((batch_slots, 1), np.int32)
    produced = steps = 0
    deferred_claims = stalled_steps = preemptions = 0
    fetch_tiles_plan = fetch_tiles_dense = 0
    plan_bytes = kernel_bytes_plan = kernel_bytes_dense = 0
    step_s: List[float] = []
    preempt_count: Dict[int, int] = {}
    admit_seq: Dict[int, int] = {}
    admit_clock = 0
    defer_until: Dict[int, int] = {}      # request → earliest retry step
    defer_backoff: Dict[int, int] = {}
    blk = attn.decode_block_size(cfg, max_len)
    tile_bytes = 2 * blk * cfg.hd * dtype_bytes
    plan = cache["kv"].get("plan")

    def _protected() -> set:
        return {r for r, c in preempt_count.items()
                if c >= PREEMPT_RETRY_LIMIT}

    def _reserve_need(exclude: Optional[int] = None) -> int:
        """Pages admission holds back for queued protected requests."""
        return sum(alloc.pages_for(prompt_len) for r in queue
                   if r != exclude
                   and preempt_count.get(r, 0) >= PREEMPT_RETRY_LIMIT)

    def _preempt(victim: int) -> None:
        """Requeue the victim: its decoded output is discarded and
        regenerated on re-admission (deterministic decode leaves the
        final outputs unchanged)."""
        nonlocal produced, preemptions
        r = slots[victim]
        preempt_count[r] = preempt_count.get(r, 0) + 1
        produced -= len(outputs[r])
        outputs[r] = []
        queue.insert(0, r)
        slots[victim] = None
        dec.release_slot(cfg, cache, victim)
        alloc.free_slot(victim)
        preemptions += 1
        defer_until.clear()               # the victim's pages freed
        defer_backoff.clear()

    def _replans() -> Optional[np.ndarray]:
        return None if plan is None else \
            plan["replans"].cpu().numpy().astype(np.float64)

    with torch.inference_mode():
        # every slot starts RELEASED; a claim re-activates it
        for i in range(batch_slots):
            dec.release_slot(cfg, cache, i)
        last_rep = _replans()
        rep_base = None if last_rep is None else last_rep.copy()
        t0 = time.time()
        max_steps = 4 * (n_requests * gen_len + batch_slots + 1)
        while (queue or any(s is not None for s in slots)) \
                and steps < max_steps:
            for i in range(batch_slots):              # claim free slots
                if slots[i] is not None or not queue:
                    continue
                r0 = queue[0]
                if steps < defer_until.get(r0, 0):
                    break               # backoff; keep admission order
                protected = preempt_count.get(r0, 0) >= PREEMPT_RETRY_LIMIT
                reserve = 0 if (alloc is None or protected) \
                    else _reserve_need(exclude=r0)
                if alloc is not None and \
                        not alloc.can_admit(alloc.pages_for(prompt_len)
                                            + reserve):
                    deferred_claims += 1              # backpressure: wait
                    bo = min(max(defer_backoff.get(r0, 0) * 2, 1), 8)
                    defer_backoff[r0] = bo
                    defer_until[r0] = steps + bo
                    break
                r = queue.pop(0)
                slots[i] = r
                admit_seq[r] = admit_clock
                admit_clock += 1
                defer_until.pop(r, None)
                defer_backoff.pop(r, None)
                outputs[r] = []
                t_claim[r] = time.time()
                dec.reset_slot(cfg, cache, i)
                if use_prefill:
                    if alloc is not None:
                        ok = alloc.ensure(i, prompt_len - 1)
                        assert ok, "admission control reserved these pages"
                        dec.set_page_table(cfg, cache, alloc.table)
                    lg0, state = dec.prefill_prompt(
                        model, cfg,
                        torch.as_tensor(prompts[r:r + 1], device=dev),
                        max_len)
                    phys = (alloc.table[i, :alloc.pages_for(prompt_len)]
                            if alloc is not None else None)
                    dec.install_prefill(cfg, cache, i, state, phys)
                    pos_h[i] = prompt_len
                    # the prefill's last-position argmax IS the first
                    # generated token
                    first = int(torch.argmax(lg0[0]))
                    outputs[r].append(first)
                    produced += 1
                    tokens_h[i, 0] = first
                    if len(outputs[r]) >= gen_len or pos_h[i] >= max_len:
                        latency[r] = time.time() - t_claim[r]
                        slots[i] = None
                        dec.release_slot(cfg, cache, i)
                        if alloc is not None:
                            alloc.free_slot(i)
                            defer_until.clear()
                            defer_backoff.clear()
                else:
                    pos_h[i] = 0
                    tokens_h[i, 0] = int(prompts[r, 0])
            active = [i for i in range(batch_slots) if slots[i] is not None]
            stalled: List[int] = []
            if alloc is not None and active:
                while True:
                    stalled = [i for i in active if slots[i] is not None
                               and not alloc.ensure(i, int(pos_h[i]))]
                    runnable = [i for i in active if slots[i] is not None
                                and i not in stalled]
                    if not stalled or runnable:
                        break
                    # every active slot is stalled and pages only free
                    # when a request completes: livelock — requeue the
                    # least-progress victim
                    _preempt(_pick_victim(stalled, slots, outputs,
                                          admit_seq, _protected()))
                stalled_steps += len(stalled)
                dec.set_page_table(cfg, cache, alloc.table)
                active = [i for i in range(batch_slots)
                          if slots[i] is not None]
            t_step = time.perf_counter()
            logits, cache = dec.serve_step(
                model, cfg, cache, torch.as_tensor(tokens_h, device=dev),
                torch.as_tensor(pos_h, device=dev))
            nxt = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()
            step_s.append(time.perf_counter() - t_step)
            live = [i for i in active if i not in stalled]
            rep = _replans()
            if rep is not None:
                # per-(layer, slot) re-plan delta, charged to live slots
                delta = np.clip(rep - last_rep, 0.0, 1.0)
                last_rep = rep
                if live:
                    counts = plan["kv_counts"].cpu().numpy()
                    st = decode_fetch_stats(
                        counts[:, live], pos_h[live], k_block=blk, d=cfg.hd,
                        replan=delta[:, live].mean(axis=0),
                        nkb=max_len // blk, dtype_bytes=dtype_bytes)
                    fetch_tiles_plan += st["kv_fetch_tiles_plan"]
                    fetch_tiles_dense += st["kv_fetch_tiles_dense"]
                    plan_bytes += st["plan_fetch_bytes_step"]
                    kernel_bytes_plan += st["kv_fetch_bytes_plan"]
                    kernel_bytes_dense += st["kv_fetch_bytes_dense"]
            now = time.time()
            for i in range(batch_slots):
                r = slots[i]
                if r is None:
                    continue
                if i not in stalled:                  # stalled: re-fed
                    outputs[r].append(int(nxt[i]))
                    produced += 1
                    pos_h[i] += 1
                if len(outputs[r]) >= gen_len or pos_h[i] >= max_len:
                    latency[r] = now - t_claim[r]
                    slots[i] = None
                    dec.release_slot(cfg, cache, i)
                    if alloc is not None:
                        alloc.free_slot(i)
                        defer_until.clear()
                        defer_backoff.clear()
                elif i not in stalled:
                    tokens_h[i, 0] = int(nxt[i])
            steps += 1
        wall = time.time() - t0
    out: Dict[str, Any] = {
        "outputs": outputs, "tokens_generated": produced,
        "tok_per_s": produced / max(wall, 1e-9), "steps": steps,
        "step_ms_mean": 1e3 * float(np.mean(step_s)) if step_s else 0.0,
        "request_latency_s": latency,
        "latency_mean_s": float(np.mean(list(latency.values())))
        if latency else 0.0,
        "device": str(dev),
    }
    if fetch_tiles_dense:
        out["decode_fetch"] = {
            "kv_fetch_tiles_plan": fetch_tiles_plan,
            "kv_fetch_tiles_dense": fetch_tiles_dense,
            "kv_fetch_bytes_plan": fetch_tiles_plan * tile_bytes,
            "kv_fetch_bytes_dense": fetch_tiles_dense * tile_bytes,
            "fetch_reduction": fetch_tiles_dense / max(fetch_tiles_plan, 1),
            "plan_fetch_bytes": plan_bytes,
            "summary_backend": cfg.sata.decode.summary,
            "replan_mode": cfg.sata.decode.replan_mode,
            "step_bytes_plan_route": kernel_bytes_plan + plan_bytes,
            "step_bytes_dense_route": kernel_bytes_dense,
            "true_reduction": kernel_bytes_dense
            / max(kernel_bytes_plan + plan_bytes, 1),
            "replans": float((last_rep - rep_base).mean()),
        }
    if alloc is not None:
        row_bytes = 2 * cfg.n_kv_heads * cfg.hd * dtype_bytes
        occ = alloc.stats(row_bytes=row_bytes, layers=cfg.n_layers)
        occ["contiguous_reserved_bytes"] = \
            batch_slots * max_len * row_bytes * cfg.n_layers
        occ["reserved_vs_contiguous"] = (occ["contiguous_reserved_bytes"]
                                         / max(occ["hbm_reserved_bytes"], 1))
        occ["deferred_claims"] = deferred_claims
        occ["stalled_steps"] = stalled_steps
        occ["preemptions"] = preemptions
        occ["preempted_requests"] = sum(1 for c in preempt_count.values()
                                        if c > 0)
        out["page_occupancy"] = occ
    return out
