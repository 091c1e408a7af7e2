"""Serving driver — port of ``repro.launch.serve``'s core loop: batched
request decoding with top-k selective attention over a KV cache (fixed
batch slots, per-slot positions, new requests claim finished slots).

Covered: slot claim and ``reset_slot``; the prompt prefill handoff
(``prompt_len > 1``); with the paged layout, admission control with
deferral backoff, page-boundary stalls with re-feed, and requeue
preemption on livelock (a request preempted ``PREEMPT_RETRY_LIMIT``
times is protected: admission reserves its pages and victim selection
spares it); the shared-prefix page cache (``kv.prefix_cache``): a claim
maps the longest cached prompt prefix's pages into its slot, copies a
partially matched page on write, prefills only the unmatched tail and
registers its prompt, appends into shared pages go through
copy-on-write, and trie pages are evicted under pool pressure.  The
report carries outputs, tokens, tok/s, steps, per-request latencies,
the SATA decode fetch accounting (per summary backend and re-plan
mode), the page occupancy and the prefix-cache statistics.

The loop runs eagerly on ``device`` (default ``"cuda"``; the CPU only
when asked).  Not ported yet, each raising ``NotImplementedError``
that names its queue A item: fault injection and the resilience
options — host swap, watchdog, checkpoints (item 15), the QoS ladder
(item 16), retirement (item 17) and the cross-replica prefix index
(slice 5).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.archs import ARCHS, SMOKE
from repro_torch.core.paging import PageAllocator, PrefixCache
from repro_torch.kernels.ops import decode_fetch_stats
from repro_torch.models import attention as attn
from repro_torch.models import decode as dec
from repro_torch.models.layers import _dtype
from repro_torch.models.model import DenseModel

# the reference's ResilienceOptions.preempt_retry_limit default
PREEMPT_RETRY_LIMIT = 3


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    """Workload shape for one :func:`serve` run."""
    n_requests: int = 8
    batch_slots: int = 4
    gen_len: int = 16
    max_len: int = 64
    prompt_len: int = 1
    shared_prefix_len: int = 0        # prompts share their first N
                                      # tokens (a common system prompt)


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


def _unported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {where} of the "
                               f"PyTorch port")


def serve(arch: str, smoke: bool = True, *, seed: int = 0, model=None,
          cfg=None, options: Optional[ServeOptions] = None,
          device="cuda", faults=None, resilience=None, prefix_index=None
          ) -> Dict[str, Any]:
    """Serve ``options.n_requests`` requests through ``batch_slots``
    decode slots on ``device``.  ``model`` defaults to a ``DenseModel``
    with random weights from ``seed``; prompts come from
    ``numpy.random.default_rng(seed)`` as in the reference, so a model
    built with ``params_from_jax`` serves the reference's exact
    workload.  The allocator audits its invariants after every mutation,
    as the reference's default ``audit_pages=True`` does."""
    item15 = "queue A item 15, slice 3"
    for name, val, where in (("faults", faults, item15),
                             ("resilience", resilience, item15),
                             ("prefix_index", prefix_index,
                              "queue A slice 5")):
        if val is not None:
            raise _unported(f"serve({name}=...)", where)
    dev = resolve_device(device)
    opt = options or ServeOptions()
    n_requests, batch_slots = opt.n_requests, opt.batch_slots
    gen_len, max_len = opt.gen_len, opt.max_len
    prompt_len = max(1, int(opt.prompt_len))
    shared_prefix_len = opt.shared_prefix_len
    cfg = cfg or (SMOKE if smoke else ARCHS)[arch]
    if cfg.sata.qos.ladder:
        raise _unported("the QoS ladder", "queue A item 16, slice 3")
    if cfg.sata.retire.mode == "on":
        raise _unported("retirement", "queue A item 17, slice 3")
    if model is None:
        model = DenseModel(cfg, device=dev, seed=seed)
    rng = np.random.default_rng(seed)
    dtype_bytes = torch.tensor([], dtype=_dtype(cfg)).element_size()

    cache = dec.init_cache(cfg, batch_slots, max_len, device=dev)

    # --- paged-pool allocator (host-side; the device reads the table)
    alloc: Optional[PageAllocator] = None
    page = max_len
    if attn.paged_kv_on(cfg):
        page = attn.kv_page_size(cfg, max_len)
        n_pages = int(cache["kv"]["k_pages"].shape[1])
        alloc = PageAllocator(n_pages, batch_slots, max_len // page, page,
                              audit=True)
        alloc.lazy_cow = bool(cfg.kv.lazy_cow)
        dec.set_page_table(cfg, cache, alloc.table)
        # backpressure only helps when ONE request's worst case fits
        need = alloc.pages_for(min(max_len, prompt_len + gen_len - 1))
        if need > alloc.free_pages:
            raise ValueError(
                f"kv.pool_pages={n_pages} ({alloc.free_pages} usable) "
                f"cannot hold one request's worst-case working set "
                f"({need} pages of {page} tokens)")

    use_prefill = prompt_len > 1
    # --- shared-prefix page cache (prompt-prefix trie over the pool)
    pcache: Optional[PrefixCache] = None
    if attn.prefix_cache_on(cfg):
        pcache = PrefixCache(alloc)
    cow_copies = 0

    def _push_tables() -> None:
        # with the cache on the device write-protect reads the refcounts;
        # a live lazy-CoW lease's page reports 1 so its holder may append
        dec.set_page_table(
            cfg, cache, alloc.table,
            page_ref=alloc.writable_ref_view() if pcache is not None
            else None)

    def _copy(cp) -> None:
        nonlocal cow_copies
        if cp is not None:
            dec.copy_phys_pages(cache, [cp])
            cow_copies += 1

    def _step_writable(i: int) -> bool:
        """Pool-side gate before slot ``i`` appends at pos_h[i]: copy the
        target page if it is shared, map it if it is new — evicting
        trie pages first when the pool is dry (cached prefixes use
        SPARE pages, never a reason to stall a live request).  False =
        stall this step."""
        ok, cp = alloc.ensure_writable(i, int(pos_h[i]))
        if not ok and pcache is not None and pcache.evict(1):
            ok, cp = alloc.ensure_writable(i, int(pos_h[i]))
        if not ok:
            return False
        _copy(cp)
        if alloc.ensure(i, int(pos_h[i])):
            return True
        if pcache is not None and pcache.evict(1):
            return alloc.ensure(i, int(pos_h[i]))
        return False

    prompts = rng.integers(0, cfg.vocab_size, (n_requests, prompt_len))
    if shared_prefix_len:
        assert shared_prefix_len < prompt_len, "tail must be non-empty"
        prompts[:, :shared_prefix_len] = prompts[0, :shared_prefix_len]
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
    prefill_s: Dict[str, List[float]] = {"hit": [], "miss": []}
    noted: set = set()               # requests whose hit/miss is counted
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

    def _defer(r0: int) -> None:
        nonlocal deferred_claims
        deferred_claims += 1                          # backpressure: wait
        bo = min(max(defer_backoff.get(r0, 0) * 2, 1), 8)
        defer_backoff[r0] = bo
        defer_until[r0] = steps + bo

    def _finish(i: int, now: float) -> None:
        """Slot ``i``'s request completed: free the slot and its page
        references (pages the trie or another slot holds survive)."""
        latency[slots[i]] = now - t_claim[slots[i]]
        slots[i] = None
        dec.release_slot(cfg, cache, i)
        if alloc is not None:
            alloc.free_slot(i)
            defer_until.clear()
            defer_backoff.clear()

    def _preempt(victim: int) -> None:
        """Requeue the victim: its decoded output is discarded and
        regenerated on re-admission (deterministic decode leaves the
        final outputs unchanged; shared pages survive through their
        other references)."""
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

    def _claim_prefill(i: int, r: int, m: int, phys_m: List[int]) -> None:
        """Prefill request ``r``'s prompt into slot ``i`` and record its
        first token.  With a cached prefix of ``m`` tokens on pages
        ``phys_m`` the slot maps them, copies a partially matched last
        page before the tail writes into it, and prefills the tail over
        the gathered prefix; the prompt's pages then enter the trie."""
        nonlocal produced
        t_pf = time.perf_counter()
        if pcache is not None and r not in noted:
            # once per REQUEST: a requeued request's re-claim hits its
            # own registered pages and must not count twice
            noted.add(r)
            pcache.note(m)
        if m:
            alloc.map_shared(i, phys_m)
            if m % page:
                # the tail's first rows land inside the last matched
                # page: shared → copy now
                ok, cp = alloc.ensure_writable(i, m)
                assert ok, "admission reserved the CoW page"
                _copy(cp)
        if alloc is not None:
            ok = alloc.ensure(i, prompt_len - 1)
            assert ok, "admission control reserved these pages"
            _push_tables()
        if m:
            prefix = dec.gather_prefix_kv(cache, alloc.table[i], m)
            lg0, state = dec.prefill_prompt(
                model, cfg, torch.as_tensor(prompts[r:r + 1, m:],
                                            device=dev),
                max_len, prefix_kv=prefix)
        else:
            lg0, state = dec.prefill_prompt(
                model, cfg, torch.as_tensor(prompts[r:r + 1], device=dev),
                max_len)
        phys = (alloc.table[i, :alloc.pages_for(prompt_len)]
                if alloc is not None else None)
        dec.install_prefill(cfg, cache, i, state, phys, prefix_len=m)
        if pcache is not None:
            # retain the prompt's pages: full pages chain the trie, a
            # final partial page becomes a terminal node (so the owner's
            # own first append copies it)
            pcache.register(prompts[r], alloc.table[i])
            _push_tables()
        pos_h[i] = prompt_len
        # the prefill's last-position argmax IS the first generated token
        first = int(torch.argmax(lg0[0]))
        prefill_s["hit" if m else "miss"].append(
            time.perf_counter() - t_pf)
        outputs[r].append(first)
        produced += 1
        tokens_h[i, 0] = first

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
                # prefix match BEFORE admission: matched pages shrink the
                # claim's pool demand (match tokens[:-1] so the tail
                # prefill always yields last-token logits)
                m, phys_m = 0, []
                if pcache is not None and use_prefill:
                    m, phys_m, _ = pcache.match(prompts[r0, :-1])
                if alloc is not None:
                    def _need():
                        return max(alloc.pages_for(prompt_len)
                                   - len(phys_m) + (1 if m % page else 0),
                                   0)
                    if not alloc.can_admit(_need() + reserve):
                        if pcache is not None:
                            pcache.evict(_need() + reserve)
                            # eviction may have dropped matched pages
                            m, phys_m, _ = pcache.match(prompts[r0, :-1])
                        if not alloc.can_admit(_need() + reserve):
                            _defer(r0)
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
                    _claim_prefill(i, r, m, phys_m)
                    if len(outputs[r]) >= gen_len or pos_h[i] >= max_len:
                        _finish(i, time.time())       # gen_len=1: done
                else:
                    pos_h[i] = 0
                    tokens_h[i, 0] = int(prompts[r, 0])
            active = [i for i in range(batch_slots) if slots[i] is not None]
            stalled: List[int] = []
            if alloc is not None and active:
                while True:
                    stalled = [i for i in active if slots[i] is not None
                               and not _step_writable(i)]
                    runnable = [i for i in active if slots[i] is not None
                                and i not in stalled]
                    if not stalled or runnable:
                        break
                    # every active slot is stalled: first reclaim pages
                    # only the trie holds, then — pages only free when a
                    # request completes — livelock: requeue the
                    # least-progress victim
                    if pcache is not None and pcache.evict(1):
                        continue
                    _preempt(_pick_victim(stalled, slots, outputs,
                                          admit_seq, _protected()))
                stalled_steps += len(stalled)
                _push_tables()
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
                        nkb=max_len // blk, dtype_bytes=dtype_bytes,
                        summary=cfg.sata.decode.summary,
                        replan_mode=cfg.sata.decode.replan_mode,
                        sketch_factor=cfg.sata.decode.sketch_factor,
                        plan_blocks=cfg.sata.decode.blocks)
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
                    _finish(i, now)
                elif i not in stalled:
                    tokens_h[i, 0] = int(nxt[i])
            steps += 1
        wall = time.time() - t0
    out: Dict[str, Any] = {
        "outputs": outputs, "tokens_generated": produced,
        "tok_per_s": produced / max(wall, 1e-9), "steps": steps,
        "step_ms_mean": 1e3 * float(np.mean(step_s)) if step_s else 0.0,
        # host clock from the claim's prefix match to its first token
        # (which waits for the device)
        "prefill_ms_mean": {k: 1e3 * float(np.mean(v)) if v else None
                            for k, v in prefill_s.items()},
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
        occ["audits_run"] = alloc.audits_run
        out["page_occupancy"] = occ
    if pcache is not None:
        pstats = pcache.stats()
        pstats["prefill_tokens_total"] = len(latency) * prompt_len
        pstats["cow_copies"] = cow_copies
        pstats["shared_pages_peak"] = alloc.shared_pages_peak
        out["prefix_cache"] = pstats
    return out
