"""Serving driver — port of ``repro.launch.serve``'s core loop: batched
request decoding with top-k selective attention over a KV cache (fixed
batch slots, per-slot positions, new requests claim finished slots).

Covered: slot claim and ``reset_slot``; the prompt prefill handoff
(``prompt_len > 1``); with the paged layout, admission control with
deferral backoff and page-boundary stalls with re-feed; the
shared-prefix page cache (``kv.prefix_cache``): a claim maps the longest
cached prompt prefix's pages into its slot, copies a partially matched
page on write, prefills only the unmatched tail and registers its
prompt, appends into shared pages go through copy-on-write, and trie
pages are evicted under pool pressure.

Fault tolerance (paged; ``ResilienceOptions``, ``faults=FaultPlan``):
preemption prefers **host swap** — the victim's private pages (K/V and
page-summary rows), page-table row, position and complete decode-plan
state move to host numpy under crc32 checksums, while shared pages stay
resident under references the handle pins — and re-admission scatters
the payload into fresh pages and reinstalls the plan reset-free, so
decode resumes bitwise where it stopped.  ``host_swap_bytes`` bounds the
host budget (``0`` disables swap; a budget too small for the victim
requeues it, which regenerates its output).  A request preempted
``preempt_retry_limit`` times re-admits under reserved pages and is
spared as a victim; ``max_steps_per_request`` retires a runaway request
as ``timed_out``; ``audit_pages`` audits the allocator after every
mutation (``"light"`` samples).  The ``FaultPlan`` events: pool
squeezes and restores, forced preemptions, admission deferrals, load
spikes and slow steps (with the QoS ladder they press rungs; without
it a spike preempts one slot per severity unit and a slow step does
nothing), a corrupted byte in a parked handle — caught at the claim
gate, the handle quarantined, its trie pages invalidated and the
request re-prefilled — and a crash that swaps every live slot to host,
drops the device cache and allocator, and restores each request from
its handle.  ``checkpoint_dir`` / ``checkpoint_every`` save the device
cache and every host structure at the top of a step, ``kill_at_step``
raises :class:`ServeKilled` after the save, and ``resume=True`` replays
from the last save.

Overload (``sata.qos.ladder``): load spikes, slow steps and pool
pressure (a deferred claim, a stalled slot) step every active slot down
the :class:`QoSController` rungs instead of preempting; the per-slot
plan knobs degrade in place and recover with hysteresis, and each
request's report entry records its rung timeline.  Cascade retirement
(``sata.retire.mode="on"``, paged): after each step a slot past its
live-token watermark, or every slot under pool pressure, retires its
coldest completed blocks down to the ``keep`` budget and their pages
return to the pool mid-stream.

Families: dense and moe; vlm (contiguous cache only) and audio, whose
slots each hold a cross-attention context filled once before the first
claim, with one-token prompts; hybrid (zamba2: the shared block's KV
caches under ``shared_kv``, one per application) and ssm (rwkv6: no KV
cache, so contiguous only), with one-token prompts, whose recurrent
state rides in the cache (and its checkpoint).  A slot of a family
other than dense and moe is requeued under pool pressure, as in the
reference: host swap covers the families whose per-slot state is
pages + plan.

The report carries outputs, tokens, tok/s, steps, per-request latencies,
the SATA decode fetch accounting (per summary backend, re-plan mode,
rung and live block count), the page occupancy with every fault
counter, the prefix-cache statistics, the degradation timelines and
ladder counters, and the retirement counters.  The loop runs eagerly on
``device`` (default ``"cuda"``; the CPU only when asked).

Across replicas (``prefix_index=SharedPrefixIndex``, with the prefix
cache on): each replica publishes its prompts' full prefix pages to the
index, and a claim whose local trie matches less than another replica
published migrates those pages into fresh local pages instead of
prefilling them; ``serve_replicated`` runs N replicas in sequence around
one index.  ``serve(**legacy)`` takes the reference's deprecated flat
kwargs (``n_requests=...``, ``checkpoint_dir=...``).

CLI: ``python -m repro_torch.launch.serve [--paged] [--prefix-cache]
[--replicas N] [--faults-seed S] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import pickle
import time
import types
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.archs import ARCHS, SMOKE
from repro_torch.core.paging import (PageAllocator, PageIntegrityError,
                                     PrefixCache, SharedPrefixIndex)
from repro_torch.kernels.ops import decode_fetch_stats
from repro_torch.launch.faults import FaultPlan
from repro_torch.models import attention as attn
from repro_torch.models import decode as dec
from repro_torch.models.layers import _dtype
from repro_torch.models.model import Model


class QoSController:
    """SLO degradation ladder — an own copy of the reference's: per-slot
    rung counters mapping overload pressure to decode-plan knobs.
    Rungs apply cumulatively::

        0  full quality        budget=P, interval=iv, fp32, exact
        1  half plan budget    budget = max(1, P // 2)
        2  slow re-plan beat   interval = iv * 4
        3  int8 rank bounds    quantized (conservative) block ranking
        4  sketch re-plans     hierarchical candidate pre-filter

    ``press`` steps active slots down ``severity`` rungs; ``tick`` is
    the hysteresis clock — ``clear_steps`` consecutive pressure-free
    ticks recover one rung, and any pressure zeroes every clear counter;
    ``reset`` (a new admission) returns the slot to full quality."""

    MAX_RUNG = 4

    def __init__(self, n_slots: int, p0: int, iv0: int,
                 clear_steps: int = 4):
        self.n_slots = int(n_slots)
        self.p0 = max(1, int(p0))
        self.iv0 = max(1, int(iv0))
        self.clear_steps = max(1, int(clear_steps))
        self.rung = [0] * self.n_slots
        self.clear = [0] * self.n_slots
        self.rung_downs = 0
        self.rung_ups = 0

    def knobs(self, i: int) -> Tuple[int, int, bool, bool]:
        """(budget, interval, quant, sketch) for slot ``i``'s rung."""
        r = self.rung[i]
        return (self.p0 if r < 1 else max(1, self.p0 // 2),
                self.iv0 if r < 2 else self.iv0 * 4,
                r >= 3, r >= 4)

    def vectors(self):
        """Per-slot knob vectors for ``models.decode.set_qos_knobs``."""
        ks = [self.knobs(i) for i in range(self.n_slots)]
        return (np.asarray([k[0] for k in ks], np.int32),
                np.asarray([k[1] for k in ks], np.int32),
                np.asarray([k[2] for k in ks], bool),
                np.asarray([k[3] for k in ks], bool))

    def press(self, active: List[int], severity: int = 1) -> List[int]:
        """Degrade every active slot ``severity`` rungs (clamped at the
        bottom).  Returns the changed slots."""
        changed = []
        for i in active:
            new = min(self.rung[i] + max(1, int(severity)), self.MAX_RUNG)
            if new != self.rung[i]:
                self.rung[i] = new
                self.rung_downs += 1
                changed.append(i)
            self.clear[i] = 0
        return changed

    def tick(self, active: List[int], pressure: bool) -> List[int]:
        """Once per loop step, after the step's pressure is known.
        Returns the slots that recovered one rung."""
        if pressure:
            self.clear = [0] * self.n_slots
            return []
        changed = []
        for i in active:
            if self.rung[i] == 0:
                continue
            self.clear[i] += 1
            if self.clear[i] >= self.clear_steps:
                self.rung[i] -= 1
                self.clear[i] = 0
                self.rung_ups += 1
                changed.append(i)
        return changed

    def reset(self, i: int) -> bool:
        """A new admission into slot ``i`` starts at full quality."""
        changed = self.rung[i] != 0
        self.rung[i] = 0
        self.clear[i] = 0
        return changed


class ServeKilled(RuntimeError):
    """Raised by ``serve`` at ``ResilienceOptions.kill_at_step``: a
    deterministic stand-in for a process crash, raised right after the
    checkpoint block, so a run with ``resume=True`` replays from the
    last save."""


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


@dataclasses.dataclass(frozen=True)
class ResilienceOptions:
    """Fault-tolerance knobs for :func:`serve` (the module docstring
    gives the failure model each one drives)."""
    host_swap_bytes: Optional[int] = None   # host-swap payload budget
                                            # (None unbounded, 0 =
                                            # requeue only)
    max_steps_per_request: Optional[int] = None  # deadline watchdog
    preempt_retry_limit: int = 3            # reserved-page guarantee
                                            # past this many preemptions
    audit_pages: Union[bool, str] = True    # allocator invariant audit
                                            # (True | False | "light")
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    resume: bool = False
    kill_at_step: Optional[int] = None      # ServeKilled after the
                                            # checkpoint block


_LEGACY_SERVE_KW = {
    # legacy flat kwarg -> (options group, field)
    "n_requests": ("options", "n_requests"),
    "batch_slots": ("options", "batch_slots"),
    "gen_len": ("options", "gen_len"),
    "max_len": ("options", "max_len"),
    "prompt_len": ("options", "prompt_len"),
    "shared_prefix_len": ("options", "shared_prefix_len"),
    "host_swap_bytes": ("resilience", "host_swap_bytes"),
    "max_steps_per_request": ("resilience", "max_steps_per_request"),
    "preempt_retry_limit": ("resilience", "preempt_retry_limit"),
    "audit_pages": ("resilience", "audit_pages"),
    "checkpoint_dir": ("resilience", "checkpoint_dir"),
    "checkpoint_every": ("resilience", "checkpoint_every"),
    "resume": ("resilience", "resume"),
    "kill_at_step": ("resilience", "kill_at_step"),
}

_warned_serve_legacy = False

# the cross-replica counters: reported, but, as in the reference, not
# saved by a serve checkpoint (a resumed run counts from 0)
_REPLICA_CTRS = ("cross_replica_hits", "migrated_pages", "migrated_tokens",
                 "index_publishes", "migrations_dropped")


def _fold_serve_legacy(options: Optional[ServeOptions],
                       resilience: Optional[ResilienceOptions],
                       legacy: Dict[str, Any]
                       ) -> Tuple[ServeOptions, ResilienceOptions]:
    """Map legacy flat ``serve()`` kwargs onto the options dataclasses
    (a flat value overrides its group's).  One DeprecationWarning per
    process, naming every legacy kwarg of that call."""
    opt = options or ServeOptions()
    res = resilience or ResilienceOptions()
    if legacy:
        unknown = [k for k in legacy if k not in _LEGACY_SERVE_KW]
        if unknown:
            raise TypeError(f"serve() got unexpected keyword argument(s) "
                            f"{unknown}")
        global _warned_serve_legacy
        if not _warned_serve_legacy:
            _warned_serve_legacy = True
            warnings.warn(
                f"flat serve() kwargs {sorted(legacy)} are deprecated; "
                f"pass serve(options=ServeOptions(...), "
                f"resilience=ResilienceOptions(...))",
                DeprecationWarning, stacklevel=3)
        by_group: Dict[str, Dict[str, Any]] = {"options": {},
                                               "resilience": {}}
        for k, v in legacy.items():
            group, field = _LEGACY_SERVE_KW[k]
            by_group[group][field] = v
        if by_group["options"]:
            opt = dataclasses.replace(opt, **by_group["options"])
        if by_group["resilience"]:
            res = dataclasses.replace(res, **by_group["resilience"])
    return opt, res


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
          device="cuda", faults: Optional[FaultPlan] = None,
          resilience: Optional[ResilienceOptions] = None,
          prefix_index: Optional[SharedPrefixIndex] = None,
          replica_id: int = 0, mesh=None, **legacy) -> Dict[str, Any]:
    """Serve ``options.n_requests`` requests through ``batch_slots``
    decode slots on ``device``.  ``mesh`` (a ``launch.mesh.ShardMesh``)
    is accepted and, as in the reference, only bound: serving is the
    same with it or without it.  ``model`` defaults to the family's
    ``Model`` with random weights from ``seed``; prompts come from
    ``numpy.random.default_rng(seed)`` as in the reference, so a model
    built with ``params_from_jax`` serves the reference's exact
    workload.  vlm and audio first draw each slot's context (image or
    frame embeddings, before the prompts, as the reference does) and
    fill the cross-attention K/V from it; their prompts are one token
    (they have no prompt prefill, as in the reference).  ``faults`` is
    a step-keyed ``FaultPlan``; ``resilience`` defaults to
    ``ResilienceOptions()``, as in the reference (host swap on,
    unbounded, audits after every allocator mutation); the reference's
    flat kwargs (``n_requests=...``, ``checkpoint_dir=...``) still fold
    into both through a deprecation shim, and override them.

    ``prefix_index`` (a :class:`SharedPrefixIndex`; needs the prefix
    cache on) makes this run replica ``replica_id`` of a group: it
    publishes each prompt's full pages after registering them, and a
    claim whose local match is shorter than what another replica
    published copies those pages into fresh local pages
    (``scatter_phys_pages``), registers them in its trie and prefills
    only the rest.  ``out["replica"]`` counts the migrations; its
    counters, as in the reference, are not saved by a checkpoint, and
    the index is the caller's to keep.  See :func:`serve_replicated`."""
    dev = resolve_device(device)
    opt, res = _fold_serve_legacy(options, resilience, legacy)
    n_requests, batch_slots = opt.n_requests, opt.batch_slots
    gen_len, max_len = opt.gen_len, opt.max_len
    prompt_len = max(1, int(opt.prompt_len))
    shared_prefix_len = opt.shared_prefix_len
    host_swap_bytes = res.host_swap_bytes
    preempt_retry_limit = res.preempt_retry_limit
    cfg = cfg or (SMOKE if smoke else ARCHS)[arch]
    if model is None:
        model = Model(cfg, device=dev, seed=seed)
    rng = np.random.default_rng(seed)
    dtype_bytes = torch.tensor([], dtype=_dtype(cfg)).element_size()

    cache = dec.init_cache(cfg, batch_slots, max_len, device=dev)
    # the self-attention cache: "kv", hybrid's "shared_kv" (one per
    # application of the shared block), none for ssm
    kv_name = dec.kv_group(cache)
    # layers holding a self-attention cache (vlm: its n_self)
    n_kv_layers = (0 if kv_name is None else
                   int(next(iter(cache[kv_name].values())).shape[0]))
    if cfg.family in ("vlm", "audio"):
        # one context per slot, drawn before the prompts (the reference's
        # rng order)
        key, n_ctx = (("image_embeds", cfg.n_image_tokens)
                      if cfg.family == "vlm"
                      else ("audio_embeds", cfg.encoder_len))
        ctx = rng.standard_normal((batch_slots, n_ctx, cfg.d_model))
        with torch.inference_mode():
            dec.prefill_context(model, cfg, cache, {key: torch.from_numpy(
                ctx.astype(np.float32)).to(dev)})

    # --- paged-pool allocator (host-side; the device reads the table)
    alloc: Optional[PageAllocator] = None
    page = max_len
    if attn.paged_kv_on(cfg):
        if kv_name is None:
            raise ValueError(
                f"kv.layout='paged' pages a KV cache, and the "
                f"{cfg.family!r} family has none — serve it with "
                f"kv.layout='contiguous'")
        page = attn.kv_page_size(cfg, max_len)
        n_pages = int(cache[kv_name]["k_pages"].shape[1])
        alloc = PageAllocator(n_pages, batch_slots, max_len // page, page,
                              audit=res.audit_pages)
        alloc.lazy_cow = bool(cfg.kv.lazy_cow)
        dec.set_page_table(cfg, cache, alloc.table)
        # backpressure only helps when ONE request's worst case fits
        need = alloc.pages_for(min(max_len, prompt_len + gen_len - 1))
        if need > alloc.free_pages:
            raise ValueError(
                f"kv.pool_pages={n_pages} ({alloc.free_pages} usable) "
                f"cannot hold one request's worst-case working set "
                f"({need} pages of {page} tokens)")
    # host swap covers the families whose whole per-slot decode state is
    # pages + plan (not vlm / audio's context, nor hybrid / ssm's
    # recurrent state): the others requeue; the estimate sizes one page
    # of K/V over all layers
    can_swap = (alloc is not None and cfg.family in ("dense", "moe")
                and (host_swap_bytes is None or host_swap_bytes > 0))
    swap_page_bytes = (2 * cfg.n_kv_heads * cfg.hd * dtype_bytes * page
                       * n_kv_layers)
    if faults is not None and not faults.empty:
        if alloc is None:
            raise ValueError(
                "fault injection drives the paged allocator — set "
                "kv.layout='paged'")
        if faults.has_crash and cfg.family not in ("dense", "moe"):
            raise ValueError(
                "crash_step recovery restores every live slot from host "
                "swap, which needs the dense/moe paged serving path")

    use_prefill = prompt_len > 1 and cfg.family in ("dense", "moe")
    if prompt_len > 1 and not use_prefill:
        raise NotImplementedError(
            f"prompt_len > 1 needs the dense/moe prefill path "
            f"(family {cfg.family!r})")
    # --- shared-prefix page cache (prompt-prefix trie over the pool)
    pcache: Optional[PrefixCache] = None
    if attn.prefix_cache_on(cfg):
        pcache = PrefixCache(alloc)
    if prefix_index is not None and pcache is None:
        raise ValueError(
            "prefix_index needs the local shared-prefix cache on "
            "(kv.prefix_cache=True, paged layout) — migration lands "
            "remote pages in the local trie")
    # every counter of the report; one namespace, so the checkpoint
    # saves and restores them together (all but _REPLICA_CTRS)
    ctr = types.SimpleNamespace(
        produced=0, deferred_claims=0, stalled_steps=0, preemptions=0,
        fetch_tiles_plan=0, fetch_tiles_dense=0, plan_bytes=0,
        kernel_bytes_plan=0, kernel_bytes_dense=0, cow_copies=0,
        host_swaps=0, swap_restores=0, requeue_preemptions=0,
        tokens_salvaged=0, requeue_tokens_discarded=0, re_prefill_tokens=0,
        swap_cold_replans=0, crashes=0, protected_admissions=0,
        host_swap_bytes_now=0, host_swap_bytes_peak=0, restore_wall=0.0,
        rep_offset=0.0, corrupt_pages_injected=0, corrupt_pages_detected=0,
        quarantined_pages=0, trie_nodes_invalidated=0,
        deferred_retries_skipped=0, load_spikes_seen=0, slow_steps_seen=0,
        degraded_steps=0, retire_events=0, pages_reclaimed=0,
        retired_tokens=0, retire_pass_s=0.0, retire_passes=0,
        **dict.fromkeys(_REPLICA_CTRS, 0))

    def _push_tables() -> None:
        # with the cache on the device write-protect reads the refcounts;
        # a live lazy-CoW lease's page reports 1 so its holder may append
        dec.set_page_table(
            cfg, cache, alloc.table,
            page_ref=alloc.writable_ref_view() if pcache is not None
            else None)

    def _copy(cp) -> None:
        if cp is not None:
            dec.copy_phys_pages(cache, [cp])
            ctr.cow_copies += 1

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
    steps = 0
    step_s: List[float] = []
    prefill_s: Dict[str, List[float]] = {"hit": [], "miss": [],
                                         "migrated": []}
    # host clocks of the index's work (reported, never checkpointed)
    replica_s: Dict[str, Any] = {"lookup": [], "migrate": [], "publish": [],
                                 "publish_bytes": 0}
    noted: set = set()               # requests whose hit/miss is counted
    swapped_recs: Dict[int, Dict[str, Any]] = {}  # request → swap record
    preempt_count: Dict[int, int] = {}
    admit_seq: Dict[int, int] = {}
    admit_clock = 0
    req_steps: Dict[int, int] = {}   # watchdog: steps each request held
    timed_out: set = set()
    defer_until: Dict[int, int] = {}      # request → earliest retry step
    defer_backoff: Dict[int, int] = {}
    blk = attn.decode_block_size(cfg, max_len)
    tile_bytes = 2 * blk * cfg.hd * dtype_bytes
    plan = None if kv_name is None else cache[kv_name].get("plan")
    degrade_log: Dict[int, List] = {}     # request → [(step, rung), ...]
    retire_log: Dict[int, List] = {}      # request → [(step, pages freed)]
    qos_dirty = False
    pressure_now = False

    # --- SLO degradation ladder over the per-slot plan knob vectors
    qosctl: Optional[QoSController] = None
    if cfg.sata.qos.ladder:
        if plan is None or "budget" not in plan:
            raise ValueError(
                "sata_qos_ladder degrades the SATA decode plan — turn on "
                "sata_decode routing (the cache carries no qos plan)")
        nkb0 = max_len // blk
        p0 = cfg.sata.decode.blocks or nkb0
        qosctl = QoSController(batch_slots, p0=min(int(p0), nkb0),
                               iv0=attn._resolve_replan(cfg)[0],
                               clear_steps=cfg.sata.qos.clear_steps)

    # --- cascade token retirement: cold blocks' pages return to the
    # pool mid-stream
    retire_on = cfg.sata.retire.mode == "on"
    if retire_on:
        if alloc is None or plan is None or "imp" not in plan:
            raise ValueError(
                "sata_retire='on' frees pages through the paged allocator "
                "and ranks blocks by the decode plan's importance "
                "accumulator — it needs kv_cache_layout='paged' AND sata "
                "decode routing")
        retire_keep = float(cfg.sata.retire.keep)
        retire_mark = float(cfg.sata.retire.watermark)

    def _log_rungs(changed: List[int]) -> None:
        """Record rung transitions on the occupying requests' timelines
        and mark the device knob vectors stale."""
        nonlocal qos_dirty
        for i in changed:
            qos_dirty = True
            r = slots[i]
            if r is not None:
                degrade_log.setdefault(r, []).append((steps, qosctl.rung[i]))

    def _retire_pass(force: bool) -> bool:
        """One retirement sweep: every active slot past its live-token
        watermark (every active slot when ``force``, pool pressure this
        step) retires its coldest completed blocks down to the ``keep``
        budget.  Importance is the plan's decayed selection accumulator
        summed over layers and kv heads; coldest first, ties retire the
        oldest block.  Never candidates: the block holding the write
        position and later ones, holes, and (``retire_compact``) pinned
        pages.  Returns True when a page was freed."""
        imp = None
        freed_any = False
        for i in range(batch_slots):
            r = slots[i]
            if r is None:
                continue
            ret = alloc.retired[i]
            live_tok = int(pos_h[i]) + 1 - page * len(ret)
            if not (force or live_tok >= retire_mark * max_len):
                continue
            cur_blk = int(pos_h[i]) // page
            live_lps = [lp for lp in range(int(alloc.n_mapped[i]))
                        if lp not in ret]
            cand = [lp for lp in live_lps if lp < cur_blk]
            keep_n = max(1, int(np.ceil(retire_keep * len(live_lps))))
            n_ret = min(len(live_lps) - keep_n, len(cand))
            if n_ret <= 0:
                continue
            if imp is None:                   # one device pull per sweep
                imp = plan["imp"].cpu().numpy()       # (L, B, KV, nkb)
            score = imp[:, i].sum(axis=(0, 1))         # (nkb,)
            cand.sort(key=lambda lp: (float(score[lp]), lp))
            chosen = cand[:n_ret]
            freed, skipped = alloc.retire_compact(i, chosen)
            retired_lps = [lp for lp in chosen if lp not in skipped]
            if not retired_lps:
                continue                      # every candidate was pinned
            dec.retire_plan(cfg, cache, i, retired_lps)
            if freed:
                dec.retire_phys_pages(cache, freed)
                freed_any = True
            ctr.retire_events += 1
            ctr.pages_reclaimed += len(freed)
            ctr.retired_tokens += page * len(retired_lps)
            retire_log.setdefault(r, []).append((steps, len(freed)))
        return freed_any

    def _clear_backoff() -> None:
        """Pool capacity may have grown: deferred claims re-check now."""
        defer_until.clear()
        defer_backoff.clear()

    def _gather_pages(phys):
        return dec.gather_phys_pages(cache, phys)

    def _scatter_pages(fresh, payload):
        dec.scatter_phys_pages(cache, fresh, payload)

    def _payload_bytes(rec) -> int:
        b = sum(a.nbytes for _, payload in rec["handle"]["chunks"]
                for a in payload.values())
        return b + sum(np.asarray(v).nbytes
                       for snap in rec["plan"].values()
                       for v in snap.values())

    def _protected() -> set:
        return {r for r, c in preempt_count.items()
                if c >= preempt_retry_limit}

    def _reserve_need(exclude: Optional[int] = None) -> int:
        """Pages admission holds back for queued protected requests (at
        the retry limit): a swapped one needs its payload pages, a
        requeued one its prompt's."""
        n = 0
        for r in queue:
            if r == exclude or preempt_count.get(r, 0) < preempt_retry_limit:
                continue
            if r in swapped_recs:
                n += alloc.swap_pages_needed(swapped_recs[r]["handle"])
            else:
                n += alloc.pages_for(prompt_len)
        return n

    def _defer(r0: int) -> None:
        nonlocal pressure_now
        pressure_now = True                   # organic pool pressure
        ctr.deferred_claims += 1                      # backpressure: wait
        bo = min(max(defer_backoff.get(r0, 0) * 2, 1), 8)
        defer_backoff[r0] = bo
        defer_until[r0] = steps + bo

    def _finish(i: int, now: float) -> None:
        """Slot ``i``'s request completed (or timed out): free the slot
        and its page references (pages the trie or another slot holds
        survive)."""
        latency[slots[i]] = now - t_claim[slots[i]]
        slots[i] = None
        dec.release_slot(cfg, cache, i)
        if alloc is not None:
            alloc.free_slot(i)
            _clear_backoff()

    def _swap_out(victim: int) -> None:
        """Host-swap the victim: the plan snapshot first (the slot is
        still live), then its pages (gathered before they free), then
        release.  Its decoded output and position are kept: a restore
        resumes, it does not regenerate."""
        r = slots[victim]
        snap = dec.capture_plan_state(cfg, cache, victim)
        handle = alloc.swap_out(victim, _gather_pages)
        rec = {"handle": handle, "plan": snap, "pos": int(pos_h[victim]),
               "token": int(tokens_h[victim, 0])}
        rec["bytes"] = _payload_bytes(rec)
        swapped_recs[r] = rec
        ctr.tokens_salvaged += len(outputs[r])
        queue.insert(0, r)
        slots[victim] = None
        dec.release_slot(cfg, cache, victim)
        ctr.host_swaps += 1
        ctr.host_swap_bytes_now += rec["bytes"]
        ctr.host_swap_bytes_peak = max(ctr.host_swap_bytes_peak,
                                       ctr.host_swap_bytes_now)

    def _preempt(victim: int) -> None:
        """Evict the victim: host swap when the host budget holds its
        estimated payload, else requeue — its decoded output is
        discarded and regenerated on re-admission (deterministic decode
        leaves the final outputs unchanged; shared pages survive through
        their other references)."""
        r = slots[victim]
        preempt_count[r] = preempt_count.get(r, 0) + 1
        est = int(alloc.n_mapped[victim]) * swap_page_bytes
        fits = (host_swap_bytes is None
                or ctr.host_swap_bytes_now + est <= host_swap_bytes)
        if can_swap and fits and alloc.n_mapped[victim] > 0:
            _swap_out(victim)
        else:
            ctr.produced -= len(outputs[r])
            ctr.requeue_tokens_discarded += len(outputs[r])
            outputs[r] = []
            queue.insert(0, r)
            slots[victim] = None
            dec.release_slot(cfg, cache, victim)
            alloc.free_slot(victim)
            ctr.requeue_preemptions += 1
        ctr.preemptions += 1
        _clear_backoff()                  # the victim's pages freed

    def _to_full(rec) -> None:
        """Turn a swap record's resident pins into host payload."""
        alloc.swap_to_full(rec["handle"], _gather_pages)
        nb = _payload_bytes(rec)
        ctr.host_swap_bytes_now += nb - rec["bytes"]
        rec["bytes"] = nb

    def _crash_restore() -> None:
        """Mid-serve crash: every byte on the device is about to be lost,
        so outstanding handles turn their resident pages into host
        payload and every live slot swaps out in full; then the device
        cache, the allocator and the (empty) trie are built anew, and
        the claim loop re-admits each request from its handle —
        positions, plan state and decoded output all survive."""
        nonlocal cache, plan, alloc, pcache, last_rep, rep_base
        for rec in swapped_recs.values():
            _to_full(rec)
        # reversed: each insert(0) lands the lowest slot at the queue
        # head, so re-admission replays in slot order
        for i in reversed(range(batch_slots)):
            r = slots[i]
            if r is not None:
                _swap_out(i)                  # a crash ignores the budget
                _to_full(swapped_recs[r])
        ctr.host_swap_bytes_peak = max(ctr.host_swap_bytes_peak,
                                       ctr.host_swap_bytes_now)
        handles = alloc.swapped
        squeezed_n = len(alloc.squeezed)
        # drop the old pool before the new one exists, as a crash would
        cache[kv_name].clear()
        plan = None
        cache = dec.init_cache(cfg, batch_slots, max_len, device=dev)
        plan = cache[kv_name].get("plan")
        # lazy_cow stays at its default here, as in the reference's
        # rebuild
        alloc = PageAllocator(n_pages, batch_slots, max_len // page, page,
                              audit=res.audit_pages)
        alloc.swapped = handles               # payload survives the crash
        alloc.squeeze(squeezed_n)             # injected pressure persists
        if pcache is not None:
            old = pcache
            pcache = PrefixCache(alloc)       # trie contents are lost...
            pcache.hits, pcache.misses = old.hits, old.misses
            pcache.tokens_saved = old.tokens_saved      # ...stats carry
            pcache.evictions = old.evictions
        for i in range(batch_slots):
            dec.release_slot(cfg, cache, i)
        _push_tables()
        # fold the pre-crash re-plan count into the offset; the fresh
        # cache's counters restart the delta accounting
        if last_rep is not None:
            ctr.rep_offset += float((last_rep - rep_base).mean())
            last_rep = _replans()
            rep_base = last_rep.copy()
        ctr.crashes += 1

    def _quarantine(r0: int) -> None:
        """The head request's parked handle failed its checksum: drop the
        handle, invalidate trie entries over its resident pages, and
        recover the request by re-prefill (its salvaged progress is lost
        with the payload)."""
        rec = swapped_recs.pop(r0)
        ctr.quarantined_pages += sum(len(lps)
                                     for lps, _ in rec["handle"]["chunks"])
        bad = alloc.discard_handle(rec["handle"])
        if pcache is not None and bad:
            ctr.trie_nodes_invalidated += pcache.invalidate_pages(bad)
        ctr.host_swap_bytes_now -= rec["bytes"]
        ctr.corrupt_pages_detected += 1
        ctr.produced -= len(outputs[r0])
        ctr.requeue_tokens_discarded += len(outputs[r0])
        ctr.tokens_salvaged -= len(outputs[r0])
        outputs[r0] = []

    def _corrupt(nth: int) -> None:
        """Flip one byte of the ``nth`` outstanding handle's first parked
        chunk (a deterministic offset); the claim gate must catch it."""
        recs = sorted(swapped_recs)
        if not recs:
            return
        chunks = swapped_recs[recs[nth % len(recs)]]["handle"]["chunks"]
        if not chunks:
            return
        payload = chunks[0][1]
        key = sorted(payload)[0]
        arr = np.array(payload[key])          # an owning, writable copy
        payload[key] = arr
        flat = arr.view(np.uint8).reshape(-1)
        flat[(steps * 131 + nth) % flat.size] ^= 0x01
        ctr.corrupt_pages_injected += 1

    def _swap_in(i: int, r0: int, reserve: int, protected: bool) -> bool:
        """Re-admit swapped request ``r0`` into slot ``i``: its pages
        scatter back into fresh pages, its plan reinstalls reset-free,
        and decode resumes at the swapped position with the swapped next
        token.  False = deferred (the pool cannot back it yet)."""
        nonlocal admit_clock, qos_dirty
        rec = swapped_recs[r0]
        needed = alloc.swap_pages_needed(rec["handle"]) + reserve
        if not alloc.can_admit(needed):
            if pcache is not None:
                pcache.evict(needed)
            if not alloc.can_admit(needed):
                _defer(r0)
                return False
        t_res = time.time()
        ok = alloc.swap_in(i, rec["handle"], _scatter_pages)
        assert ok, "can_admit reserved the payload pages"
        dec.restore_plan_state(cfg, cache, i, rec["plan"])
        _push_tables()
        queue.pop(0)
        slots[i] = r0
        admit_seq[r0] = admit_clock
        admit_clock += 1
        defer_until.pop(r0, None)
        defer_backoff.pop(r0, None)
        if qosctl is not None and qosctl.reset(i):
            qos_dirty = True                  # a fresh episode: rung 0
        pos_h[i] = rec["pos"]
        tokens_h[i, 0] = rec["token"]
        snap = rec["plan"].get(kv_name)
        if last_rep is not None:
            if rec["pos"] > 0 and (snap is None
                                   or not np.asarray(snap["active"]).any()):
                ctr.swap_cold_replans += 1    # 0 when the plan moved live
            if snap is not None:
                # slot i's device counter jumps to the restored value:
                # absorb the jump into the baseline, it is no re-plan
                col = snap["replans"].astype(np.float64).reshape(-1)
                rep_base[:, i] += col - last_rep[:, i]
                last_rep[:, i] = col
        ctr.host_swap_bytes_now -= rec["bytes"]
        del swapped_recs[r0]
        ctr.swap_restores += 1
        if protected:
            ctr.protected_admissions += 1
        ctr.restore_wall += time.time() - t_res
        return True

    def _migrate(i: int, r: int, mig) -> int:
        """Copy an index hit's pages into slot ``i``'s fresh pages and
        register them in the local trie; the slot then continues as a
        local full-page hit (it owns the pages, the trie holds its
        reference, so copy-on-write is the ordinary owner case).
        Returns the migrated rows."""
        t_mig = time.perf_counter()
        rows, payload, _ = mig
        npg = rows // page
        ok = alloc.ensure(i, rows - 1)
        assert ok, "admission control reserved these pages"
        _scatter_pages([int(p) for p in alloc.table[i, :npg]], payload)
        pcache.register(prompts[r, :rows], alloc.table[i])
        _push_tables()
        ctr.cross_replica_hits += 1
        ctr.migrated_pages += npg
        ctr.migrated_tokens += rows
        prefix_index.remote_hits += 1
        replica_s["migrate"].append(time.perf_counter() - t_mig)
        return rows

    def _publish(i: int, r: int) -> None:
        """Publish the prompt's matchable full pages (matchers walk
        ``tokens[:-1]``); the trie keeps full prompt pages append-frozen,
        so the host copy taken here stays valid.  Every full page is
        gathered, and the index then skips the digests it knows."""
        full = ((prompt_len - 1) // page) * page
        if not full:
            return
        t_pub = time.perf_counter()
        payload = _gather_pages([int(p) for p in
                                 alloc.table[i, :full // page]])
        ctr.index_publishes += prefix_index.publish(
            replica_id, prompts[r, :full], page, payload)
        replica_s["publish"].append(time.perf_counter() - t_pub)
        replica_s["publish_bytes"] += sum(a.nbytes for a in payload.values())

    def _claim_prefill(i: int, r: int, m: int, phys_m: List[int],
                       mig=None) -> None:
        """Prefill request ``r``'s prompt into slot ``i`` and record its
        first token.  With a cached prefix of ``m`` tokens on pages
        ``phys_m`` the slot maps them, copies a partially matched last
        page before the tail writes into it, and prefills the tail over
        the gathered prefix; the prompt's pages then enter the trie.
        ``mig``, a cross-replica index hit, replaces the local match: its
        pages are copied in first (``_migrate``)."""
        t_pf = time.perf_counter()
        if pcache is not None and r not in noted:
            # once per REQUEST: a requeued request's re-claim hits its
            # own registered pages and must not count twice
            noted.add(r)
            pcache.note(mig[0] if mig is not None else m)
        if mig is not None:
            m, phys_m = _migrate(i, r, mig), []   # the slot maps them
        if phys_m:
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
            if prefix_index is not None:
                _publish(i, r)
        pos_h[i] = prompt_len
        # the prefill's last-position argmax IS the first generated token
        first = int(torch.argmax(lg0[0]))
        prefill_s["migrated" if mig is not None else "hit" if m
                  else "miss"].append(time.perf_counter() - t_pf)
        outputs[r].append(first)
        ctr.produced += 1
        tokens_h[i, 0] = first

    def _replans() -> Optional[np.ndarray]:
        return None if plan is None else \
            plan["replans"].cpu().numpy().astype(np.float64)

    def _held() -> List[int]:
        return [j for j in range(batch_slots) if slots[j] is not None]

    ckpt = None
    if res.checkpoint_dir is not None:
        from repro_torch.checkpoint.manager import CheckpointManager
        ckpt = CheckpointManager(res.checkpoint_dir, keep=2)
    last_ckpt = -1
    resumed_at: Optional[int] = None
    with torch.inference_mode():
        # every slot starts RELEASED; a claim re-activates it
        for i in range(batch_slots):
            dec.release_slot(cfg, cache, i)
        last_rep = _replans()
        rep_base = None if last_rep is None else last_rep.copy()
        if res.resume:
            assert ckpt is not None, "resume=True needs checkpoint_dir"
            rstep = ckpt.latest_step()
            assert rstep is not None, "resume=True but no checkpoint on disk"
            ckpt.restore(like=cache, step=rstep)
            # bytes this program wrote with its own checkpoint
            m = pickle.loads(ckpt.load_meta(rstep))
            steps = last_ckpt = resumed_at = m["steps"]
            queue, outputs, latency = m["queue"], m["outputs"], m["latency"]
            slots, pos_h, tokens_h = m["slots"], m["pos_h"], m["tokens_h"]
            alloc, pcache = m["alloc"], m["pcache"]
            swapped_recs, preempt_count = m["swapped_recs"], \
                m["preempt_count"]
            admit_seq, admit_clock = m["admit_seq"], m["admit_clock"]
            req_steps, timed_out, noted = m["req_steps"], m["timed_out"], \
                m["noted"]
            defer_until, defer_backoff = m["defer_until"], \
                m["defer_backoff"]
            last_rep, rep_base = m["last_rep"], m["rep_base"]
            qosctl, degrade_log = m["qosctl"], m["degrade_log"]
            retire_log = m["retire_log"]
            rng.bit_generator.state = m["rng"]
            vars(ctr).update(m["ctrs"])
            # wall clocks re-anchor: resumed latencies measure this
            # process's wall; outputs and counters stay bitwise
            t_claim = {r: time.time() for r in m["t_claim_reqs"]}
            if alloc is not None:
                _push_tables()
        t0 = time.time()
        max_steps = 4 * (n_requests * gen_len + batch_slots + 1)
        while (queue or any(s is not None for s in slots)) \
                and steps < max_steps:
            if (ckpt is not None and res.checkpoint_every > 0
                    and steps % res.checkpoint_every == 0
                    and steps != last_ckpt):
                meta = {
                    "steps": steps, "queue": list(queue),
                    "outputs": outputs, "latency": latency,
                    "slots": list(slots), "pos_h": pos_h.copy(),
                    "tokens_h": tokens_h.copy(), "alloc": alloc,
                    "pcache": pcache, "swapped_recs": swapped_recs,
                    "preempt_count": preempt_count, "admit_seq": admit_seq,
                    "admit_clock": admit_clock, "req_steps": req_steps,
                    "timed_out": timed_out, "noted": noted,
                    "defer_until": defer_until,
                    "defer_backoff": defer_backoff,
                    "last_rep": last_rep, "rep_base": rep_base,
                    "qosctl": qosctl, "degrade_log": degrade_log,
                    "retire_log": retire_log,
                    "rng": rng.bit_generator.state,
                    "t_claim_reqs": list(t_claim),
                    "ctrs": {k: v for k, v in vars(ctr).items()
                             if k not in _REPLICA_CTRS},
                }
                # ONE pickle: alloc.swapped, the trie's allocator and each
                # swap record's handle keep their shared identity (swap_in
                # checks it)
                ckpt.save(steps, cache, blocking=True,
                          meta_blob=pickle.dumps(meta))
                last_ckpt = steps
            if res.kill_at_step is not None and steps == res.kill_at_step:
                raise ServeKilled(f"injected process kill at loop step "
                                  f"{steps}")
            defer_now = False
            pressure_now = False
            for kind, arg in (faults.at(steps) if faults is not None
                              else ()):
                if kind == "pool_squeeze":
                    alloc.squeeze(arg)
                elif kind == "pool_restore":
                    alloc.unsqueeze(arg)
                    _clear_backoff()              # capacity returned
                elif kind == "load_spike":
                    ctr.load_spikes_seen += 1
                    sev = 1 if arg is None else max(1, int(arg))
                    if qosctl is not None:
                        # shed quality, not requests: every active slot
                        # steps down ``sev`` rungs in place
                        _log_rungs(qosctl.press(_held(), sev))
                        pressure_now = True
                    else:
                        # no ladder: one preemption per severity unit
                        for _ in range(sev):
                            if not _held():
                                break
                            _preempt(_pick_victim(_held(), slots, outputs,
                                                  admit_seq, _protected()))
                            _push_tables()
                elif kind == "slow_step":
                    ctr.slow_steps_seen += 1
                    if qosctl is not None:        # deadline pressure
                        _log_rungs(qosctl.press(_held(), 1))
                        pressure_now = True
                elif kind == "corrupt_page":
                    _corrupt(0 if arg is None else int(arg))
                elif kind == "defer_admission":
                    defer_now = True
                elif kind == "preempt":
                    tgt = arg
                    if tgt is None and _held():
                        tgt = _pick_victim(_held(), slots, outputs,
                                           admit_seq, _protected())
                    if tgt is not None and slots[tgt] is not None:
                        _preempt(tgt)
                        _push_tables()
                elif kind == "crash_step":
                    _crash_restore()
            for i in range(batch_slots):              # claim free slots
                if slots[i] is not None or not queue or defer_now:
                    continue
                r0 = queue[0]
                if steps < defer_until.get(r0, 0):
                    ctr.deferred_retries_skipped += 1
                    break               # backoff; keep admission order
                if r0 in swapped_recs:
                    # integrity gate BEFORE any page is reserved: a handle
                    # corrupted while parked must never scatter back
                    try:
                        alloc.verify_handle(swapped_recs[r0]["handle"])
                    except PageIntegrityError:
                        _quarantine(r0)
                protected = preempt_count.get(r0, 0) >= preempt_retry_limit
                reserve = 0 if (alloc is None or protected) \
                    else _reserve_need(exclude=r0)
                if r0 in swapped_recs:
                    if not _swap_in(i, r0, reserve, protected):
                        break
                    continue
                # prefix match BEFORE admission: matched pages shrink the
                # claim's pool demand (match tokens[:-1] so the tail
                # prefill always yields last-token logits)
                m, phys_m = 0, []
                mig = None
                if pcache is not None and use_prefill:
                    m, phys_m, _ = pcache.match(prompts[r0, :-1])
                    if prefix_index is not None:
                        t_look = time.perf_counter()
                        hit = prefix_index.lookup(replica_id,
                                                  prompts[r0, :-1])
                        replica_s["lookup"].append(
                            time.perf_counter() - t_look)
                        # migrate only when another replica's pages beat
                        # the local trie: re-importing this replica's own
                        # (evicted) pages is just a re-prefill
                        if hit is not None and hit[0] > m and hit[2] > 0:
                            mig = hit
                if alloc is not None:
                    def _need():
                        if mig is not None:
                            # migrated pages are fresh local copies: the
                            # claim pays for every prompt page (the gain
                            # is prefill compute, not pool pages)
                            return alloc.pages_for(prompt_len)
                        return max(alloc.pages_for(prompt_len)
                                   - len(phys_m) + (1 if m % page else 0),
                                   0)
                    if not alloc.can_admit(_need() + reserve):
                        if pcache is not None:
                            pcache.evict(_need() + reserve)
                            # eviction may have dropped matched pages
                            m, phys_m, _ = pcache.match(prompts[r0, :-1])
                        if mig is not None and \
                                not alloc.can_admit(_need() + reserve):
                            # a migration is optional work: under pool
                            # pressure fall back to the plain (cheaper)
                            # admission before deferring
                            mig = None
                            ctr.migrations_dropped += 1
                        if not alloc.can_admit(_need() + reserve):
                            _defer(r0)
                            break
                r = queue.pop(0)
                slots[i] = r
                admit_seq[r] = admit_clock
                admit_clock += 1
                defer_until.pop(r, None)
                defer_backoff.pop(r, None)
                if qosctl is not None and qosctl.reset(i):
                    qos_dirty = True          # a fresh episode: rung 0
                if protected:
                    ctr.protected_admissions += 1
                if preempt_count.get(r, 0) and use_prefill:
                    ctr.re_prefill_tokens += prompt_len - m   # redone
                outputs[r] = []
                t_claim[r] = time.time()
                dec.reset_slot(cfg, cache, i)
                if use_prefill:
                    _claim_prefill(i, r, m, phys_m, mig)
                    if len(outputs[r]) >= gen_len or pos_h[i] >= max_len:
                        _finish(i, time.time())       # gen_len=1: done
                else:
                    pos_h[i] = 0
                    tokens_h[i, 0] = int(prompts[r, 0])
            active = _held()
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
                    # request completes — livelock: preempt the
                    # least-progress victim (swap keeps its progress,
                    # requeue regenerates it)
                    if pcache is not None and pcache.evict(1):
                        continue
                    _preempt(_pick_victim(stalled, slots, outputs,
                                          admit_seq, _protected()))
                ctr.stalled_steps += len(stalled)
                _push_tables()
                active = _held()
            if qosctl is not None:
                if stalled:
                    pressure_now = True           # organic pool pressure
                # the hysteresis clock ticks once a step, then changed
                # knobs reach the plan before this step's compute
                _log_rungs(qosctl.tick(active, pressure_now))
                ctr.degraded_steps += sum(1 for i in active
                                          if qosctl.rung[i] > 0)
                if qos_dirty:
                    dec.set_qos_knobs(cache, *qosctl.vectors())
                    qos_dirty = False
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
                    pb, qn, sk, lv = cfg.sata.decode.blocks, None, None, None
                    if qosctl is not None:
                        # price each live slot at its own rung's budget,
                        # summary size and re-plan mode
                        kn = [qosctl.knobs(i) for i in live]
                        pb = np.asarray([k[0] for k in kn], np.int64)
                        qn = np.asarray([k[2] for k in kn], bool)
                        sk = np.asarray([k[3] for k in kn], bool)
                    if retire_on:
                        # retired blocks left the ranking set
                        lv = np.asarray([max_len // blk
                                         - len(alloc.retired[i])
                                         for i in live], np.int64)
                    st = decode_fetch_stats(
                        counts[:, live], pos_h[live], k_block=blk, d=cfg.hd,
                        replan=delta[:, live].mean(axis=0),
                        nkb=max_len // blk, dtype_bytes=dtype_bytes,
                        summary=cfg.sata.decode.summary,
                        replan_mode=cfg.sata.decode.replan_mode,
                        sketch_factor=cfg.sata.decode.sketch_factor,
                        plan_blocks=pb, quant=qn, sketch=sk,
                        live_blocks=lv)
                    ctr.fetch_tiles_plan += st["kv_fetch_tiles_plan"]
                    ctr.fetch_tiles_dense += st["kv_fetch_tiles_dense"]
                    ctr.plan_bytes += st["plan_fetch_bytes_step"]
                    ctr.kernel_bytes_plan += st["kv_fetch_bytes_plan"]
                    ctr.kernel_bytes_dense += st["kv_fetch_bytes_dense"]
            now = time.time()
            for i in range(batch_slots):
                r = slots[i]
                if r is None:
                    continue
                # watchdog clock: every step HOLDING the slot counts,
                # stalled or not
                req_steps[r] = req_steps.get(r, 0) + 1
                if i not in stalled:                  # stalled: re-fed
                    outputs[r].append(int(nxt[i]))
                    ctr.produced += 1
                    pos_h[i] += 1
                done = len(outputs[r]) >= gen_len or pos_h[i] >= max_len
                if (not done and res.max_steps_per_request is not None
                        and req_steps[r] >= res.max_steps_per_request):
                    # graceful retirement: the partial output stands, the
                    # pages free, the request is not requeued
                    timed_out.add(r)
                    done = True
                if done:
                    _finish(i, now)
                elif i not in stalled:
                    tokens_h[i, 0] = int(nxt[i])
            if retire_on:
                # after the step: its selection is in the importance
                # accumulator and completed slots have released
                t_ret, ev = time.perf_counter(), ctr.retire_events
                if _retire_pass(pressure_now or bool(stalled)):
                    _push_tables()
                    _clear_backoff()          # freed pages: re-check now
                if ctr.retire_events > ev:    # host clock of a pass that
                    ctr.retire_passes += 1    # retired blocks
                    ctr.retire_pass_s += time.perf_counter() - t_ret
            steps += 1
        wall = time.time() - t0
    out: Dict[str, Any] = {
        "outputs": outputs, "tokens_generated": ctr.produced,
        "tok_per_s": ctr.produced / max(wall, 1e-9), "steps": steps,
        "step_ms_mean": 1e3 * float(np.mean(step_s)) if step_s else 0.0,
        # host clock from the claim's prefix match to its first token
        # (which waits for the device)
        "prefill_ms_mean": {k: 1e3 * float(np.mean(v)) if v else None
                            for k, v in prefill_s.items()},
        "request_latency_s": latency,
        "latency_mean_s": float(np.mean(list(latency.values())))
        if latency else 0.0,
        "timed_out": sorted(timed_out),
        "device": str(dev),
        # every (step, rung) transition while the request held its slot:
        # empty means full quality end to end
        "degradation": {r: list(degrade_log.get(r, [])) for r in outputs},
    }
    if retire_on:
        # per-KV-head importance summed over layers, slots and blocks:
        # report only
        head_imp = plan["imp"].cpu().numpy().sum(axis=(0, 1, 3))
        out["retire_pass_ms_mean"] = \
            1e3 * ctr.retire_pass_s / max(ctr.retire_passes, 1)
        out["retirement"] = {
            "events": ctr.retire_events,
            "pages_reclaimed": ctr.pages_reclaimed,
            "retired_tokens": ctr.retired_tokens,
            "timelines": {r: list(retire_log.get(r, [])) for r in outputs},
            "head_importance": [float(x) for x in head_imp],
            "keep_budget": retire_keep,
            "watermark": retire_mark,
        }
    if qosctl is not None:
        out["qos"] = {
            "rung_downs": qosctl.rung_downs,
            "rung_ups": qosctl.rung_ups,
            "degraded_steps": ctr.degraded_steps,
            "load_spikes": ctr.load_spikes_seen,
            "slow_steps": ctr.slow_steps_seen,
            "clear_steps": qosctl.clear_steps,
            "final_rungs": list(qosctl.rung),
        }
    if ckpt is not None:
        out["checkpoint"] = {"dir": str(res.checkpoint_dir),
                             "last_saved_step": last_ckpt,
                             "resumed_at": resumed_at}
    if ctr.fetch_tiles_dense:
        out["decode_fetch"] = {
            "kv_fetch_tiles_plan": ctr.fetch_tiles_plan,
            "kv_fetch_tiles_dense": ctr.fetch_tiles_dense,
            "kv_fetch_bytes_plan": ctr.fetch_tiles_plan * tile_bytes,
            "kv_fetch_bytes_dense": ctr.fetch_tiles_dense * tile_bytes,
            "fetch_reduction": ctr.fetch_tiles_dense
            / max(ctr.fetch_tiles_plan, 1),
            "plan_fetch_bytes": ctr.plan_bytes,
            "summary_backend": cfg.sata.decode.summary,
            "replan_mode": cfg.sata.decode.replan_mode,
            "step_bytes_plan_route": ctr.kernel_bytes_plan + ctr.plan_bytes,
            "step_bytes_dense_route": ctr.kernel_bytes_dense,
            "true_reduction": ctr.kernel_bytes_dense
            / max(ctr.kernel_bytes_plan + ctr.plan_bytes, 1),
            "replans": ctr.rep_offset + float((last_rep - rep_base).mean()),
        }
    if alloc is not None:
        row_bytes = 2 * cfg.n_kv_heads * cfg.hd * dtype_bytes
        occ = alloc.stats(row_bytes=row_bytes, layers=n_kv_layers)
        occ["contiguous_reserved_bytes"] = \
            batch_slots * max_len * row_bytes * n_kv_layers
        occ["reserved_vs_contiguous"] = (occ["contiguous_reserved_bytes"]
                                         / max(occ["hbm_reserved_bytes"], 1))
        for k in ("deferred_claims", "stalled_steps", "preemptions",
                  # swap keeps progress, requeue discards it, a crash
                  # restores everything from host swap
                  "host_swaps", "swap_restores", "requeue_preemptions",
                  "tokens_salvaged", "requeue_tokens_discarded",
                  "re_prefill_tokens", "swap_cold_replans",
                  "host_swap_bytes_peak", "crashes", "protected_admissions",
                  "deferred_retries_skipped",
                  # page integrity: every injected corruption must be
                  # caught at the claim gate and quarantined
                  "corrupt_pages_injected", "corrupt_pages_detected",
                  "quarantined_pages", "trie_nodes_invalidated"):
            occ[k] = getattr(ctr, k)
        occ["swap_restore_wall_s"] = ctr.restore_wall
        occ["preempt_retries_max"] = max(preempt_count.values(), default=0)
        occ["preempted_requests"] = sum(1 for c in preempt_count.values()
                                        if c > 0)
        occ["audits_run"] = alloc.audits_run
        occ["light_audits_run"] = alloc.light_audits_run
        out["page_occupancy"] = occ
    if pcache is not None:
        pstats = pcache.stats()
        pstats["prefill_tokens_total"] = len(latency) * prompt_len
        pstats["cow_copies"] = ctr.cow_copies
        pstats["shared_pages_peak"] = alloc.shared_pages_peak
        out["prefix_cache"] = pstats
    if prefix_index is not None:
        def _ms(v):
            return 1e3 * float(np.mean(v)) if v else None
        out["replica"] = {
            "replica_id": int(replica_id),
            "cross_replica_hits": ctr.cross_replica_hits,
            "cross_replica_hit_rate": ctr.cross_replica_hits
            / max(len(latency), 1),
            "migrated_pages": ctr.migrated_pages,
            "migrated_tokens": ctr.migrated_tokens,
            "index_pages_published": ctr.index_publishes,
            "index": prefix_index.stats(),
            # the port's own: migrations given up under pool pressure,
            # and host clocks of a claim's index lookup, a
            # migration's ensure + scatter + register, a publish's
            # gather + publish (its bytes: every full page gathered)
            "lookup_ms_mean": _ms(replica_s["lookup"]),
            "migrate_ms_mean": _ms(replica_s["migrate"]),
            "publish_ms_mean": _ms(replica_s["publish"]),
            "publish_bytes": replica_s["publish_bytes"],
            "migrations_dropped": ctr.migrations_dropped,
        }
    return out


def serve_replicated(arch: str, *, n_replicas: int = 2, smoke: bool = True,
                     seed: int = 0, cfg=None,
                     options: Optional[ServeOptions] = None,
                     resilience: Optional[ResilienceOptions] = None,
                     model=None, device="cuda") -> Dict[str, Any]:
    """N-replica serve harness around one :class:`SharedPrefixIndex`.

    Each replica owns its page pool, trie and decode state and serves
    the same seeded workload (N frontends carrying one popular system
    prompt); they run one after another in this process — the point is
    the index protocol, not overlap — and each one's pool and cache are
    freed before the next starts.  Replica 0 prefills its prefixes cold
    and publishes them; later replicas migrate those pages instead of
    prefilling the shared prefix.  Asserts that every replica's outputs
    are bitwise equal (migration moves pages, never what they hold).

    ``model`` serves one set of weights on every replica (the reference
    builds each replica's identical weights from ``seed``; a model made
    by ``params_from_jax`` serves the reference's)."""
    index = SharedPrefixIndex()
    opt = options or ServeOptions()
    dev = resolve_device(device)
    reports = []
    for rid in range(int(n_replicas)):
        reports.append(serve(arch, smoke=smoke, seed=seed, model=model,
                             cfg=cfg, options=opt, device=dev,
                             resilience=resilience, prefix_index=index,
                             replica_id=rid))
        gc.collect()                   # the replica's pool and cache
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    hits = sum(r["replica"]["cross_replica_hits"] for r in reports)
    requests = sum(len(r["outputs"]) for r in reports)
    for a, b in zip(reports, reports[1:]):
        assert a["outputs"] == b["outputs"], \
            "replicas serving the same workload must agree bitwise"
    return {
        "replicas": reports,
        "n_replicas": int(n_replicas),
        "requests": requests,
        "cross_replica_hits": hits,
        "cross_replica_hit_rate": hits / max(requests, 1),
        "migrated_pages": sum(r["replica"]["migrated_pages"]
                              for r in reports),
        "migrated_tokens": sum(r["replica"]["migrated_tokens"]
                               for r in reports),
        "prefill_tokens_saved": sum(
            r.get("prefix_cache", {}).get("prefill_tokens_saved", 0)
            for r in reports),
        "outputs_equal": True,
        "index": index.stats(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=1)
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged KV pool")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="shared-prefix page cache (implies --paged)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="prompts share their first N tokens")
    ap.add_argument("--faults-seed", type=int, default=None,
                    help="inject a seeded FaultPlan schedule "
                         "(implies --paged)")
    ap.add_argument("--max-steps-per-request", type=int, default=None,
                    help="deadline watchdog: retire a slot as timed_out "
                         "after N held steps")
    ap.add_argument("--replicas", type=int, default=0,
                    help="run N serve replicas around one shared prefix "
                         "index (implies --paged --prefix-cache)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (the CPU only when asked)")
    args = ap.parse_args(argv)
    cfg = (SMOKE if args.smoke else ARCHS)[args.arch]
    if args.replicas:
        args.paged = args.prefix_cache = True
    if args.paged or args.prefix_cache or args.faults_seed is not None:
        from repro_torch.models.config import KVCacheConfig
        cfg = dataclasses.replace(
            cfg, kv=KVCacheConfig(layout="paged",
                                  prefix_cache=args.prefix_cache))
    faults = None
    if args.faults_seed is not None:
        faults = FaultPlan.seeded(args.faults_seed,
                                  steps=args.requests * args.gen_len,
                                  slots=args.slots)
        print(f"[serve] fault schedule (seed {args.faults_seed}):")
        print(faults.describe())
    opts = ServeOptions(n_requests=args.requests, batch_slots=args.slots,
                        gen_len=args.gen_len, prompt_len=args.prompt_len,
                        shared_prefix_len=args.shared_prefix_len)
    res = ResilienceOptions(
        max_steps_per_request=args.max_steps_per_request)
    if args.replicas:
        rep = serve_replicated(args.arch, n_replicas=args.replicas,
                               smoke=args.smoke, cfg=cfg, options=opts,
                               resilience=res, device=args.device)
        print(f"[serve] {rep['n_replicas']} replicas, "
              f"{rep['requests']} requests: cross-replica hit rate "
              f"{rep['cross_replica_hit_rate']:.2f} "
              f"({rep['cross_replica_hits']} migrations, "
              f"{rep['migrated_pages']} pages / "
              f"{rep['migrated_tokens']} tokens migrated), prefill "
              f"tokens saved {rep['prefill_tokens_saved']}, "
              f"outputs_equal={rep['outputs_equal']}")
        return
    out = serve(args.arch, smoke=args.smoke, cfg=cfg, options=opts,
                faults=faults, resilience=res, device=args.device)
    print(f"[serve] generated {out['tokens_generated']} tokens over "
          f"{len(out['outputs'])} requests "
          f"({out['tok_per_s']:.1f} tok/s on {out['device']}, "
          f"mean request latency {out['latency_mean_s'] * 1e3:.1f} ms)")
    if "decode_fetch" in out:
        f = out["decode_fetch"]
        print(f"[serve] SATA decode attention-kernel KV fetch: "
              f"{f['kv_fetch_bytes_plan']} B vs "
              f"{f['kv_fetch_bytes_dense']} B dense "
              f"({f['fetch_reduction']:.2f}x kernel-side); with plan "
              f"traffic ({f['plan_fetch_bytes']} B, "
              f"{f['replans']:.0f} re-plans): {f['true_reduction']:.2f}x "
              f"end-to-end")
    if "page_occupancy" in out:
        o = out["page_occupancy"]
        print(f"[serve] paged pool: {o['pages_in_use_peak']}/{o['n_pages']}"
              f" pages peak, HBM used {o['hbm_used_peak_bytes']} B of "
              f"{o['hbm_reserved_bytes']} B reserved "
              f"({o['reserved_vs_contiguous']:.2f}x less reserved than "
              f"contiguous would need; {o['deferred_claims']} deferred "
              f"claims, {o['stalled_steps']} stalled steps)")
        if o["preemptions"] or o["crashes"]:
            print(f"[serve] fault tolerance: {o['host_swaps']} host-swaps "
                  f"({o['tokens_salvaged']} tokens salvaged, "
                  f"{o['swap_restores']} restores, re_prefill_tokens="
                  f"{o['re_prefill_tokens']}, cold_replans="
                  f"{o['swap_cold_replans']}), "
                  f"{o['requeue_preemptions']} requeues "
                  f"({o['requeue_tokens_discarded']} tokens discarded), "
                  f"{o['crashes']} crashes recovered, "
                  f"{o['audits_run']} invariant audits")
    if "prefix_cache" in out:
        p = out["prefix_cache"]
        print(f"[serve] prefix cache: hit-rate {p['hit_rate']:.2f} "
              f"({p['hits']}/{p['requests']}), prefill tokens saved "
              f"{p['prefill_tokens_saved']}/{p['prefill_tokens_total']}, "
              f"{p['cow_copies']} CoW copies, {p['cached_pages']} cached "
              f"pages ({p['evictions']} evicted), shared-page peak "
              f"{p['shared_pages_peak']}")


if __name__ == "__main__":
    main()
