"""Serving demo on the PyTorch port: batched request decoding through
the SATA decode route — incremental per-slot KV-block plan + selective
gather kernel — using the qwen3-family reduced config.  Prints the
fetch-byte savings the plan banks against dense decode over the whole
prefix, and (with
``--paged``) serves from the paged KV pool: half the contiguous HBM
reservation, identical outputs, pool exhaustion absorbed as
backpressure instead of a shape error.

With ``--faults SEED`` the demo turns adversarial: a deterministic
squeeze/crash schedule forces host-swap preemptions and a mid-serve
crash, the allocator's invariant audit stays on throughout, and the
demo asserts the restored outputs are bitwise equal to the fault-free
run with zero re-prefilled tokens and zero cold re-plans.

With ``--overload SEED`` the demo runs the overload-resilience
scenario: a seeded load-spike schedule that forces >=2 preemptions
without the QoS ladder completes EVERY request with zero
requeues/timeouts when the ladder absorbs the pressure as per-slot
quality rungs, a corrupted host-swap payload is detected at the
swap-in checksum gate and quarantined (victim recovers by re-prefill),
and a child process killed mid-serve resumes from its checkpoint in
THIS process with bitwise-equal outputs.

With ``--retire`` the demo serves a workload whose live prefixes do
not fit the pool: cascade token retirement frees the coldest blocks'
pages mid-stream and the run completes without the preemptions the
retire-off twin needs.

With ``--replicas N`` the demo runs N serve replicas around one shared
prefix index: replica 0 publishes its shared-prefix pages' digests,
later replicas migrate those pages into their own pools instead of
re-prefilling, and the cross-replica hit rate is reported (outputs
bitwise equal across replicas).

Every scenario runs on ``--device`` (default ``cuda``; ``--device cpu``
runs the kernels' plain versions), and the overload scenario's child
process inherits it.  Every config knob is spelled nested, so the file
runs clean under ``-W error::DeprecationWarning``.

Run:  PYTHONPATH=src python examples/serve_topk_torch.py [--device cpu]
          [--paged] [--shared-prefix] [--summary int8]
          [--replan-mode sketch] [--retire] [--replicas N]
          [--faults SEED] [--overload SEED]
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile

from repro_torch.configs.archs import SMOKE
from repro_torch.launch.faults import FaultPlan
from repro_torch.launch.serve import (ResilienceOptions, ServeKilled,
                                      ServeOptions, serve, serve_replicated)
from repro_torch.models.config import (KVCacheConfig, QosConfig,
                                       RetireConfig, SataDecodeConfig)


def _with_decode(cfg, **kw):
    """Replace fields on ``cfg.sata.decode`` (nested-config idiom)."""
    return dataclasses.replace(
        cfg, sata=dataclasses.replace(
            cfg.sata,
            decode=dataclasses.replace(cfg.sata.decode, **kw)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged KV pool (half the "
                         "contiguous reservation)")
    ap.add_argument("--shared-prefix", action="store_true",
                    help="shared-prefix scenario: requests share a "
                         "prompt prefix and the prefix cache maps its "
                         "pages instead of re-prefilling them")
    ap.add_argument("--summary", choices=("fp32", "int8"), default="fp32",
                    help="block-summary backend: int8 stores "
                         "conservatively-quantized bounds (~4x less "
                         "summary traffic; summaries only RANK blocks "
                         "— the exact token threshold still runs over "
                         "the planned blocks' fp32 keys)")
    ap.add_argument("--replan-mode", choices=("exact", "sketch"),
                    default="exact",
                    help="periodic re-plan: 'exact' streams all cached "
                         "K; 'sketch' ranks super-block sketches first "
                         "and reads only surviving candidate blocks "
                         "(sub-linear in cached K; approximate — safe "
                         "when the plan tolerates a missed block until "
                         "the next re-plan, NOT for bitwise-exact "
                         "serving)")
    ap.add_argument("--retire", action="store_true",
                    help="cascade token retirement scenario: a pool too "
                         "small for every live request's full prefix — "
                         "retire-off preempts its way through, retire-on "
                         "frees the coldest blocks' pages mid-stream and "
                         "completes without a single preemption")
    ap.add_argument("--faults", type=int, default=None, metavar="SEED",
                    help="fault-injection scenario: a deterministic "
                         "squeeze + crash schedule forces host-swap "
                         "preemptions; asserts bitwise-equal restored "
                         "outputs with the invariant audit on")
    ap.add_argument("--replicas", type=int, default=0, metavar="N",
                    help="cross-replica prefix index scenario: N serve "
                         "replicas (each with its own page pool) share "
                         "one prefix digest index — later replicas "
                         "migrate replica 0's published prefix pages "
                         "instead of re-prefilling them")
    ap.add_argument("--overload", type=int, default=None, metavar="SEED",
                    help="overload-resilience scenario: seeded load "
                         "spikes absorbed by the QoS degradation "
                         "ladder, a corrupted swap payload quarantined "
                         "at the checksum gate, and a cross-process "
                         "kill/resume from checkpoint — all asserted")
    # internal: overload child mode (run to the kill step, then die)
    ap.add_argument("--_ckpt-dir", dest="_ckpt_dir", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--_kill-at", dest="_kill_at", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda",
                    help="torch device (the CPU only when asked)")
    args = ap.parse_args(argv)
    dev = args.device
    cfg = dataclasses.replace(
        SMOKE["qwen3-4b"],
        topk_impl="bisect",         # bisect thresholds (the SATA predicate)
        sata=dataclasses.replace(
            SMOKE["qwen3-4b"].sata,
            decode=SataDecodeConfig(
                mode="on",          # route decode through the plan + kernel
                block=8,            # k-block edge over the 64-token cache
                replan=1,           # full re-plan every step (exact top-k)
                summary=args.summary,
                replan_mode=args.replan_mode)),
    )
    if args.replicas:
        return replicated_demo(cfg, args.replicas, dev)
    if args.overload is not None:
        child_args = ["--summary", args.summary,
                      "--replan-mode", args.replan_mode,
                      "--device", args.device]
        return overload_demo(cfg, args.overload, child_args, dev,
                             ckpt_dir=args._ckpt_dir,
                             kill_at=args._kill_at)
    if args.faults is not None:
        return faults_demo(cfg, args.faults, dev)
    if args.retire:
        return retire_demo(cfg, dev)
    if args.shared_prefix:
        return shared_prefix_demo(cfg, dev)
    if args.paged:
        # pool sized to HALF the contiguous reservation (3 slots × 8
        # pages): short-prefix slots stop reserving max_len worth of
        # HBM, and any transient over-demand stalls a slot for a step
        # instead of failing a shape
        cfg = dataclasses.replace(cfg, kv=KVCacheConfig(layout="paged",
                                                        pool_pages=12))
    # gen_len spans several k-blocks so top-k (4 keys) actually skips
    # blocks — the fetch-reduction line below is the point of the demo
    out = serve("qwen3-4b", device=dev, smoke=True, cfg=cfg,
                options=ServeOptions(n_requests=6, batch_slots=3,
                                     gen_len=48, max_len=64))
    print(f"[serve_topk] completed {len(out['outputs'])} requests, "
          f"{out['tokens_generated']} tokens in {out['steps']} decode steps "
          f"({out['tok_per_s']:.1f} tok/s on {out['device']}, mean request "
          f"latency "
          f"{out['latency_mean_s'] * 1e3:.1f} ms)")
    f = out["decode_fetch"]
    # kernel-side accounting: at sata_decode_replan=1 the exact
    # re-plan itself still reads the full prefix's keys each step —
    # plan_fetch_bytes/true_reduction report that honestly (raise the
    # interval or set sata_decode_replan="auto" to shrink it)
    print(f"[serve_topk] attention-kernel KV fetch: "
          f"{f['kv_fetch_bytes_plan']} B vs {f['kv_fetch_bytes_dense']} B "
          f"dense ({f['fetch_reduction']:.2f}x reduction; "
          f"{f['true_reduction']:.2f}x counting plan traffic, "
          f"summary={f['summary_backend']}, replan={f['replan_mode']})")
    if args.paged:
        o = out["page_occupancy"]
        print(f"[serve_topk] paged pool: peak {o['pages_in_use_peak']}/"
              f"{o['n_pages']} pages, reserved "
              f"{o['reserved_vs_contiguous']:.2f}x less HBM than "
              f"contiguous ({o['stalled_steps']} stalled steps, "
              f"{o['deferred_claims']} deferred claims)")
        assert o["reserved_vs_contiguous"] >= 1.5
    first = sorted(out["outputs"])[0]
    print(f"[serve_topk] request {first} tokens: {out['outputs'][first]}")
    assert all(len(v) == 48 for v in out["outputs"].values())
    assert f["kv_fetch_tiles_plan"] < f["kv_fetch_tiles_dense"]


def faults_demo(cfg, seed, dev):
    """Adversarial serving: a deterministic fault schedule — a hard
    pool squeeze (forces host-swap preemptions), seeded deferrals and
    forced preemptions, and a mid-serve crash — against a fault-free
    reference.  Host-swap restores must reproduce the reference
    bitwise with ZERO re-prefilled tokens and zero cold re-plans, and
    the allocator invariant audit runs after every mutation."""
    cfg = dataclasses.replace(_with_decode(cfg, replan=4),
                              kv=KVCacheConfig(layout="paged",
                                               pool_pages=6))
    opt = ServeOptions(n_requests=4, batch_slots=2, gen_len=12,
                       max_len=32, prompt_len=6)
    base = serve("qwen3-4b", device=dev, cfg=cfg, smoke=True, options=opt)
    faults = (FaultPlan.seeded(seed, steps=24, n_events=3,
                               max_squeeze=2, slots=2)
              .pool_squeeze(2, 3).pool_restore(14)   # forces ≥2 swaps
              .crash_step(20))
    print(f"[serve_topk] fault schedule (seed {seed}):")
    print(faults.describe())
    out = serve("qwen3-4b", device=dev, cfg=cfg, faults=faults, smoke=True,
                options=opt,
                resilience=ResilienceOptions(audit_pages=True))
    o = out["page_occupancy"]
    print(f"[serve_topk] {o['host_swaps']} host-swaps "
          f"({o['tokens_salvaged']} tokens salvaged, {o['swap_restores']} "
          f"restores, re_prefill_tokens={o['re_prefill_tokens']}, "
          f"cold_replans={o['swap_cold_replans']}), "
          f"{o['requeue_preemptions']} requeues, {o['crashes']} crash "
          f"recovered, {o['audits_run']} invariant audits")
    equal = out["outputs"] == base["outputs"]
    print(f"[serve_topk] outputs bitwise equal to fault-free run: {equal}")
    assert equal, "fault recovery changed outputs"
    assert o["host_swaps"] >= 2, "schedule failed to force 2 preemptions"
    assert o["re_prefill_tokens"] == 0 and o["swap_cold_replans"] == 0
    assert o["crashes"] == 1 and o["audits_run"] > 0
    assert all(len(v) == 12 for v in out["outputs"].values())


def _overload_schedule(seed):
    """Seeded load spikes / slow steps, plus a deterministic preempt →
    park → corrupt sequence so the checksum gate provably fires: the
    victim's swap handle sits parked (admission deferred) when the
    corruption lands, and its re-admission must quarantine it."""
    return (FaultPlan.seeded_overload(seed, steps=24, n_corrupt=0)
            .preempt(8).defer_admission(8).defer_admission(9)
            .corrupt_page(9).defer_admission(10))


def overload_demo(cfg, seed, child_args, dev, ckpt_dir=None,
                  kill_at=None):
    """Overload resilience, three pillars asserted end to end:

    1. The QoS ladder turns a load-spike schedule that forces >=2
       preemptions without it into per-slot quality rungs — every
       request completes, zero requeues/timeouts, and requests whose
       slots never degraded are BITWISE equal to the no-fault run.
    2. A byte flipped in a parked swap payload is detected at the
       swap-in checksum gate and quarantined; the victim recovers by
       deterministic re-prefill (outputs unchanged).
    3. A child process killed mid-serve resumes from its checkpoint in
       this process with bitwise-equal outputs."""
    cfg = _with_decode(cfg, replan=4)
    cfg = dataclasses.replace(
        cfg,
        sata=dataclasses.replace(cfg.sata, qos=QosConfig(ladder=True)),
        kv=KVCacheConfig(layout="paged", pool_pages=6))
    opt = ServeOptions(n_requests=4, batch_slots=2, gen_len=12,
                       max_len=32, prompt_len=6)
    faults = _overload_schedule(seed)
    if ckpt_dir is not None:
        # --- child mode: serve into the checkpoint dir until the
        # injected kill, then die (the parent resumes from disk)
        try:
            serve("qwen3-4b", device=dev, cfg=cfg, faults=faults, smoke=True,
                  options=opt,
                  resilience=ResilienceOptions(checkpoint_dir=ckpt_dir,
                                               checkpoint_every=5,
                                               kill_at_step=kill_at))
        except ServeKilled as e:
            print(f"[serve_topk] child: {e}")
            return
        raise AssertionError("child completed — kill step never reached")
    print(f"[serve_topk] overload schedule (seed {seed}):")
    print(faults.describe())
    base = serve("qwen3-4b", device=dev, cfg=cfg, smoke=True,
                 options=opt)                              # no faults
    out = serve("qwen3-4b", device=dev, cfg=cfg, faults=faults, smoke=True,
                options=opt)
    off_cfg = dataclasses.replace(
        cfg, sata=dataclasses.replace(cfg.sata, qos=QosConfig(ladder=False)))
    off = serve("qwen3-4b", device=dev, faults=faults, cfg=off_cfg, smoke=True,
                options=opt)
    o, q = out["page_occupancy"], out["qos"]
    print(f"[serve_topk] ladder OFF: "
          f"{off['page_occupancy']['preemptions']} preemptions; ladder "
          f"ON: {o['preemptions']} ({o['requeue_preemptions']} requeues, "
          f"{len(out['timed_out'])} timeouts), {q['rung_downs']} rung "
          f"downs / {q['rung_ups']} ups over {q['degraded_steps']} "
          f"degraded slot-steps")
    print(f"[serve_topk] degradation timelines: {out['degradation']}")
    # pillar 1 — the ladder absorbs what preemption used to shed
    # (the one remaining ladder-ON preemption is the demo's explicit
    # park-a-handle event, not spike shedding)
    assert off["page_occupancy"]["preemptions"] >= 2, \
        "schedule too soft: ladder-off run must need >= 2 preemptions"
    assert sorted(out["outputs"]) == list(range(opt.n_requests))
    assert o["requeue_preemptions"] == 0 and not out["timed_out"]
    assert all(len(v) == opt.gen_len for v in out["outputs"].values())
    assert any(tl for tl in out["degradation"].values()), \
        "spikes must appear on some request's timeline"
    for r, tl in out["degradation"].items():
        if not tl:
            assert out["outputs"][r] == base["outputs"][r], \
                f"request {r} never degraded but its tokens moved"
    # pillar 2 — the flipped byte is caught BEFORE any page scatters
    print(f"[serve_topk] integrity: {o['corrupt_pages_injected']} "
          f"corruptions injected, {o['corrupt_pages_detected']} detected, "
          f"{o['quarantined_pages']} pages quarantined, "
          f"re_prefill_tokens={o['re_prefill_tokens']}")
    assert o["corrupt_pages_injected"] == 1
    assert o["corrupt_pages_detected"] == 1
    assert o["re_prefill_tokens"] > 0, "victim must recover by re-prefill"
    # pillar 3 — cross-process kill/resume, bitwise
    with tempfile.TemporaryDirectory(prefix="serve_overload_ckpt_") as d:
        cmd = [sys.executable, os.path.abspath(__file__),
               "--overload", str(seed), "--_ckpt-dir", d,
               "--_kill-at", "13"] + child_args
        subprocess.run(cmd, check=True, env=dict(os.environ))
        res = serve("qwen3-4b", device=dev, cfg=cfg, faults=faults, smoke=True,
                    options=opt,
                    resilience=ResilienceOptions(checkpoint_dir=d,
                                                 checkpoint_every=5,
                                                 resume=True))
    equal = res["outputs"] == out["outputs"]
    print(f"[serve_topk] killed child resumed at step "
          f"{res['checkpoint']['resumed_at']}; outputs bitwise equal to "
          f"uninterrupted overload run: {equal}")
    assert equal, "checkpoint/resume changed outputs"
    print("[serve_topk] overload scenario OK")


def retire_demo(cfg, dev):
    """Six 60-token requests (20 prompt + 40 generated) against a
    16-page pool that can hold only two full prefixes: without
    retirement the pool preempts and stalls its way through; with
    ``sata_retire="on"`` each slot frees its coldest attention blocks'
    pages mid-stream (ranked by the plan's decayed importance
    accumulator — zero extra cache reads), and the same workload
    completes without a single preemption.  Prints the per-request
    retirement timelines and the per-KV-head importance split the
    report prices."""
    base = dataclasses.replace(cfg, kv=KVCacheConfig(layout="paged",
                                                     pool_pages=16))
    opt = ServeOptions(n_requests=6, batch_slots=3, gen_len=40,
                       max_len=64, prompt_len=20, shared_prefix_len=12)
    off = serve("qwen3-4b", device=dev, cfg=base, smoke=True, options=opt)
    on_cfg = dataclasses.replace(
        base, sata=dataclasses.replace(
            base.sata, retire=RetireConfig(mode="on", watermark=0.4,
                                           keep=0.5)))
    on = serve("qwen3-4b", device=dev, cfg=on_cfg, smoke=True, options=opt)
    o_off, o_on = off["page_occupancy"], on["page_occupancy"]
    r = on["retirement"]
    print(f"[serve_topk] retire OFF: {o_off['preemptions']} preemptions, "
          f"{o_off['stalled_steps']} stalled steps, "
          f"{o_off['deferred_claims']} deferred claims, "
          f"{off['steps']} loop steps")
    print(f"[serve_topk] retire ON:  {o_on['preemptions']} preemptions, "
          f"{o_on['stalled_steps']} stalled steps, {on['steps']} loop "
          f"steps — {r['pages_reclaimed']} pages reclaimed mid-stream "
          f"over {r['events']} retirement events "
          f"({r['retired_tokens']} tokens, keep budget "
          f"{r['keep_budget']:.2f})")
    for req in sorted(r["timelines"])[:2]:
        print(f"[serve_topk]   request {req} timeline (step, pages): "
              f"{r['timelines'][req]}")
    print(f"[serve_topk] per-KV-head importance mass: "
          f"{[round(x, 1) for x in r['head_importance']]}")
    assert r["pages_reclaimed"] > 0, "retirement never fired"
    assert all(len(v) == opt.gen_len for v in on["outputs"].values())
    assert o_off["preemptions"] + o_off["stalled_steps"] > 0, \
        "pool too large: the off run never felt pressure"
    assert o_on["preemptions"] < o_off["preemptions"], \
        "retirement failed to absorb the preemption pressure"


def replicated_demo(cfg, n_replicas, dev):
    """N serve replicas (each with its own page pool, prefix trie, and
    decode state) around ONE shared prefix index: replica 0 prefills
    the shared system prefix cold and publishes its full pages' digest
    chain; every later replica's lookup hits the index and MIGRATES the
    published pages into its local pool (refcount/CoW semantics intact
    — migration goes through the ordinary claiming slot) instead of
    re-running the shared-prefix prefill.  Prints the cross-replica hit
    rate and the prefill tokens the migrations saved; outputs must be
    bitwise equal across replicas."""
    cfg = dataclasses.replace(
        cfg, kv=KVCacheConfig(layout="paged", prefix_cache=True))
    out = serve_replicated(
        "qwen3-4b", device=dev, n_replicas=n_replicas, smoke=True, cfg=cfg,
        options=ServeOptions(n_requests=6, batch_slots=3, gen_len=8,
                             max_len=64, prompt_len=20,
                             shared_prefix_len=16))
    idx = out["index"]
    print(f"[serve_topk] {out['n_replicas']} replicas / "
          f"{out['requests']} requests: cross-replica hit rate "
          f"{out['cross_replica_hit_rate']:.2f} "
          f"({out['cross_replica_hits']} hits), {out['migrated_pages']} "
          f"pages migrated ({out['migrated_tokens']} tokens), prefill "
          f"tokens saved {out['prefill_tokens_saved']}")
    print(f"[serve_topk] shared index: {idx['pages_published']} pages "
          f"published, {idx['lookups']} lookups, {idx['remote_hits']} "
          f"remote hits; outputs bitwise equal across replicas: "
          f"{out['outputs_equal']}")
    assert out["outputs_equal"], "migration changed replica outputs"
    assert out["cross_replica_hits"] >= n_replicas - 1
    assert out["migrated_pages"] >= 2
    assert out["prefill_tokens_saved"] > 0


def shared_prefix_demo(cfg, dev):
    """Six requests share a 16-token system prefix of their 20-token
    prompts: the prefix cache prefills the shared pages ONCE, every
    later claim maps them (refcount bump, zero copy, prefill only over
    the tail), and the outputs stay bitwise identical to serving with
    the cache disabled."""
    base = dataclasses.replace(cfg, kv=KVCacheConfig(layout="paged"))
    opt = ServeOptions(n_requests=6, batch_slots=3, gen_len=8,
                       max_len=64, prompt_len=20, shared_prefix_len=16)
    off = serve("qwen3-4b", device=dev, cfg=base, smoke=True, options=opt)
    on_cfg = dataclasses.replace(
        base, kv=dataclasses.replace(base.kv, prefix_cache=True))
    on = serve("qwen3-4b", device=dev, cfg=on_cfg, smoke=True, options=opt)
    p = on["prefix_cache"]
    print(f"[serve_topk] shared-prefix: hit-rate {p['hit_rate']:.2f} "
          f"({p['hits']}/{p['requests']}), prefill tokens saved "
          f"{p['prefill_tokens_saved']}/{p['prefill_tokens_total']}, "
          f"{p['cow_copies']} CoW copies, shared-page peak "
          f"{p['shared_pages_peak']}")
    print(f"[serve_topk] outputs bitwise equal to cache-disabled run: "
          f"{on['outputs'] == off['outputs']}")
    assert on["outputs"] == off["outputs"], "prefix cache changed outputs"
    assert p["hit_rate"] > 0 and p["prefill_tokens_saved"] > 0
    assert p["shared_pages_peak"] > 0
    assert all(len(v) == 8 for v in on["outputs"].values())


if __name__ == "__main__":
    main()
