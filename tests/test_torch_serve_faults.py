"""Port parity: fault-tolerant paged ``serve()`` — host-swap preemption,
requeue, forced preemption and deferral, the crash restore, the
watchdog, bounded retries, the page-integrity quarantine, load spikes
with the QoS ladder off, sampled audits, the seeded schedule of
``examples/serve_topk.py::faults_demo`` and checkpoint → kill → resume,
each against the JAX reference on the reference's own test
configuration (``tests/test_serve_faults.py``: qwen3-4b smoke, bisect,
8-token decode blocks, re-plan every 4th step, a 6-page pool, 4
requests through 2 slots).

Token streams, ``timed_out``, steps and every integer counter of
``page_occupancy`` and ``decode_fetch`` must EQUAL the reference's, and
each fault run's streams must equal the port's own fault-free run (a
timed-out stream is a prefix of it)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.launch import serve as jsv  # noqa: E402
from repro.launch.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.models.config import KVCacheConfig as JKV  # noqa: E402
from repro.models.config import SataDecodeConfig as JDec  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.launch import serve as tsv  # noqa: E402
from repro_torch.launch.faults import FaultPlan as TFaultPlan  # noqa: E402
from repro_torch.models.config import KVCacheConfig as TKV  # noqa: E402
from repro_torch.models.config import SataDecodeConfig as TDec  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402

KW = dict(n_requests=4, batch_slots=2, gen_len=12, max_len=32, prompt_len=6)
OCC_KEYS = ("preemptions", "host_swaps", "swap_restores",
            "requeue_preemptions", "tokens_salvaged",
            "requeue_tokens_discarded", "re_prefill_tokens",
            "swap_cold_replans", "host_swap_bytes_peak", "crashes",
            "preempt_retries_max", "preempted_requests",
            "protected_admissions", "deferred_claims", "stalled_steps",
            "deferred_retries_skipped", "corrupt_pages_injected",
            "corrupt_pages_detected", "quarantined_pages",
            "trie_nodes_invalidated", "audits_run", "light_audits_run",
            "pages_in_use", "pages_in_use_peak", "shared_pages_peak")
FETCH_KEYS = ("kv_fetch_tiles_plan", "kv_fetch_tiles_dense",
              "plan_fetch_bytes", "replans")


def _cfgs(pool_pages=6, summary="fp32", **kv):
    """(JAX, port) configs of ``tests/test_serve_faults.py::_cfg``."""
    out = []
    for smoke, dcls, kvc in ((JSMOKE, JDec, JKV), (TSMOKE, TDec, TKV)):
        base = smoke["qwen3-4b"]
        out.append(dataclasses.replace(
            base, topk_impl="bisect",
            sata=dataclasses.replace(base.sata, decode=dcls(
                mode="on", block=8, replan=4, summary=summary)),
            kv=kvc(layout="paged", pool_pages=pool_pages, **kv)))
    return out


def _squeeze(fp):
    return fp.pool_squeeze(2, 3).pool_restore(14)


def _retries(fp):
    for s in range(2, 26, 2):
        fp.preempt(s, slot=0)
    return fp


def _faults_demo(fp):
    # examples/serve_topk.py::faults_demo at seed 0
    return (type(fp).seeded(0, steps=24, n_events=3, max_squeeze=2,
                            slots=2)
            .pool_squeeze(2, 3).pool_restore(14).crash_step(20))


# name: (schedule on a FaultPlan, config kwargs, ResilienceOptions kwargs,
#        what the schedule must exercise)
SCHEDULES = {
    "squeeze_swaps": (_squeeze, {}, {}, lambda o: (
        o["host_swaps"] >= 2 and o["swap_restores"] == o["host_swaps"]
        and o["re_prefill_tokens"] == 0 and o["requeue_preemptions"] == 0)),
    "requeue_budget_0": (_squeeze, {}, {"host_swap_bytes": 0}, lambda o: (
        o["host_swaps"] == 0 and o["requeue_preemptions"] > 0
        and o["re_prefill_tokens"] > 0)),
    "preempt_defer": (
        lambda fp: fp.preempt(3).defer_admission(4).preempt(7, slot=1),
        {"pool_pages": 8}, {}, lambda o: o["preemptions"] >= 2),
    "int8_prefix_cache": (_squeeze, {"summary": "int8",
                                     "prefix_cache": True}, {},
                          lambda o: o["preemptions"] > 0),
    "crash": (lambda fp: fp.crash_step(5), {"pool_pages": 8}, {},
              lambda o: (o["crashes"] == 1 and o["swap_restores"] >= 1
                         and o["re_prefill_tokens"] == 0
                         and o["swap_cold_replans"] == 0)),
    "watchdog": (None, {"pool_pages": 8}, {"max_steps_per_request": 5},
                 lambda o: o["pages_in_use"] == 0),
    "bounded_retries": (_retries, {}, {"preempt_retry_limit": 2},
                        lambda o: (o["preempt_retries_max"] >= 2
                                   and o["protected_admissions"] >= 1)),
    "corrupt_quarantine": (
        lambda fp: (fp.preempt(4).defer_admission(4).defer_admission(5)
                    .corrupt_page(5).defer_admission(6)),
        {"prefix_cache": True}, {}, lambda o: (
            o["corrupt_pages_injected"] == o["corrupt_pages_detected"] == 1
            and o["quarantined_pages"] > 0 and o["swap_restores"] == 0
            and o["re_prefill_tokens"] > 0)),
    "load_spike_ladder_off": (
        lambda fp: fp.load_spike(4, 2).slow_step(5), {}, {},
        lambda o: o["preemptions"] >= 2),
    "light_audit": (None, {}, {"audit_pages": "light"},
                    lambda o: o["light_audits_run"] > 0
                    and o["audits_run"] > 0),
    "faults_demo_seed0": (_faults_demo, {}, {}, lambda o: (
        o["host_swaps"] >= 2 and o["crashes"] == 1
        and o["re_prefill_tokens"] == 0 and o["swap_cold_replans"] == 0)),
}


@pytest.fixture(scope="module")
def weights():
    jc, tc = _cfgs()
    params = jmdl.init_params(jax.random.PRNGKey(0), jc)
    return params, params_from_jax(jax.tree.map(np.asarray, params), tc,
                                   device="cpu")


@pytest.fixture(scope="module")
def fault_free(weights):
    """The port's fault-free run per config, memoized."""
    _, model = weights
    done = {}

    def get(cfg_kw):
        key = tuple(sorted(cfg_kw.items()))
        if key not in done:
            _, tc = _cfgs(**cfg_kw)
            done[key] = tsv.serve("qwen3-4b", cfg=tc, model=model,
                                  options=tsv.ServeOptions(**KW),
                                  device="cpu")
        return done[key]
    return get


def _serve(weights, pkg, schedule, cfg_kw=None, **res_kw):
    """One package's ``serve()`` of ``KW`` under ``schedule``."""
    params, model = weights
    jc, tc = _cfgs(**(cfg_kw or {}))
    if pkg == "jax":
        return jsv.serve(
            "qwen3-4b", cfg=jc, params=params, options=jsv.ServeOptions(**KW),
            faults=schedule(JFaultPlan()) if schedule else None,
            resilience=jsv.ResilienceOptions(**res_kw))
    return tsv.serve(
        "qwen3-4b", cfg=tc, model=model, options=tsv.ServeOptions(**KW),
        faults=schedule(TFaultPlan()) if schedule else None,
        resilience=tsv.ResilienceOptions(**res_kw), device="cpu")


def _check(want, got):
    assert got["outputs"] == want["outputs"]
    assert got["timed_out"] == want["timed_out"]
    assert got["steps"] == want["steps"]
    assert got["tokens_generated"] == want["tokens_generated"]
    for k in OCC_KEYS:
        assert got["page_occupancy"][k] == want["page_occupancy"][k], k
    for k in FETCH_KEYS:
        assert got["decode_fetch"][k] == want["decode_fetch"][k], k


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_fault_serve_matches_reference(weights, fault_free, name):
    schedule, cfg_kw, res_kw, exercised = SCHEDULES[name]
    want = _serve(weights, "jax", schedule, cfg_kw, **res_kw)
    got = _serve(weights, "torch", schedule, cfg_kw, **res_kw)
    _check(want, got)
    assert exercised(got["page_occupancy"]), got["page_occupancy"]
    base = fault_free(cfg_kw)["outputs"]
    for r, toks in got["outputs"].items():
        if r in got["timed_out"]:
            assert toks == base[r][:len(toks)], r
        else:
            assert toks == base[r], r
    if name == "watchdog":
        assert got["timed_out"] == list(range(KW["n_requests"]))
        assert all(len(v) == 6 for v in got["outputs"].values())
    else:
        assert all(len(v) == KW["gen_len"] for v in got["outputs"].values())


def test_checkpoint_kill_resume_matches_reference(weights, fault_free,
                                                  tmp_path):
    """Kill the loop at step 7 after a save at step 5, then resume from
    disk: both packages resume at step 5 and serve the streams of the
    uninterrupted run, with equal counters (allocator, trie, swap
    handles, queue and counters all ride the checkpoint)."""
    faults = (lambda fp: fp.preempt(4).defer_admission(4)
              .defer_admission(5))
    runs = {}
    for pkg in ("jax", "torch"):
        d = str(tmp_path / pkg)
        with pytest.raises((jsv if pkg == "jax" else tsv).ServeKilled):
            _serve(weights, pkg, faults, checkpoint_dir=d,
                   checkpoint_every=5, kill_at_step=7)
        runs[pkg] = _serve(weights, pkg, faults, checkpoint_dir=d,
                           checkpoint_every=5, resume=True)
    want, got = runs["jax"], runs["torch"]
    assert got["checkpoint"]["resumed_at"] == \
        want["checkpoint"]["resumed_at"] == 5
    _check(want, got)
    assert got["outputs"] == fault_free({})["outputs"]
    assert got["page_occupancy"]["host_swaps"] >= 1


def test_faults_require_paged_layout():
    """Both packages refuse a fault plan on the contiguous layout with a
    ``ValueError`` naming the paged layout."""
    jc, tc = _cfgs()
    jc = dataclasses.replace(jc, kv=JKV(layout="contiguous"))
    tc = dataclasses.replace(tc, kv=TKV(layout="contiguous"))
    with pytest.raises(ValueError, match="paged"):
        jsv.serve("qwen3-4b", cfg=jc, options=jsv.ServeOptions(**KW),
                  faults=JFaultPlan().pool_squeeze(1, 2))
    with pytest.raises(ValueError, match="paged"):
        tsv.serve("qwen3-4b", cfg=tc, options=tsv.ServeOptions(**KW),
                  faults=TFaultPlan().pool_squeeze(1, 2), device="cpu")
