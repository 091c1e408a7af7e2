"""Port parity: ``serve()`` under overload — the QoS degradation ladder
and cascade retirement, each against the JAX reference on the
reference bench's workloads (``benchmarks/bench_decode.py``
``_bench_degradation`` and ``_bench_retirement``) and the reference
tests' (``tests/test_serve_overload.py``, ``tests/test_retirement.py``),
with the reference's seed-0 weights loaded into the port.

Token streams, steps, the degradation timelines, ``qos``, the integer
fields of ``retirement`` and every field of ``page_occupancy`` and
``decode_fetch`` (the swap wall clock aside) must be EQUAL.
``retirement["head_importance"]`` is held to HEAD_IMP_RTOL: it sums the
decayed fp32 accumulator ``imp ← decay·imp + planned`` over layers,
slots and blocks, and the jitted reference fuses that update into an
FMA where the port rounds the product first (about 1e-7 relative
seen)."""
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
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.launch import serve as tsv  # noqa: E402
from repro_torch.launch.faults import FaultPlan as TFaultPlan  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402

HEAD_IMP_RTOL = 1e-5

LADDER_KW = dict(n_requests=4, batch_slots=2, gen_len=12, max_len=32,
                 prompt_len=6)
RETIRE_KW = dict(n_requests=6, batch_slots=3, gen_len=40, max_len=64,
                 prompt_len=20, shared_prefix_len=12)
SWAP_KW = dict(n_requests=4, batch_slots=2, gen_len=24, max_len=64,
               prompt_len=20)


def _spikes(fp):
    return fp.load_spike(4, 2).slow_step(5).load_spike(10, 1)


def _cfgs(replan=4, pool=6, ladder=False, retire=None):
    """(JAX, port) configs: qwen3-4b smoke, bisect, 8-token decode
    blocks, paged."""
    out = []
    for smoke in (JSMOKE, TSMOKE):
        base = smoke["qwen3-4b"]
        sata = base.sata
        out.append(dataclasses.replace(
            base, topk_impl="bisect",
            sata=dataclasses.replace(
                sata,
                decode=dataclasses.replace(sata.decode, mode="on", block=8,
                                           replan=replan),
                qos=dataclasses.replace(sata.qos, ladder=ladder),
                retire=dataclasses.replace(sata.retire, **(retire or {}))),
            kv=dataclasses.replace(base.kv, layout="paged",
                                   pool_pages=pool)))
    return out


def _retire(pool, keep=0.5, watermark=0.4):
    return _cfgs(replan=1, pool=pool, retire=dict(
        mode="on", keep=keep, watermark=watermark))


@pytest.fixture(scope="module")
def weights():
    jc, tc = _cfgs()
    params = jmdl.init_params(jax.random.PRNGKey(0), jc)
    return params, params_from_jax(jax.tree.map(np.asarray, params), tc,
                                   device="cpu")


def _serve(weights, pkg, cfgs, kw, schedule=None, **res):
    params, model = weights
    jc, tc = cfgs
    if pkg == "jax":
        return jsv.serve(
            "qwen3-4b", cfg=jc, params=params, options=jsv.ServeOptions(**kw),
            faults=schedule(JFaultPlan()) if schedule else None,
            resilience=jsv.ResilienceOptions(**res))
    return tsv.serve(
        "qwen3-4b", cfg=tc, model=model, options=tsv.ServeOptions(**kw),
        faults=schedule(TFaultPlan()) if schedule else None,
        resilience=tsv.ResilienceOptions(**res), device="cpu")


def _check(want, got):
    """The port's report equals the reference's."""
    for k in ("outputs", "steps", "tokens_generated", "timed_out",
              "degradation", "qos"):
        assert got.get(k) == want.get(k), k
    if "retirement" in want:
        w, g = dict(want["retirement"]), dict(got["retirement"])
        np.testing.assert_allclose(g.pop("head_importance"),
                                   w.pop("head_importance"),
                                   rtol=HEAD_IMP_RTOL)
        assert g == w
    else:
        assert "retirement" not in got
    for k, v in want["page_occupancy"].items():
        if k != "swap_restore_wall_s":
            assert got["page_occupancy"][k] == v, k
    assert got["decode_fetch"] == want["decode_fetch"]


@pytest.fixture(scope="module")
def pair(weights):
    """Both packages' run of a named workload, memoized."""
    workloads = {
        "ladder_base": (_cfgs(ladder=True), LADDER_KW, None),
        "ladder_spikes": (_cfgs(ladder=True), LADDER_KW, _spikes),
        "ladder_off_spikes": (_cfgs(), LADDER_KW, _spikes),
        "retire_pressure": (_retire(16), RETIRE_KW, None),
        "retire_pressure_off": (_cfgs(replan=1, pool=16), RETIRE_KW, None),
        "retire_off": (_cfgs(replan=1, pool=0), RETIRE_KW, None),
        "retire_keep75": (_retire(0, keep=0.75), RETIRE_KW, None),
        "retire_keep50": (_retire(0, keep=0.5), RETIRE_KW, None),
        "retire_keep25": (_retire(0, keep=0.25), RETIRE_KW, None),
        "retire_never": (_retire(0, watermark=2.0), RETIRE_KW, None),
        "retire_swap": (_retire(0), SWAP_KW,
                        lambda fp: fp.preempt(10).preempt(14)),
    }
    done = {}

    def get(name):
        if name not in done:
            cfgs, kw, schedule = workloads[name]
            done[name] = tuple(_serve(weights, pkg, cfgs, kw, schedule)
                               for pkg in ("jax", "torch"))
        return done[name]
    return get


# ---------------------------------------------------------------------------
# The ladder
# ---------------------------------------------------------------------------

def test_ladder_absorbs_spikes(pair):
    """The bench's spike schedule with the ladder on: equal reports, every
    request complete with no preemption, requeue or timeout, rungs down
    and up, and every request the ladder never degraded equal to the
    no-fault ladder run's — in the port as in the reference."""
    want, got = pair("ladder_spikes")
    _check(want, got)
    _check(*pair("ladder_base"))
    base = pair("ladder_base")[1]
    o = got["page_occupancy"]
    assert o["preemptions"] == o["requeue_preemptions"] == 0
    assert not got["timed_out"]
    assert all(len(v) == LADDER_KW["gen_len"]
               for v in got["outputs"].values())
    q = got["qos"]
    assert q["rung_downs"] > 0 and q["rung_ups"] > 0
    assert q["load_spikes"] == 2 and q["slow_steps"] == 1
    clean = [r for r, tl in got["degradation"].items() if not tl]
    assert clean and any(got["degradation"].values())
    for r in clean:
        assert got["outputs"][r] == base["outputs"][r], r


def test_ladder_off_sheds_by_preemption(pair):
    """The same spikes without the ladder: equal reports, load shed by
    host swap (no requeue), and the spike / slow-step counters kept."""
    want, got = pair("ladder_off_spikes")
    _check(want, got)
    o = got["page_occupancy"]
    assert o["preemptions"] >= 2 and o["host_swaps"] == o["preemptions"]
    assert o["requeue_preemptions"] == 0
    assert "qos" not in got
    assert not any(got["degradation"].values())


# ---------------------------------------------------------------------------
# Retirement
# ---------------------------------------------------------------------------

def test_retirement_pressure_lane(pair):
    """A 16-page pool: retirement reclaims pages mid-stream and the
    report equals the reference's; retire-off on the same pool equals
    the reference's too."""
    want, got = pair("retire_pressure")
    _check(want, got)
    _check(*pair("retire_pressure_off"))
    r = got["retirement"]
    assert r["pages_reclaimed"] > 0 and r["events"] > 0
    first = min(t[0][0] for t in r["timelines"].values() if t)
    assert 0 < first < got["steps"]
    assert got["page_occupancy"]["pages_retired"] == r["pages_reclaimed"]
    assert all(len(v) == RETIRE_KW["gen_len"]
               for v in got["outputs"].values())


@pytest.mark.parametrize("keep", [75, 50, 25])
def test_retirement_accuracy_lane(pair, keep):
    """An ample pool, so every difference is retirement's: each budget's
    report equals the reference's, it reclaimed pages, and its token
    divergence from retire-off equals the reference's."""
    want, got = pair(f"retire_keep{keep}")
    _check(want, got)
    off_j, off_t = pair("retire_off")
    _check(off_j, off_t)
    assert got["retirement"]["pages_reclaimed"] > 0

    def diverge(on, off):
        return sum(1 for r, toks in off["outputs"].items()
                   for j, t in enumerate(toks) if on["outputs"][r][j] != t)
    assert diverge(got, off_t) == diverge(want, off_j)


def test_retirement_never_fired_equals_off(pair):
    """A watermark no slot reaches on an ample pool: retirement on serves
    retire-off's streams bitwise, reclaiming nothing."""
    want, got = pair("retire_never")
    _check(want, got)
    assert got["retirement"]["pages_reclaimed"] == 0
    assert got["outputs"] == pair("retire_off")[1]["outputs"]


def test_retirement_through_host_swap(pair):
    """Forced preemptions swap slots holding holes: the holes and the
    dead plan blocks ride the swap, and the report equals the
    reference's."""
    want, got = pair("retire_swap")
    _check(want, got)
    assert got["page_occupancy"]["host_swaps"] > 0
    assert got["retirement"]["pages_reclaimed"] > 0
    assert all(len(v) == SWAP_KW["gen_len"] for v in got["outputs"].values())


# ---------------------------------------------------------------------------
# Checkpoint / resume with both on
# ---------------------------------------------------------------------------

def test_checkpoint_kill_resume_ladder_retire(weights, tmp_path):
    """The ladder and retirement on, a spike, a preemption and a
    deferral: both packages killed after a save at step 5 and resumed
    from disk give equal reports, and the port's resumed run equals its
    uninterrupted one (rungs, timelines, holes and counters all ride
    the checkpoint)."""
    cfgs = _cfgs(pool=6, ladder=True, retire=dict(mode="on", keep=0.5,
                                                  watermark=0.4))

    def faults(fp):
        return (fp.load_spike(3, 2).preempt(4).defer_admission(4)
                .defer_admission(5))

    runs = {}
    for pkg in ("jax", "torch"):
        d = str(tmp_path / pkg)
        with pytest.raises((jsv if pkg == "jax" else tsv).ServeKilled):
            _serve(weights, pkg, cfgs, LADDER_KW, faults, checkpoint_dir=d,
                   checkpoint_every=5, kill_at_step=7)
        runs[pkg] = _serve(weights, pkg, cfgs, LADDER_KW, faults,
                           checkpoint_dir=d, checkpoint_every=5, resume=True)
    want, got = runs["jax"], runs["torch"]
    assert got["checkpoint"]["resumed_at"] == \
        want["checkpoint"]["resumed_at"] == 5
    _check(want, got)
    whole = _serve(weights, "torch", cfgs, LADDER_KW, faults)
    for k in ("outputs", "degradation", "qos", "retirement"):
        assert got[k] == whole[k], k
    assert got["qos"]["rung_downs"] > 0
    assert got["retirement"]["pages_reclaimed"] > 0
