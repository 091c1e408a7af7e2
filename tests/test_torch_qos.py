"""Port parity: the QoS degradation ladder's pieces below ``serve()`` —
the rung knob table and ``QoSController`` (own copies), the degraded
planners (``degraded_summary_bounds``, ``clamp_plan_budget``, the
``budget`` / ``quant`` arguments of ``full_replan`` /
``incremental_plan`` / ``sketch_replan``), ``decode_plan_update`` with
mixed rungs, ``set_qos_knobs`` and the rung pricing of
``decode_fetch_stats``, each against the JAX reference on the same
numpy inputs.

Controller state, integer plan fields and fetch counters must be
EQUAL.  Thresholds are held to 1e-6 relative to the tensor's threshold
scale, as in ``test_torch_decode_plan.py`` (fp32 score summation order
differs between XLA and PyTorch, and every bisection midpoint inherits
the absolute rounding of the score range's endpoints).  The reference
runs eagerly, as its own tests do."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.core import decode_plan as jdp  # noqa: E402
from repro.core.paging import PageAllocator as JAlloc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.serve import QoSController as JQoS  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.core import decode_plan as tdp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.serve import QoSController as TQoS  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402

THR_RTOL = 1e-6      # fp32 summation order of the score products
B, KV, G, D, BLK, S = 3, 2, 2, 16, 8, 64
NKB = S // BLK
TOPK = 5
BUDGET = (NKB, 4, 2)                 # rungs 0, 1 and a narrower cap
QUANT = (False, True, True)


def _inputs(seed, pos=(63, 37, 20)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    return q, k, np.asarray(pos, np.int32)


def _paged(k, pos):
    """The same cache laid out through a page table."""
    alloc = JAlloc(B * NKB + 1, B, NKB, BLK, audit=False)
    for i in range(B):
        assert alloc.ensure(i, int(pos[i]))
    pool = np.zeros((alloc.n_pages, BLK, KV, D), np.float32)
    for i in range(B):
        for lp in range(int(pos[i]) // BLK + 1):
            pool[alloc.table[i, lp]] = k[i, lp * BLK:(lp + 1) * BLK]
    return pool, alloc.table.copy()


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _check(want, got):
    wi, wc, wt = (np.asarray(a) for a in want)
    gi, gc, gt = (a.numpy() for a in got)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gt, wt, rtol=THR_RTOL,
                               atol=THR_RTOL * float(np.abs(wt).max()))


def _plans(k, pos, summary="fp32", qos=False, step=(1, 1, 1)):
    """JAX and port plan states with identical contents: summaries of
    the cache, the given beat phases."""
    jp = jdp.init_decode_plan(B, KV, S, D, BLK, summary=summary, qos=qos)
    lo, hi = jdp.summaries_from_cache(jnp.asarray(k), jnp.asarray(pos),
                                      k_block=BLK)
    if summary == "int8":
        jp.update(zip(("k_min", "k_max", "k_scale", "k_zero"),
                      jdp.quantize_summaries(lo, hi)))
    else:
        jp.update(k_min=lo, k_max=hi)
    jp["step"] = jnp.asarray(step, jnp.int32)
    tp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    return jp, tp


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------

def test_rung_knob_table():
    """The documented rung → knob mapping, equal in both copies."""
    expect = {0: (8, 2, False, False), 1: (4, 2, False, False),
              2: (4, 8, False, False), 3: (4, 8, True, False),
              4: (4, 8, True, True)}
    for cls in (JQoS, TQoS):
        q = cls(1, p0=8, iv0=2, clear_steps=4)
        for rung, knobs in expect.items():
            q.rung[0] = rung
            assert q.knobs(0) == knobs, (cls, rung)
    t, j = TQoS(3, p0=1, iv0=1), JQoS(3, p0=1, iv0=1)
    t.rung, j.rung = [0, 2, 4], [0, 2, 4]
    for a, b in zip(t.vectors(), j.vectors()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def _drive(seed, n_slots, clear_steps, horizon=60):
    """The same seeded press / tick / reset schedule through both
    controllers, compared after every call."""
    rng = np.random.default_rng(seed)
    t = TQoS(n_slots, p0=8, iv0=2, clear_steps=clear_steps)
    j = JQoS(n_slots, p0=8, iv0=2, clear_steps=clear_steps)
    for _ in range(horizon):
        active = [i for i in range(n_slots) if rng.random() < 0.8]
        op = rng.integers(0, 4)
        if op == 0:
            sev = int(rng.integers(1, 4))
            assert t.press(active, sev) == j.press(active, sev)
        elif op == 1 and n_slots:
            i = int(rng.integers(0, n_slots))
            assert t.reset(i) == j.reset(i)
        else:
            pressure = bool(rng.random() < 0.2)
            assert t.tick(active, pressure) == j.tick(active, pressure)
        assert (t.rung, t.clear, t.rung_downs, t.rung_ups) == \
            (j.rung, j.clear, j.rung_downs, j.rung_ups)
    return t


@pytest.mark.parametrize("seed,n_slots,clear_steps",
                         [(0, 1, 1), (1, 2, 4), (2, 4, 2), (3, 8, 4),
                          (4, 3, 6), (5, 8, 1)])
def test_controller_matches_reference(seed, n_slots, clear_steps):
    t = _drive(seed, n_slots, clear_steps)
    assert t.rung_downs > 0


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=50, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 8), st.integers(1, 6))
def test_controller_matches_reference_property(seed, n_slots, clear_steps):
    _drive(seed, n_slots, clear_steps)


# ---------------------------------------------------------------------------
# Degraded planners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("summary", ["fp32", "int8"])
def test_degraded_summary_bounds(summary):
    """Flagged slots rank from the int8 round trip of their fp32 bounds
    (equal codes to the eager reference), unflagged slots pass through
    bitwise; an int8 backend is left as it is."""
    q, k, pos = _inputs(3)
    jp, tp = _plans(k, pos, summary)
    for quant in (None, QUANT):
        want = jdp.degraded_summary_bounds(
            jp, None if quant is None else jnp.asarray(quant))
        got = tdp.degraded_summary_bounds(
            tp, None if quant is None else torch.tensor(quant))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    lo, _ = tdp.degraded_summary_bounds(tp, torch.tensor(QUANT))
    if summary == "fp32":
        np.testing.assert_array_equal(lo[0].numpy(), tp["k_min"][0].numpy())
        assert not torch.equal(lo[1], tp["k_min"][1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clamp_plan_budget(seed):
    rng = np.random.default_rng(seed)
    occ = rng.random((B, KV, NKB)) < 0.6
    score = rng.standard_normal((B, KV, NKB)).astype(np.float32)
    budget = np.asarray(BUDGET, np.int32)
    want = jdp.clamp_plan_budget(jnp.asarray(occ), jnp.asarray(score),
                                 jnp.asarray(budget))
    got = tdp.clamp_plan_budget(*_t(occ, score, budget))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.sum(-1) <= torch.from_numpy(budget)[:, None]).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_full_replan_budget(seed):
    q, k, pos = _inputs(seed)
    budget = np.asarray(BUDGET, np.int32)
    want = jdp.full_replan(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                           topk_k=TOPK, k_block=BLK, plan_blocks=NKB,
                           budget=jnp.asarray(budget))
    got = tdp.full_replan(*_t(q, k, pos), topk_k=TOPK, k_block=BLK,
                          plan_blocks=NKB, budget=torch.from_numpy(budget))
    _check(want, got)
    assert (got[1] <= torch.from_numpy(budget)[:, None]).all()


@pytest.mark.parametrize("summary", ["fp32", "int8"])
@pytest.mark.parametrize("paged", [False, True])
def test_incremental_plan_budget_quant(summary, paged):
    q, k, pos = _inputs(4)
    jp, tp = _plans(k, pos, summary)
    kc, tbl = _paged(k, pos) if paged else (k, None)
    budget, quant = np.asarray(BUDGET, np.int32), np.asarray(QUANT)
    want = jdp.incremental_plan(
        jnp.asarray(q), jnp.asarray(kc), jp, jnp.asarray(pos), topk_k=TOPK,
        k_block=BLK, page_table=None if tbl is None else jnp.asarray(tbl),
        budget=jnp.asarray(budget), quant=jnp.asarray(quant))
    got = tdp.incremental_plan(
        *_t(q, kc), tp, torch.from_numpy(pos), topk_k=TOPK, k_block=BLK,
        page_table=None if tbl is None else torch.from_numpy(tbl),
        budget=torch.from_numpy(budget), quant=torch.from_numpy(quant))
    _check(want, got)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("factor", [2, 4])
def test_sketch_replan_budget_quant(paged, factor):
    q, k, pos = _inputs(5)
    jp, tp = _plans(k, pos)
    kc, tbl = _paged(k, pos) if paged else (k, None)
    budget, quant = np.asarray(BUDGET, np.int32), np.asarray(QUANT)
    want = jdp.sketch_replan(
        jnp.asarray(q), jnp.asarray(kc), jp, jnp.asarray(pos), topk_k=TOPK,
        k_block=BLK, sketch_factor=factor,
        page_table=None if tbl is None else jnp.asarray(tbl),
        budget=jnp.asarray(budget), quant=jnp.asarray(quant))
    got = tdp.sketch_replan(
        *_t(q, kc), tp, torch.from_numpy(pos), topk_k=TOPK, k_block=BLK,
        sketch_factor=factor,
        page_table=None if tbl is None else torch.from_numpy(tbl),
        budget=torch.from_numpy(budget), quant=torch.from_numpy(quant))
    _check(want, got)


# ---------------------------------------------------------------------------
# The per-slot step under mixed rungs
# ---------------------------------------------------------------------------

# per-slot (budget, interval, quant, sketch): rungs 0, 2 and 4
KNOBS = ((NKB, 1, False, False), (4, 4, False, False), (4, 4, True, True))


def _qos_step_pair(paged, knobs, n_steps=5, seed=6):
    """Both packages' ``decode_plan_update`` over ``n_steps`` steps of a
    QoS plan whose slots sit at ``knobs``; the keys grow by one token a
    slot a step.  Returns the per-step (indices, counts, thresholds) and
    the final states."""
    q_all = np.random.default_rng(seed).standard_normal(
        (n_steps, B, KV, G, D)).astype(np.float32)
    _, k, pos0 = _inputs(seed, pos=(40, 25, 12))
    jp, tp = _plans(k, pos0, qos=True, step=(0, 0, 0))
    vecs = [np.asarray(v) for v in zip(*knobs)]
    for name, v in zip(("budget", "interval", "quant", "sketch"), vecs):
        jp[name] = jnp.asarray(v.astype(np.asarray(jp[name]).dtype))
        tp[name] = torch.from_numpy(v.astype(tp[name].numpy().dtype))
    outs = []
    for t in range(n_steps):
        pos = pos0 + t
        kc, tbl = _paged(k, pos) if paged else (k, None)
        jp = jdp.update_block_summaries(
            jp, jnp.asarray(k)[np.arange(B), pos][:, None], jnp.asarray(pos),
            k_block=BLK)
        tdp.update_block_summaries(
            tp, torch.from_numpy(k[np.arange(B), pos][:, None]),
            torch.from_numpy(pos), k_block=BLK)
        jp, jthr = jdp.decode_plan_update(
            jp, jnp.asarray(q_all[t]), jnp.asarray(kc), jnp.asarray(pos),
            topk_k=TOPK, k_block=BLK,
            page_table=None if tbl is None else jnp.asarray(tbl))
        tp, tthr = tdp.decode_plan_update(
            tp, *_t(q_all[t], kc), torch.from_numpy(pos), topk_k=TOPK,
            k_block=BLK,
            page_table=None if tbl is None else torch.from_numpy(tbl))
        outs.append(((jp["kv_indices"], jp["kv_counts"], jthr),
                     (tp["kv_indices"].clone(), tp["kv_counts"].clone(),
                      tthr)))
    return outs, jp, tp


@pytest.mark.parametrize("paged", [False, True])
def test_decode_plan_update_mixed_rungs(paged):
    """Each slot re-plans on its own interval under its own budget /
    quant / sketch knobs: every step's plan equals the reference's, as
    do the beat and re-plan counters, and a budget-capped slot never
    plans more blocks than its budget."""
    outs, jp, tp = _qos_step_pair(paged, KNOBS)
    for want, got in outs:
        _check(want, got)
        assert int(got[1][1].max()) <= 4 and int(got[1][2].max()) <= 4
    for name in ("step", "replans"):
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))
    assert tp["replans"].tolist() == [5, 2, 2]


def test_undegraded_slot_ignores_neighbours_rungs():
    """Slot 0 at rung 0 plans bitwise alike whether its neighbours sit
    at rung 0 or at rungs 2 and 4 — each slot plans at batch 1."""
    deg, _, _ = _qos_step_pair(True, KNOBS)
    full, _, _ = _qos_step_pair(True, (KNOBS[0],) * 3)
    for (_, a), (_, b) in zip(deg, full):
        for x, y in zip(a, b):
            assert torch.equal(x[0], y[0])


def test_set_qos_knobs():
    """The knob vectors land in every layer's plan, in both packages."""
    jc, tc = JSMOKE["qwen3-4b"], TSMOKE["qwen3-4b"]
    import dataclasses
    tc = dataclasses.replace(tc, sata=dataclasses.replace(
        tc.sata, decode=dataclasses.replace(tc.sata.decode, mode="on",
                                            block=8, replan=2),
        qos=dataclasses.replace(tc.sata.qos, ladder=True)))
    jc = dataclasses.replace(jc, sata=dataclasses.replace(
        jc.sata, decode=dataclasses.replace(jc.sata.decode, mode="on",
                                            block=8, replan=2),
        qos=dataclasses.replace(jc.sata.qos, ladder=True)))
    jcache = jdec.init_cache(jc, 3, 64)
    tcache = tdec.init_cache(tc, 3, 64, device="cpu")
    for name in ("budget", "interval", "quant", "sketch"):
        np.testing.assert_array_equal(tcache["kv"]["plan"][name].numpy(),
                                      np.asarray(jcache["kv"]["plan"][name]))
    vecs = (np.asarray([8, 4, 4]), np.asarray([2, 2, 8]),
            np.asarray([False, False, True]), np.asarray([False, True, True]))
    jcache = jdec.set_qos_knobs(jcache, *vecs)
    tdec.set_qos_knobs(tcache, *vecs)
    for name in ("budget", "interval", "quant", "sketch"):
        got = tcache["kv"]["plan"][name]
        assert got.shape[0] == tc.n_layers
        assert got.dtype == {"budget": torch.int32, "interval": torch.int32,
                             "quant": torch.bool, "sketch": torch.bool}[name]
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jcache["kv"]["plan"][name]))


# ---------------------------------------------------------------------------
# Rung pricing
# ---------------------------------------------------------------------------

FETCH = [  # (counts, pos, kwargs)
    (np.asarray([[2, 2], [3, 1], [1, 1]]), np.asarray([31, 47, 60]),
     dict(k_block=8, d=16, nkb=8, replan=np.asarray([1.0, 0.0, 1.0]),
          plan_blocks=np.asarray([8, 4, 4]),
          quant=np.asarray([False, True, True]),
          sketch=np.asarray([False, False, True]))),
    (np.full((3, 2, 2), 5), np.asarray([500, 900]),
     dict(k_block=64, d=128, nkb=64, replan=0.5, dtype_bytes=2,
          summary="int8", replan_mode="sketch",
          plan_blocks=np.asarray([8, 4]),
          quant=np.asarray([True, False]))),
    (np.full((2, 2), 8), np.full(2, 4095),
     dict(k_block=128, d=64, nkb=32, replan=np.asarray([0.25, 1.0]),
          plan_blocks=8, quant=np.asarray([True, True]),
          sketch=np.asarray([True, False]))),
]


@pytest.mark.parametrize("case", range(len(FETCH)))
def test_fetch_stats_rung_vectors(case):
    cnt, pos, kw = FETCH[case]
    want = jops.decode_fetch_stats(cnt, pos, **kw)
    got = tops.decode_fetch_stats(cnt, pos, **kw)
    assert got == want
    plain = {k: v for k, v in kw.items()
             if k not in ("quant", "sketch", "plan_blocks")}
    assert tops.decode_fetch_stats(cnt, pos, **plain) == \
        jops.decode_fetch_stats(cnt, pos, **plain)
