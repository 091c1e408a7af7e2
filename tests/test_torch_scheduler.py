"""Port parity: the paper's SATA scheduler and estimation plane — Algo 1
(both numpy sorters, the batched torch sorter, query classification and
the GLOB-escape loop), the Algo 2 FSM schedule, tiling with zero-skip,
``plan`` and the Sec. IV CIM simulator — against the JAX package on the
same masks.

The masks are the reference's own: ``repro.core.masks.synthetic_masks``
for each of the four paper workloads at seeds 0-2, plus seeded numpy
masks.  Everything is compared with ``==``, floats included: the port
runs the reference's numpy and Python arithmetic unchanged, so any
difference is a porting fault."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from benchmarks.common import workload_reports  # noqa: E402
from repro.configs.workloads import WORKLOADS as JW  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import sata as jsata  # noqa: E402
from repro.core import scheduling as jsched  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import sorting as jsort  # noqa: E402
from repro.core import tiling as jtile  # noqa: E402
from repro_torch.configs.workloads import WORKLOADS as TW  # noqa: E402
from repro_torch.core import sata as tsata  # noqa: E402
from repro_torch.core import scheduling as tsched  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import sorting as tsort  # noqa: E402
from repro_torch.core import tiling as ttile  # noqa: E402

SEEDS = (0, 1, 2)
NAMES = tuple(JW)
OVERLAPS = ("phase_max", "paper", "max")


def random_masks(seed, n_heads, n, k):
    """Exactly ``k`` keys per row, at random (the reference tests' form)."""
    rng = np.random.default_rng(seed)
    m = np.zeros((n_heads, n, n), dtype=bool)
    for h in range(n_heads):
        for i in range(n):
            m[h, i, rng.choice(n, size=k, replace=False)] = True
    return m


_CACHE = {}


def _cached(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


def case_masks(case):
    """(masks, s_f) of a case: a paper workload at a seed (the
    reference's masks, its S_f) or seeded numpy masks (an empty key
    column forced, tiled at S_f 7)."""
    kind, seed = case
    if kind in JW:
        w = JW[kind]
        return _cached(("masks", case), lambda: jmasks.synthetic_masks(
            seed, w.trace, w.n_heads)), w.s_f
    m = random_masks(seed, 3, 24, 6)
    m[:, :, 5] = False
    return m, 7


def plans(case):
    """The reference's and the port's ``plan`` of a case, computed once."""
    masks, s_f = case_masks(case)
    return _cached(("plan", case), lambda: (jsata.plan(masks, s_f=s_f),
                                            tsata.plan(masks, s_f=s_f)))


def port_reports(case):
    """The port's scheduled, dense and gated ``SimReport``s of a case at
    the workload's d_k (64 for numpy masks), computed once."""
    masks, _ = case_masks(case)
    p = plans(case)[1]
    d_k = TW[case[0]].d_k if case[0] in TW else 64
    hw = tsim.HwConfig()

    def run():
        r = (tsim.simulate_schedule(p.schedule, d_k, hw) if p.tiled is None
             else tsim.simulate_tiled_sata(p.tiled, d_k, hw))
        return (r, tsim.simulate_dense(masks, d_k, hw),
                tsim.simulate_gated(masks, d_k, hw))
    return _cached(("reports", case), run)


CASES = [(n, s) for n in NAMES for s in SEEDS] + [("random", s)
                                                  for s in (0, 1, 2)]
IDS = [f"{n}-seed{s}" for n, s in CASES]


def _eq_result(got, want):
    np.testing.assert_array_equal(got.kid, want.kid)
    np.testing.assert_array_equal(got.qtypes, want.qtypes)
    assert int(got.head_type) == int(want.head_type)
    assert (got.s_h, got.n_decrements) == (want.s_h, want.n_decrements)


def _eq_schedule(got, want):
    assert (got.n_tokens, got.n_heads, got.peak_residency) == \
        (want.n_tokens, want.n_heads, want.peak_residency)
    assert [dataclasses.astuple(s) for s in got.steps] == \
        [dataclasses.astuple(s) for s in want.steps]


def _eq_report(got, want):
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.edp == want.edp


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_algo1_matches_reference_exactly(case):
    """Head by head on the untiled masks: every ``SortResult`` field of
    Algo 1 with the Psum sorter (seed 0) and the direct sorter (seed =
    head), the torch sorter on the CPU, classification at three heavy
    sizes, the escape loop at a small theta, and the locality score."""
    masks, _ = case_masks(case)
    n = masks.shape[-1]
    got_t = tsort.sort_keys(torch.from_numpy(masks)).numpy()
    for h, m in enumerate(masks):
        want = jsort.sort_and_classify(m)
        _eq_result(tsort.sort_and_classify(m), want)
        np.testing.assert_array_equal(got_t[h], want.kid)
        _eq_result(tsort.sort_and_classify(m, seed=h, use_psum=False),
                   jsort.sort_and_classify(m, seed=h, use_psum=False))
        sm = m[:, want.kid]
        for s_h in (0, n // 4, n):
            np.testing.assert_array_equal(tsort.classify_queries(sm, s_h),
                                          jsort.classify_queries(sm, s_h))
        got = tsort.classify_with_escape(sm, n // 8)
        ref = jsort.classify_with_escape(sm, n // 8)
        np.testing.assert_array_equal(got[0], ref[0])
        assert tuple(map(int, got[1:])) == tuple(map(int, ref[1:]))
        assert tsort.locality_score(sm) == jsort.locality_score(sm)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_schedule_matches_reference_exactly(case):
    """``schedule_heads`` (with and without zero-skip): every ``Step``,
    every ``SortResult``, the peak residency, and the port's
    ``coverage_ok`` (the schedules being equal, the reference's holds
    too)."""
    masks, _ = case_masks(case)
    for skip in (False, True):
        got, got_r = tsched.schedule_heads(masks, skip_empty_keys=skip)
        want, want_r = jsched.schedule_heads(masks, skip_empty_keys=skip)
        _eq_schedule(got, want)
        assert got.q_seq == want.q_seq and got.k_seq == want.k_seq
        for a, b in zip(got_r, want_r, strict=True):
            _eq_result(a, b)
        assert tsched.coverage_ok(got, masks) is True


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plan_and_simulator_match_reference_exactly(case):
    """``plan`` (tiled at the case's S_f where it tiles, whole-head for
    TTST): the ``TiledPlan`` and its tiles, ``fold_group_ids``,
    ``SataStats``, the schedule; then every ``SimReport`` field of the
    scheduled run (under each overlap model at seed 0 outside the
    costly kvt_base, the default one elsewhere), of the dense and gated
    baselines, and ``scheduler_cost``."""
    masks, s_f = case_masks(case)
    want, got = plans(case)
    r_t, d_t, g_t = port_reports(case)
    extra = OVERLAPS[1:] if case[1] == 0 and case[0] != "kvt_base" else ()
    assert dataclasses.astuple(got.stats) == dataclasses.astuple(want.stats)
    _eq_schedule(got.schedule, want.schedule)
    for a, b in zip(got.results, want.results, strict=True):
        _eq_result(a, b)
    hw_t, hw_j = tsim.HwConfig(), jsim.HwConfig()
    d_k = JW[case[0]].d_k if case[0] in JW else 64
    if want.tiled is None:
        assert got.tiled is None
        _eq_report(r_t, jsim.simulate_schedule(want.schedule, d_k, hw_j))
        for ov in extra:
            _eq_report(tsim.simulate_schedule(got.schedule, d_k, hw_t,
                                              overlap=ov),
                       jsim.simulate_schedule(want.schedule, d_k, hw_j,
                                              overlap=ov))
    else:
        gt, wt = got.tiled, want.tiled
        assert (gt.s_f, gt.n_tiles_total, gt.n_tiles_skipped,
                gt.n_rows_skipped, gt.n_cols_skipped,
                gt.zero_skip_fraction) == \
            (wt.s_f, wt.n_tiles_total, wt.n_tiles_skipped,
             wt.n_rows_skipped, wt.n_cols_skipped, wt.zero_skip_fraction)
        assert len(gt.tiles) == len(wt.tiles)
        for a, b in zip(gt.tiles, wt.tiles):
            assert (a.head, a.q_fold, a.k_fold) == (b.head, b.q_fold,
                                                    b.k_fold)
            for f in ("q_idx", "k_idx", "mask"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            _eq_result(a.result, b.result)
        # plan's schedule is tiled_schedule's (compared above)
        np.testing.assert_array_equal(ttile.fold_group_ids(gt),
                                      jtile.fold_group_ids(wt))
        _eq_report(r_t, jsim.simulate_tiled_sata(wt, d_k, hw_j))
        for ov in extra:
            _eq_report(tsim.simulate_tiled_sata(gt, d_k, hw_t, overlap=ov),
                       jsim.simulate_tiled_sata(wt, d_k, hw_j, overlap=ov))
    _eq_report(d_t, jsim.simulate_dense(masks, d_k, hw_j))
    _eq_report(g_t, jsim.simulate_gated(masks, d_k, hw_j))
    n = masks.shape[-1]
    assert tsim.scheduler_cost(n, d_k, masks.shape[0], hw_t) == \
        jsim.scheduler_cost(n, d_k, masks.shape[0], hw_j)


def port_workload_reports(name, seeds=SEEDS):
    """``benchmarks/common.py::workload_reports`` on the port, fed the
    reference's masks (the same masks for both packages), without the
    planning time."""
    rows = []
    for seed in seeds:
        p = plans((name, seed))[1]
        r, d, g = port_reports((name, seed))
        rows.append((r.throughput_gain(d), r.energy_eff_gain(d),
                     r.throughput_gain(g), r.energy_eff_gain(g), p.stats))
    thr, en, thr_g, en_g, stats = zip(*rows)
    return {
        "thr": float(np.mean(thr)), "en": float(np.mean(en)),
        "thr_vs_gated": float(np.mean(thr_g)),
        "en_vs_gated": float(np.mean(en_g)),
        "glob_q": float(np.mean([s.glob_q_frac for s in stats])),
        "s_h": float(np.mean([s.avg_s_h_frac for s in stats])),
        "n_dec": float(np.mean([s.avg_n_decrements for s in stats])),
        "glob_head": float(np.mean([s.glob_head_frac for s in stats])),
    }


@pytest.mark.parametrize("name", NAMES)
def test_workload_reports_match_reference_exactly(name):
    """The paper-table numbers of each workload (modeled CIM gains and
    Tab. I statistics, seeds 0-2): equal to the reference bench's, and
    the port's workload table equal to the reference's."""
    want = workload_reports(name)
    got = port_workload_reports(name)
    assert got == {k: want[k] for k in got}
    assert set(want) - set(got) == {"plan_us", "workload"}
    tw, jw = TW[name], JW[name]
    assert dataclasses.asdict(tw) == dataclasses.asdict(jw)


@pytest.mark.parametrize("name", NAMES)
def test_workload_gates_hold_on_the_port(name):
    """The reference tests' gates on its workloads, on the port: SATA
    beats dense in modeled throughput and energy, gated saves energy but
    not time, and the scheduled MACs lie between the selected work and
    dense."""
    w = TW[name]
    for seed in SEEDS:
        masks, _ = case_masks((name, seed))
        r, d, g = port_reports((name, seed))
        assert r.throughput_gain(d) > 1.0 and r.energy_eff_gain(d) > 1.0
        assert g.latency_cycles == d.latency_cycles
        assert g.energy_pj < d.energy_pj
        assert masks.sum() * w.d_k <= r.macs <= d.macs
