"""Port parity: the block-summary backends, the sketch re-plan and the
churn-adaptive trigger — int8 quantization and its containment of the
fp32 bounds, incremental int8 maintenance over the serving lifecycle,
``sketch_replan`` and its degeneracy to ``full_replan``, the mixed-step
partial re-plan, the churn trigger, the backend- and mode-aware fetch
accounting, and the model's decode route — each against the JAX
reference on the same numpy inputs (``serve()`` with int8 summaries,
sketch re-plans and the churn trigger is in
``test_torch_prefix_cache.py``, with the prefix cache on).

Tolerances: on equal fp32 inputs the int8 codes, scales and zeros are
exact, and so are ``kv_indices``/``kv_counts``/``step``/``replans``;
thresholds 1e-6 relative (queue C1: fp32 summation order of the score
einsum); logits 1e-4 (as ``test_torch_serve.py``); greedy token streams
equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.core import decode_plan as jdp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.models.config import SataDecodeConfig as JDec  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.core import decode_plan as tdp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models.config import SataDecodeConfig as TDec  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402

THR_RTOL = 1e-6      # fp32 summation order of the score einsum
LOGIT_ATOL = 1e-4    # fp32 summation order over 4 layers
INT8 = ("k_min", "k_max", "k_scale", "k_zero")


def _keys(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _grow(summary, keys, s, blk, resets=()):
    """Drive both packages' backends through the serving append
    lifecycle (``tests/test_summary_backend.py::_grow``): keys
    (B, T, KV, D) appended at per-slot positions 0, 1, ... of a length-s
    cache; ``resets`` maps step → slot to re-claim.  Returns
    (jplan, tplan, cache, last positions)."""
    b, t_total, kv, d = keys.shape
    jplan = jdp.init_decode_plan(b, kv, s, d, blk, summary=summary)
    tplan = tdp.init_decode_plan(b, kv, s, d, blk, summary=summary,
                                 device="cpu")
    cache = np.zeros((b, s, kv, d), np.float32)
    pos = np.zeros(b, np.int32)
    resets = dict(resets)
    for t in range(t_total):
        if t in resets:
            slot = resets[t]
            cache[slot] = 0.0
            jplan = jdp.reset_plan_slot(jplan, slot)
            tdp.reset_plan_slot(tplan, slot)
            pos[slot] = 0
        k_new = keys[:, t:t + 1]
        cache[np.arange(b), pos] = k_new[:, 0]
        # eager, as the reference's own test drives it: under jit XLA
        # fuses the dequantize into an FMA and the codes move (queue C4)
        jplan = jdp.update_block_summaries(jplan, jnp.asarray(k_new),
                                           jnp.asarray(pos), k_block=blk)
        tdp.update_block_summaries(tplan, torch.from_numpy(k_new),
                                   torch.from_numpy(pos), k_block=blk)
        last = pos.copy()
        pos = pos + 1
    return jplan, tplan, cache, last


_GROWN = {}


def _grown(summary, seed, shape, s, blk, resets=()):
    """``_grow`` over ``_keys(seed, shape)``, run once per argument set;
    each call gets fresh plan dicts (the port's planners update theirs
    in place)."""
    key = (summary, seed, shape, s, blk, tuple(sorted(dict(resets).items())))
    if key not in _GROWN:
        jp, tp, cache, pos = _grow(summary, _keys(seed, shape), s, blk,
                                   resets)
        _GROWN[key] = ({k: np.asarray(v) for k, v in jp.items()},
                       {k: v.numpy().copy() for k, v in tp.items()},
                       cache, pos)
    jp, tp, cache, pos = _GROWN[key]
    return ({k: jnp.asarray(v) for k, v in jp.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tp.items()},
            cache, pos)


_REFS = {}


def _reference(key, fn):
    """The reference's result for ``key``, computed once: the layout
    cases of a test compare against the same contiguous reference."""
    if key not in _REFS:
        _REFS[key] = fn()
    return _REFS[key]


def _same_plan(tplan, jplan, names=None):
    for name in names or tplan:
        np.testing.assert_array_equal(tplan[name].numpy(),
                                      np.asarray(jplan[name]), err_msg=name)


def _check(got, want):
    """Plans equal; thresholds within 1e-6 relative, or — a row whose
    bisection took one other branch because a score sat on a bf16
    rounding boundary (queue C3) — equal after the bf16 rounding every
    consumer applies, so the admitted keys are the same."""
    gi, gc, gt = (a.numpy() for a in got)
    wi, wc, wt = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gc, wc)
    close = np.abs(gt - wt) <= THR_RTOL * (np.abs(wt) + np.abs(wt).max())
    same_bf16 = (torch.from_numpy(gt).to(torch.bfloat16)
                 == torch.tensor(wt).to(torch.bfloat16)).numpy()
    assert (close | same_bf16).all(), (gt[~close], wt[~close])


def _contains(tplan, lo_ref, hi_ref):
    lo8, hi8 = tdp.plan_summary_bounds(tplan)
    assert bool((lo8 <= lo_ref).all()), "int8 k_min must be <= fp32 k_min"
    assert bool((hi8 >= hi_ref).all()), "int8 k_max must be >= fp32 k_max"


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# int8 backend: codes equal to the reference's, containment of fp32
# ---------------------------------------------------------------------------

def _lifecycle_keys(case):
    """(keys, cache length, block, resets) of the reference's int8
    maintenance tests, plus seeded property-style draws."""
    if case == "midstream_reset":
        return _keys(0, (2, 24, 2, 8), 3.0), 32, 8, {13: 1}
    if case == "magnitudes":
        rng = np.random.default_rng(7)
        mags = 10.0 ** rng.uniform(-3, 3, size=(1, 32, 1, 1))
        return ((rng.standard_normal((1, 32, 2, 4)) * mags)
                .astype(np.float32), 32, 8, {})
    if case.startswith("constant"):
        base, jitter = {"constant": (3.7, 0.0), "constant_far": (1.0e4, 1e-3),
                        "constant_neg": (-512.0, 1e-5)}[case]
        k = np.full((1, 8, 2, 4), base, np.float32)
        return (k + jitter * _keys(1, k.shape)).astype(np.float32), 8, 8, {}
    seed = int(case.split("_")[1])                    # "seeded_<n>"
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 29))
    reset_at = int(rng.integers(-1, n))
    keys = (rng.standard_normal((2, n, 2, 4))
            * 10.0 ** rng.uniform(-2, 2)).astype(np.float32)
    return keys, 32, 8, ({reset_at: 1} if reset_at >= 0 else {})


@pytest.mark.parametrize("case", [
    "midstream_reset", "magnitudes", "constant", "constant_far",
    "constant_neg", "seeded_0", "seeded_1", "seeded_2", "seeded_3"])
def test_int8_maintenance_matches_and_contains_fp32(case):
    """Incremental int8 maintenance over appends and a re-claim: codes,
    scales and zeros equal the reference's bit for bit, and the
    dequantized bounds contain the exact fp32 bounds of the cache."""
    keys, s, blk, resets = _lifecycle_keys(case)
    jplan, tplan, cache, pos = _grow("int8", keys, s, blk, resets)
    _same_plan(tplan, jplan, INT8)
    lo, hi = tdp.summaries_from_cache(*_t(cache, pos), k_block=blk)
    _contains(tplan, lo, hi)
    if case == "midstream_reset":              # fp32 stays exact
        jf, tf, cache_f, pos_f = _grow("fp32", keys, s, blk, resets)
        _same_plan(tf, jf, ("k_min", "k_max"))
        lo_f, _ = tdp.summaries_from_cache(*_t(cache_f, pos_f), k_block=blk)
        torch.testing.assert_close(tf["k_min"], lo_f, rtol=0, atol=0)


def test_int8_codes_under_the_references_jit():
    """Queue C4: jitted, the reference fuses the dequantize
    ``zero + q·scale`` into an FMA, so its serving path's codes move off
    its eager codes (which the port's equal) in some blocks.  Both stay
    conservative: containment is the contract, not the codes."""
    b, t_total, kv, d, s, blk = 2, 20, 2, 8, 32, 8
    keys = _keys(4, (b, t_total, kv, d))
    upd = jax.jit(lambda pl, kn, ps: jdp.update_block_summaries(
        pl, kn, ps, k_block=blk))
    jit_plan = jdp.init_decode_plan(b, kv, s, d, blk, summary="int8")
    for t in range(t_total):
        jit_plan = upd(jit_plan, jnp.asarray(keys[:, t:t + 1]),
                       jnp.full((b,), t, jnp.int32))
    _, tplan, cache, pos = _grown("int8", 4, keys.shape, s, blk)
    moved = sum(int((np.asarray(jit_plan[n]) != tplan[n].numpy()).sum())
                for n in INT8)
    assert moved > 0
    lo, hi = tdp.summaries_from_cache(*_t(cache, pos), k_block=blk)
    _contains(tplan, lo, hi)
    _contains({n: torch.tensor(np.asarray(v)) for n, v in jit_plan.items()},
              lo, hi)


def test_quantize_dequantize_roundtrip_matches():
    """One-shot quantization (the handoff / page-summary path): equal
    codes, equal dequantized bounds, containment, and the empty-block
    sentinel round trip."""
    rng = np.random.default_rng(3)
    lo = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    hi = (lo + rng.uniform(0, 2, lo.shape)).astype(np.float32)
    want = jdp.quantize_summaries(jnp.asarray(lo), jnp.asarray(hi))
    got = tdp.quantize_summaries(*_t(lo, hi))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dlo, dhi = tdp.dequantize_summaries(*got)
    jlo, jhi = jdp.dequantize_summaries(*want)
    np.testing.assert_array_equal(dlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(dhi.numpy(), np.asarray(jhi))
    assert bool((dlo.numpy() <= lo).all()) and bool((dhi.numpy() >= hi).all())
    e_lo = torch.full((1, 1, 8), float("inf"))
    q_lo, q_hi, sc, zp = tdp.quantize_summaries(e_lo, -e_lo)
    assert float(sc[0, 0]) == -1.0
    dlo, dhi = tdp.dequantize_summaries(q_lo, q_hi, sc, zp)
    assert bool(torch.isposinf(dlo).all()) and bool(torch.isneginf(dhi).all())


@pytest.mark.parametrize("summary", ["fp32", "int8"])
def test_reset_and_init_match(summary):
    jplan, tplan, _, _ = _grow(summary, _keys(6, (2, 10, 2, 4)), 16, 8)
    jplan = jdp.release_plan_slot(jdp.reset_plan_slot(jplan, 0), 1)
    tdp.release_plan_slot(tdp.reset_plan_slot(tplan, 0), 1)
    _same_plan(tplan, jplan)
    ref = tdp.init_decode_plan(2, 2, 16, 4, 8, summary=summary, device="cpu")
    for name in ref:
        if name not in ("replans", "active"):
            torch.testing.assert_close(tplan[name][0], ref[name][0],
                                       msg=name)


# ---------------------------------------------------------------------------
# Re-plans over int8 / fp32 summaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("summary", ["fp32", "int8"])
def test_replan1_equals_full_replan(summary):
    """At ``replan_interval=1`` the exact re-plan never reads the
    summaries: both backends' plans are ``full_replan``'s, as the
    reference's."""
    b, kv, s, d, blk = 2, 2, 32, 8, 8
    jplan, tplan, cache, pos = _grown(summary, 4, (b, 20, kv, d), s, blk)
    q = _keys(5, (b, kv, 2, d))
    jnew, jthr = jdp.decode_plan_update(jplan, *map(jnp.asarray, (q, cache,
                                                                  pos)),
                                        topk_k=8, k_block=blk,
                                        replan_interval=1)
    tnew, tthr = tdp.decode_plan_update(tplan, *_t(q, cache, pos), topk_k=8,
                                        k_block=blk, replan_interval=1)
    _check((tnew["kv_indices"], tnew["kv_counts"], tthr),
           (jnew["kv_indices"], jnew["kv_counts"], jthr))
    want = tdp.full_replan(*_t(q, cache, pos), topk_k=8, k_block=blk,
                           plan_blocks=s // blk)
    for g, w in zip((tnew["kv_indices"], tnew["kv_counts"], tthr), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _paged(cache, blk):
    """The contiguous cache scattered into a pool + table (page 0 kept
    as the overflow page)."""
    b, s, kv, d = cache.shape
    nkb = s // blk
    pool = np.zeros((b * nkb + 1, blk, kv, d), cache.dtype)
    table = np.zeros((b, nkb), np.int32)
    for i in range(b):
        for lp in range(nkb):
            table[i, lp] = 1 + i * nkb + lp
            pool[table[i, lp]] = cache[i, lp * blk:(lp + 1) * blk]
    return pool, table


PLANNERS = {  # name: (summary, plan width P or None, planner, kwargs)
    "incremental_int8": ("int8", None, "incremental_plan", {}),
    "incremental_int8_P3": ("int8", 3, "incremental_plan", {}),
    "sketch_int8_F2": ("int8", None, "sketch_replan", {"sketch_factor": 2}),
    "sketch_int8_P3_F4": ("int8", 3, "sketch_replan", {"sketch_factor": 4}),
    "sketch_fp32_P3_F2": ("fp32", 3, "sketch_replan", {"sketch_factor": 2}),
}


@pytest.mark.parametrize("name", sorted(PLANNERS))
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_planners_match_reference(name, layout):
    """``incremental_plan`` and ``sketch_replan`` over int8 / fp32
    summaries, wide and narrow plans, contiguous and paged: the port's
    plan equals the reference's, and the paged plan equals the
    contiguous one (summaries absorb keys, not addresses).  A narrow
    sketch keeps counts within P and names no block past a slot's
    valid prefix, a re-claimed shorter slot included."""
    summary, p, fn, kw = PLANNERS[name]
    b, kv, s, d, blk = 2, 2, 128, 8, 16
    jplan, tplan, cache, pos = _grown(summary, 12, (b, 100, kv, d), s, blk,
                                      {60: 1})
    if p is not None:
        jplan = {**jplan, "kv_indices": jplan["kv_indices"][..., :p]}
        tplan["kv_indices"] = tplan["kv_indices"][..., :p].contiguous()
    q = _keys(13, (b, kv, 2, d))
    kw = dict(kw, topk_k=8, k_block=blk)
    want = _reference(("planner", name), lambda: getattr(jdp, fn)(
        jnp.asarray(q), jnp.asarray(cache), jplan, jnp.asarray(pos), **kw))
    got = getattr(tdp, fn)(*_t(q, cache), tplan, torch.from_numpy(pos),
                           **kw)
    if layout == "paged":
        pool, tbl = _paged(cache, blk)
        paged = getattr(tdp, fn)(*_t(q, pool), tplan, torch.from_numpy(pos),
                                 page_table=torch.from_numpy(tbl), **kw)
        for g, w in zip(paged, got):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        got = paged
    _check(got, want)
    si, sc_, st_ = got
    pw = si.shape[-1]
    assert bool((sc_ <= pw).all()) and bool((sc_ >= 1).all())
    nvalid = torch.from_numpy(pos // blk + 1)
    live = torch.arange(pw)[None, None, :] < sc_[..., None]
    assert bool((si < nvalid[:, None, None])[live].all())
    assert bool(torch.isfinite(st_).all())


@pytest.mark.parametrize("summary", ["fp32", "int8"])
def test_sketch_equals_full_when_candidates_cover_all_blocks(summary):
    """With P = nkb, ``C·F >= nkb``: every valid block is a candidate and
    the port's sketch re-plan equals its ``full_replan`` bitwise (and
    the reference's sketch re-plan)."""
    b, kv, s, d, blk = 2, 2, 64, 8, 16
    jplan, tplan, cache, pos = _grown(summary, 10, (b, 50, kv, d), s, blk)
    q = _keys(11, (b, kv, 2, d))
    full = tdp.full_replan(*_t(q, cache, pos), topk_k=8, k_block=blk,
                           plan_blocks=s // blk)
    sk = tdp.sketch_replan(*_t(q, cache), tplan, torch.from_numpy(pos),
                           topk_k=8, k_block=blk, sketch_factor=2)
    for g, w in zip(sk, full):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    _check(sk, jdp.sketch_replan(jnp.asarray(q), jnp.asarray(cache), jplan,
                                 jnp.asarray(pos), topk_k=8, k_block=blk,
                                 sketch_factor=2))


@pytest.mark.parametrize("args", [(32, 8, 4), (32, 32, 4), (30, 8, 4),
                                  (8, 3, 16), (64, 64, 4), (64, 7, 3)])
def test_sketch_geometry_matches(args):
    assert tdp.sketch_geometry(*args) == jdp.sketch_geometry(*args)


# ---------------------------------------------------------------------------
# decode_plan_update: interval, churn trigger, sketch mode, mixed steps
# ---------------------------------------------------------------------------

UPDATES = {  # name: (summary, step, churn, update kwargs)
    "mixed_interval2_fp32": ("fp32", (0, 1, 2), (0., 0., 0.),
                             dict(replan_interval=2)),
    "mixed_interval2_int8_sketch": ("int8", (0, 1, 2), (0., 0., 0.),
                                    dict(replan_interval=2,
                                         replan_mode="sketch",
                                         sketch_factor=2)),
    "churn_mixed": ("fp32", (0, 3, 5), (0., 2.5, 0.5),
                    dict(churn_budget=0.25)),
    "churn_none_fire": ("int8", (2, 3, 5), (0., 0.5, 0.25),
                        dict(churn_budget=0.25)),
    "churn_all_fire_sketch": ("int8", (0, 0, 0), (0., 0., 0.),
                              dict(churn_budget=0.25, replan_mode="sketch",
                                   sketch_factor=4)),
}


@pytest.mark.parametrize("name", sorted(UPDATES))
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_plan_update_matches(name, layout):
    """One plan-maintenance step per trigger: a fixed interval mixing
    triggered and untriggered slots (the partial re-plan), the churn
    budget firing for some, none or all slots, and sketch re-plans —
    the whole updated state (plan rows, ``step``, ``churn``,
    ``replans``) equals the reference's, thresholds within 1e-6."""
    summary, step, churn, kw = UPDATES[name]
    b, kv, s, d, blk, p = 3, 2, 64, 8, 16, 2
    jplan, tplan, cache, pos = _grown(summary, 14, (b, 40, kv, d), s, blk)
    q = _keys(15, (b, kv, 2, d))
    prev = tdp.full_replan(*_t(_keys(16, (b, kv, 2, d)), cache, pos),
                           topk_k=8, k_block=blk, plan_blocks=p)
    extra = {"step": np.asarray(step, np.int32),
             "churn": np.asarray(churn, np.float32),
             "kv_indices": prev[0].numpy(), "kv_counts": prev[1].numpy()}
    jplan = {**jplan, **{k: jnp.asarray(v) for k, v in extra.items()}}
    for k, v in extra.items():
        tplan[k] = torch.from_numpy(v.copy())
    kw = dict(kw, topk_k=8, k_block=blk)
    jnew, jthr = _reference(("update", name), lambda: jdp.decode_plan_update(
        jplan, jnp.asarray(q), jnp.asarray(cache), jnp.asarray(pos), **kw))
    kc, tkw = cache, kw
    if layout == "paged":
        kc, tbl = _paged(cache, blk)
        tkw = dict(kw, page_table=torch.from_numpy(tbl))
    tnew, tthr = tdp.decode_plan_update(tplan, *_t(q, kc),
                                        torch.from_numpy(pos), **tkw)
    _check((tnew["kv_indices"], tnew["kv_counts"], tthr),
           (jnew["kv_indices"], jnew["kv_counts"], jthr))
    _same_plan(tnew, jnew, ("step", "replans", "active") + INT8[:2])
    np.testing.assert_allclose(tnew["churn"].numpy(),
                               np.asarray(jnew["churn"]), rtol=0, atol=0)


def test_threshold_flip_is_score_rounding():
    """Queue C3: on ``UPDATES["churn_none_fire"]``'s inputs at most one
    incremental threshold row differs from the reference's, by at most
    one bisection step (1.4e-4 relative; on an AVX-512 AMD EPYC host
    2.4e-6, an endpoint's rounding), while the plans agree.  The cause
    is the score einsum's summation order alone: the scores differ by a
    few ulp, the port's bisection run on the reference's scores returns
    the reference's threshold bit for bit and the reference's run on the
    port's scores the port's, and both thresholds admit the same
    keys."""
    from repro_torch.core.blockmap import bisect_select
    from repro_torch.core.selection import NEG_INF, kth_largest_bisect
    b, kv, s, d, blk, p = 3, 2, 64, 8, 16, 2
    jplan, tplan, cache, pos = _grown("int8", 14, (b, 40, kv, d), s, blk)
    q = _keys(15, (b, kv, 2, d))
    prev = tdp.full_replan(*_t(_keys(16, (b, kv, 2, d)), cache, pos),
                           topk_k=8, k_block=blk, plan_blocks=p)
    jplan = {**jplan, "kv_indices": jnp.asarray(prev[0].numpy())}
    tplan["kv_indices"] = prev[0].clone()
    wi, wc, wt = jdp.incremental_plan(jnp.asarray(q), jnp.asarray(cache),
                                      jplan, jnp.asarray(pos), topk_k=8,
                                      k_block=blk)
    gi, gc, gt = tdp.incremental_plan(*_t(q, cache), tplan,
                                      torch.from_numpy(pos), topk_k=8,
                                      k_block=blk)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    gap = np.abs(gt.numpy() - np.asarray(wt))
    flip = gap > THR_RTOL * np.abs(wt)
    assert flip.sum() <= 1
    rel = float((gap / np.abs(wt)).max())
    assert rel < 2e-4, rel               # at most one step of a 16-step bisection
    sm = 1.0 / np.sqrt(d)
    kg, tok = tdp.gather_planned_keys(torch.from_numpy(cache), gi,
                                      k_block=blk)
    t_sc = torch.einsum("bkgd,bktd->bkgt", torch.from_numpy(q), kg) * sm
    jkg, _ = jdp.gather_planned_keys(jnp.asarray(cache), wi, k_block=blk)
    j_sc = torch.tensor(np.asarray(jnp.einsum(
        "bkgd,bktd->bkgt", jnp.asarray(q), jkg,
        preferred_element_type=jnp.float32) * sm))
    assert float((t_sc - j_sc).abs().max()) <= 8 * 2.0 ** -24 * float(
        j_sc.abs().max())
    slot = torch.arange(p * blk) // blk
    live = ((slot[None, None, :] < gc[..., None])
            & (tok <= torch.from_numpy(pos)[:, None, None]))[:, :, None, :]
    thr_on_ref = kth_largest_bisect(torch.where(live, j_sc, NEG_INF), 8)
    np.testing.assert_array_equal(thr_on_ref.numpy(), np.asarray(wt))
    # and the other way: the reference's bisection on the port's scores
    # returns the port's threshold bit for bit
    from repro.core.selection import kth_largest_bisect as jkth
    thr_on_port = jkth(jnp.where(jnp.asarray(live.numpy()),
                                 jnp.asarray(t_sc.numpy()), NEG_INF), 8)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(thr_on_port))
    masked = torch.where(live, t_sc, float("-inf"))
    assert torch.equal(bisect_select(masked, gt),
                       bisect_select(masked, torch.tensor(np.asarray(wt))))


def test_plan_churn_matches():
    rng = np.random.default_rng(2)
    b, kv, p, nkb = 3, 2, 4, 8
    idx = [np.sort(rng.choice(nkb, (b, kv, p)), -1).astype(np.int32)
           for _ in range(2)]
    cnt = [rng.integers(0, p + 1, (b, kv)).astype(np.int32) for _ in range(2)]
    jp = {"k_min": jnp.zeros((b, kv, nkb, 1)), "kv_indices":
          jnp.asarray(idx[0]), "kv_counts": jnp.asarray(cnt[0])}
    tp = {"k_min": torch.zeros((b, kv, nkb, 1)), "kv_indices":
          torch.from_numpy(idx[0]), "kv_counts": torch.from_numpy(cnt[0])}
    want = jdp.plan_churn(jp, jnp.asarray(idx[1]), jnp.asarray(cnt[1]))
    got = tdp.plan_churn(tp, *_t(idx[1], cnt[1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unported_plan_state_raises():
    """The QoS knob vectors and retirement are ported: a plan carrying
    them steps, the churn trigger beside the knobs raises the
    reference's ``AssertionError``, and ``decode_fetch_stats`` prices
    ``quant`` / ``live_blocks`` exactly as the reference does."""
    q, k, pos = _t(np.zeros((1, 1, 1, 4), np.float32),
                   np.zeros((1, 16, 1, 4), np.float32),
                   np.zeros(1, np.int32))
    for extra in ("qos", "retire"):
        tp = tdp.init_decode_plan(1, 1, 16, 4, 8, device="cpu",
                                  **{extra: True})
        tdp.decode_plan_update(tp, q, k, pos, topk_k=2, k_block=8)
        assert tp["kv_counts"].tolist() == [[1]]
    with pytest.raises(AssertionError, match="beat"):
        tdp.decode_plan_update(
            tdp.init_decode_plan(1, 1, 16, 4, 8, device="cpu", qos=True),
            q, k, pos, topk_k=2, k_block=8, churn_budget=0.25)
    for kw in ({"quant": [True]}, {"live_blocks": [1]}):
        args = (np.ones((1, 1)), [3])
        fkw = dict(k_block=8, d=4, replan=1.0, nkb=2, **kw)
        assert tops.decode_fetch_stats(*args, **fkw) == \
            jops.decode_fetch_stats(*args, **fkw)


# ---------------------------------------------------------------------------
# Fetch accounting per backend and mode
# ---------------------------------------------------------------------------

FETCH = [  # (counts, pos, kwargs) — the reference tests' pins and more
    (np.full((2, 2), 8), np.full(2, 4095), dict(k_block=128, d=64, nkb=32,
                                                replan=1.0)),
    (np.full((2, 2), 8), np.full(2, 4095),
     dict(k_block=128, d=64, nkb=32, replan=1.0, summary="int8",
          replan_mode="sketch", plan_blocks=8)),
    (np.full((2, 2), 8), np.full(2, 4095),
     dict(k_block=128, d=64, nkb=32, replan=0.0, summary="int8")),
    (np.array([[2, 3], [1, 1]]), np.array([63, 63]),
     dict(k_block=16, d=8, nkb=4, replan=np.array([1.0, 0.0]))),
    (np.array([[[2, 3], [1, 1]]] * 3), np.array([63, 20]),
     dict(k_block=16, d=8, nkb=4, replan=np.array([0.5, 0.25]),
          summary="int8", replan_mode="sketch", sketch_factor=2,
          dtype_bytes=2)),
    (np.array([[2, 3], [1, 1]]), np.array([63, 9]),
     dict(k_block=16, d=8, nkb=4, replan=0.5, replan_mode="sketch",
          sketch_factor=4)),
]


@pytest.mark.parametrize("case", range(len(FETCH)))
def test_decode_fetch_stats_matches(case):
    cnt, pos, kw = FETCH[case]
    want = jops.decode_fetch_stats(cnt, pos, **kw)
    got = tops.decode_fetch_stats(cnt, pos, **kw)
    assert got == want
    if case == 1:                  # int8 + sketch cuts plan bytes >= 3x
        fp = tops.decode_fetch_stats(*FETCH[0][:2], **FETCH[0][2])
        assert got["plan_fetch_bytes_step"] == \
            tdp.summary_bytes(32, 64, "int8") * 4 + 4 * 8 * 128 * 64 * 4
        assert fp["plan_fetch_bytes_step"] / got["plan_fetch_bytes_step"] \
            >= 3.0


# ---------------------------------------------------------------------------
# Model routes and the prefill handoff
# ---------------------------------------------------------------------------

def _cfgs(**dec):
    out = []
    for smoke, dcls in ((JSMOKE, JDec), (TSMOKE, TDec)):
        base = smoke["qwen3-4b"]
        out.append(dataclasses.replace(
            base, topk_impl="bisect",
            sata=dataclasses.replace(base.sata, decode=dcls(**dec))))
    return out


@pytest.fixture(scope="module")
def weights():
    jc, tc = _cfgs(mode="on")
    params = jmdl.init_params(jax.random.PRNGKey(0), jc)
    return params, params_from_jax(jax.tree.map(np.asarray, params), tc,
                                   device="cpu")


ROUTES = {  # name: decode config (besides mode="on", block=8)
    "int8_replan1": dict(replan=1, summary="int8"),
    "int8_sketch_replan3": dict(blocks=2, replan=3, summary="int8",
                                replan_mode="sketch", sketch_factor=2),
    "int8_sketch_auto": dict(blocks=2, replan="auto", summary="int8",
                             replan_mode="sketch", sketch_factor=2),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_greedy_decode_route_matches(weights, name):
    """Token-by-token ``serve_step`` through int8 summaries, sketch
    re-plans and the churn trigger: logits within 1e-4 of the
    reference's at every step and identical plan integer state (int8 at
    ``replan=1`` is the dense top-k route, as the reference pins)."""
    params, model = weights
    jc, tc = _cfgs(mode="on", block=8, **ROUTES[name])
    toks = np.random.default_rng(1).integers(0, jc.vocab_size,
                                             (2, 7)).astype(np.int32)
    jcache = jdec.init_cache(jc, batch=2, max_len=16)
    tcache = tdec.init_cache(tc, 2, 16, device="cpu")
    jstep = jax.jit(lambda c, t, p: jdec.serve_step(params, jc, c, t, p))
    for t in range(toks.shape[1]):
        jlg, jcache = jstep(jcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.int32(t))
        tlg, _ = tdec.serve_step(model, tc, tcache,
                                 torch.from_numpy(toks[:, t:t + 1]),
                                 torch.tensor(t, dtype=torch.int32))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg),
                                   atol=LOGIT_ATOL, rtol=0, err_msg=f"t={t}")
    tplan, jplan = tcache["kv"]["plan"], jcache["kv"]["plan"]
    assert tplan["k_min"].dtype == torch.int8 and "k_scale" in tplan
    _same_plan(tplan, jplan, ("kv_indices", "kv_counts", "step", "replans"))
    assert int(tplan["kv_counts"].max()) <= tplan["kv_indices"].shape[-1]
    assert int(tplan["step"][0, 0]) == toks.shape[1]


def test_prefill_handoff_seeds_int8_summaries():
    """``plan_from_prefill(summary="int8")`` on both packages: equal
    codes and plan rows; conservative against the port's fp32 seed,
    whose plan rows it shares."""
    b, kv, s, d, blk = 2, 2, 32, 8, 8
    keys, q = _keys(16, (b, s, kv, d)), _keys(17, (b, kv, 2, d))
    pos = np.asarray([20, 11], np.int32)
    want = jdp.plan_from_prefill(*map(jnp.asarray, (keys, q, pos)),
                                 topk_k=8, k_block=blk, summary="int8")
    got = tdp.plan_from_prefill(*_t(keys, q, pos), topk_k=8, k_block=blk,
                                summary="int8")
    assert set(got) == set(want)
    _same_plan(got, want)
    sf = tdp.plan_from_prefill(*_t(keys, q, pos), topk_k=8, k_block=blk)
    for name in ("kv_indices", "kv_counts", "step"):
        torch.testing.assert_close(got[name], sf[name], msg=name)
    _contains(got, sf["k_min"], sf["k_max"])
