"""Port parity: the incremental decode planner.

Integer plan state (``kv_indices``, ``kv_counts``, ``replans``,
``step``) must match the JAX reference exactly.  Thresholds are held to
1e-6 relative to the tensor's threshold scale: they come from fp32
einsum scores whose summation order differs between XLA and PyTorch, and
every bisection midpoint inherits the ABSOLUTE rounding of the score
range's endpoints, so a threshold near zero differs by an ulp of the
range, not of itself (seen: 7.6e-8 absolute on a 0.017 threshold)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax.numpy as jnp  # noqa: E402

from repro.core import decode_plan as jdp  # noqa: E402
from repro.core.paging import PageAllocator as JAlloc  # noqa: E402
from repro_torch.core import decode_plan as tdp  # noqa: E402

THR_RTOL = 1e-6      # fp32 summation order of the score einsum
B, KV, G, D, BLK, S = 3, 2, 2, 16, 8, 64
NKB = S // BLK
TOPK = 5


def _inputs(seed, pos=(63, 21, 8)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    return q, k, np.asarray(pos, np.int32)


def _paged(k, pos):
    """The same cache laid out through a page table (numpy allocator)."""
    alloc = JAlloc(B * NKB + 1, B, NKB, BLK, audit=False)
    for i in range(B):
        assert alloc.ensure(i, int(pos[i]))
    pool = np.zeros((alloc.n_pages, BLK, KV, D), np.float32)
    for i in range(B):
        for lp in range(int(pos[i]) // BLK + 1):
            pool[alloc.table[i, lp]] = k[i, lp * BLK:(lp + 1) * BLK]
    return pool, alloc.table.copy()


def _check(want, got):
    wi, wc, wt = (np.asarray(a) for a in want)
    gi, gc, gt = (a.numpy() for a in got)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gt, wt, rtol=THR_RTOL,
                               atol=THR_RTOL * float(np.abs(wt).max()))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _plan_pair(k, pos, step, active=(True, True, True)):
    """JAX and port plan states with identical contents."""
    jp = jdp.init_decode_plan(B, KV, S, D, BLK)
    lo, hi = jdp.summaries_from_cache(jnp.asarray(k), jnp.asarray(pos),
                                      k_block=BLK)
    jp = {**jp, "k_min": lo, "k_max": hi,
          "step": jnp.asarray(step, jnp.int32),
          "active": jnp.asarray(active)}
    tp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    return jp, tp


@pytest.mark.parametrize("seed", [0, 1])
def test_full_replan_matches(seed):
    q, k, pos = _inputs(seed)
    want = jdp.full_replan(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                           topk_k=TOPK, k_block=BLK, plan_blocks=NKB)
    got = tdp.full_replan(*_t(q, k, pos), topk_k=TOPK, k_block=BLK,
                          plan_blocks=NKB)
    _check(want, got)


@pytest.mark.parametrize("plan_blocks", [NKB, 3])
def test_incremental_plan_matches(plan_blocks):
    q, k, pos = _inputs(3)
    jp, tp = _plan_pair(k, pos, step=(1, 1, 1))
    if plan_blocks != NKB:
        jp["kv_indices"] = jp["kv_indices"][..., :plan_blocks]
        tp["kv_indices"] = tp["kv_indices"][..., :plan_blocks]
    want = jdp.incremental_plan(jnp.asarray(q), jnp.asarray(k), jp,
                                jnp.asarray(pos), topk_k=TOPK, k_block=BLK)
    got = tdp.incremental_plan(*_t(q, k), tp, torch.from_numpy(pos),
                               topk_k=TOPK, k_block=BLK)
    _check(want, got)


def test_incremental_plan_paged_matches_contiguous():
    q, k, pos = _inputs(4)
    pool, table = _paged(k, pos)
    jp, tp = _plan_pair(k, pos, step=(1, 1, 1))
    want = jdp.incremental_plan(jnp.asarray(q), jnp.asarray(pool), jp,
                                jnp.asarray(pos), topk_k=TOPK, k_block=BLK,
                                page_table=jnp.asarray(table))
    got = tdp.incremental_plan(*_t(q, pool), tp, torch.from_numpy(pos),
                               topk_k=TOPK, k_block=BLK,
                               page_table=torch.from_numpy(table))
    _check(want, got)
    contig = tdp.incremental_plan(*_t(q, k), tp, torch.from_numpy(pos),
                                  topk_k=TOPK, k_block=BLK)
    for a, b in zip(got, contig):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_gather_planned_keys_matches(layout):
    q, k, pos = _inputs(5)
    idx = np.array(jdp.full_replan(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(pos), topk_k=TOPK,
                                   k_block=BLK, plan_blocks=NKB)[0])
    cache, table = (k, None) if layout == "contiguous" else _paged(k, pos)
    wk, wt = jdp.gather_planned_keys(
        jnp.asarray(cache), jnp.asarray(idx), k_block=BLK,
        page_table=None if table is None else jnp.asarray(table))
    gk, gt = tdp.gather_planned_keys(
        torch.from_numpy(cache), torch.from_numpy(idx), k_block=BLK,
        page_table=None if table is None else torch.from_numpy(table))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


@pytest.mark.parametrize("replan,step,layout", [
    (1, (0, 4, 9), "contiguous"),
    (3, (3, 6, 0), "contiguous"),       # every slot triggers: batched full
    (3, (1, 2, 4), "contiguous"),       # none triggers: batched incremental
    (3, (0, 1, 2), "contiguous"),       # mixed: per-slot partial re-plan
    (3, (0, 1, 2), "paged"),
    (1, (0, 4, 9), "paged"),
])
def test_decode_plan_update_matches(replan, step, layout):
    q, k, pos = _inputs(6)
    active = (True, True, False) if step == (0, 1, 2) else (True,) * 3
    jp, tp = _plan_pair(k, pos, step, active)
    cache, table = (k, None) if layout == "contiguous" else _paged(k, pos)
    jtbl = None if table is None else jnp.asarray(table)
    ttbl = None if table is None else torch.from_numpy(table)
    jnew, jthr = jdp.decode_plan_update(
        jp, jnp.asarray(q), jnp.asarray(cache), jnp.asarray(pos),
        topk_k=TOPK, k_block=BLK, replan_interval=replan, page_table=jtbl)
    tnew, tthr = tdp.decode_plan_update(
        tp, *_t(q, cache), torch.from_numpy(pos), topk_k=TOPK, k_block=BLK,
        replan_interval=replan, page_table=ttbl)
    _check((jnew["kv_indices"], jnew["kv_counts"], jthr),
           (tnew["kv_indices"], tnew["kv_counts"], tthr))
    for name in ("step", "replans", "active"):
        np.testing.assert_array_equal(tnew[name].numpy(),
                                      np.asarray(jnew[name]))


def test_plan_from_prefill_matches():
    q, k, pos = _inputs(7, pos=(40, 40, 40))
    want = jdp.plan_from_prefill(jnp.asarray(k), jnp.asarray(q),
                                 jnp.asarray(pos), topk_k=TOPK, k_block=BLK)
    got = tdp.plan_from_prefill(*_t(k, q, pos), topk_k=TOPK, k_block=BLK)
    assert set(got) == set(want)
    for name in got:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


def test_slot_reset_and_release_match():
    q, k, pos = _inputs(8)
    jp, tp = _plan_pair(k, pos, step=(2, 3, 4))
    jp = jdp.release_plan_slot(jdp.reset_plan_slot(jp, 1), 2)
    tdp.release_plan_slot(tdp.reset_plan_slot(tp, 1), 2)
    for name in tp:
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]),
                                      err_msg=name)


@pytest.mark.parametrize("what", ["int8", "sketch", "auto"])
def test_slice3_modes_raise(what):
    """The int8 backend, sketch re-plans and the churn trigger run with
    the slice's later plan state too.  With the retirement state
    (``imp`` / ``live_blk``) each mode's step equals the reference's;
    with the QoS knob vectors the int8 and sketch steps equal it, and
    the churn trigger raises ``AssertionError`` in both packages (the
    knobs own the re-plan beat)."""
    q, k, pos = _inputs(9)
    summary = "int8" if what == "int8" else "fp32"
    kw = {"int8": {"replan_interval": 2},
          "sketch": {"replan_mode": "sketch"},
          "auto": {"churn_budget": 0.25}}[what]
    for extra in ("retire", "qos"):
        jp = jdp.init_decode_plan(B, KV, S, D, BLK, summary=summary,
                                  **{extra: True})
        lo, hi = jdp.summaries_from_cache(jnp.asarray(k), jnp.asarray(pos),
                                          k_block=BLK)
        if what == "int8":
            jp.update(zip(("k_min", "k_max", "k_scale", "k_zero"),
                          jdp.quantize_summaries(lo, hi)))
        else:
            jp.update(k_min=lo, k_max=hi)
        tp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
        args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos))
        if extra == "qos" and what == "auto":
            with pytest.raises(AssertionError, match="beat"):
                jdp.decode_plan_update(jp, *args, topk_k=TOPK, k_block=BLK,
                                       **kw)
            with pytest.raises(AssertionError, match="beat"):
                tdp.decode_plan_update(tp, *_t(q, k, pos), topk_k=TOPK,
                                       k_block=BLK, **kw)
            continue
        jp, jthr = jdp.decode_plan_update(jp, *args, topk_k=TOPK,
                                          k_block=BLK, **kw)
        tp, tthr = tdp.decode_plan_update(tp, *_t(q, k, pos), topk_k=TOPK,
                                          k_block=BLK, **kw)
        _check((jp["kv_indices"], jp["kv_counts"], jthr),
               (tp["kv_indices"], tp["kv_counts"], tthr))
        assert int(tp["replans"].sum()) == B  # step 0: every slot re-plans
        if extra == "retire":
            np.testing.assert_array_equal(tp["imp"].numpy(),
                                          np.asarray(jp["imp"]))
