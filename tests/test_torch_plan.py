"""Port parity: the SATA planner of the prefill kernels — key sort, query
order, block maps, compact schedules, chunked selection and the fetch
accounting — against the JAX reference on the same numpy inputs.

Integer outputs (orders, maps, indices, counts, stats) must be equal.
Thresholds are held as in slice 1's C1 entry: within 1e-6 of the
tensor's threshold scale (both sides bisect the same fp32 score range;
the scores differ only in fp32 summation order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import blockmap as jbm  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.core import sorting as jsort  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import blockmap as tbm  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.core import sorting as tsort  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

THR_RTOL = 1e-6      # C1: thresholds relative to the tensor's scale


def _topk_masks(seed, bh, n, k, rank=3, causal=False):
    """Locality-structured top-k masks: low-rank scores + noise, the
    regime the SATA sort concentrates."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((bh, n, rank))
    b = rng.standard_normal((bh, n, rank))
    s = np.einsum("hqr,hkr->hqk", a, b) + 0.3 * rng.standard_normal(
        (bh, n, n))
    if causal:
        s = np.where(np.tril(np.ones((n, n), bool))[None], s, -np.inf)
    kth = -np.sort(-s, axis=-1)[..., k - 1:k]
    m = s >= kth
    if causal:
        m &= np.tril(np.ones((n, n), bool))[None]
    return m


def _qk(seed, bh, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, s, d)).astype(np.float32),
            rng.standard_normal((bh, s, d)).astype(np.float32))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("seed,n,k", [(0, 32, 4), (1, 64, 8), (2, 48, 48)])
def test_sort_keys_matches_reference_exactly(seed, n, k):
    m = _topk_masks(seed, 3, n, k)
    for start in (0, 5):
        want = jsort.sort_keys_jax(jnp.asarray(m), seed=start)
        got = tsort.sort_keys(torch.from_numpy(m), seed=start)
        assert got.dtype == torch.int32
        _eq(got, want)


def test_sort_keys_agrees_with_the_papers_psum_form():
    """The batched sorter equals Algo 1's hardware (Psum) form per head."""
    m = _topk_masks(3, 2, 40, 6)
    got = tsort.sort_keys(torch.from_numpy(m)).numpy()
    for h in range(2):
        _eq(got[h], jsort.sort_keys_psum(m[h]))


@pytest.mark.parametrize("use_sata", [True, False])
@pytest.mark.parametrize("causal", [False, True])
def test_block_plans_match_reference_exactly(use_sata, causal):
    m = _topk_masks(4, 4, 64, 8, causal=causal)
    jf = jbm.sata_block_plan if use_sata else jbm.identity_block_plan
    tf = tbm.sata_block_plan if use_sata else tbm.identity_block_plan
    want = jf(jnp.asarray(m), 16, 16)
    got = tf(torch.from_numpy(m), 16, 16)
    for g, w in zip(got, want):
        _eq(g, w)
    srt = np.take_along_axis(m, np.asarray(want[0])[:, None, :], axis=-1)
    _eq(tbm.query_order_from_sorted(torch.from_numpy(srt), 20),
        jbm.query_order_from_sorted(jnp.asarray(srt), 20))
    _eq(tbm.block_occupancy(torch.from_numpy(m), 8, 16),
        jbm.block_occupancy(jnp.asarray(m), 8, 16))
    np.testing.assert_allclose(
        float(tbm.block_skip_fraction(got[2])),
        float(jbm.block_skip_fraction(want[2])), rtol=1e-6)


@pytest.mark.parametrize("pad_to,truncate", [(None, False), (3, True),
                                             (4, False)])
def test_compact_plan_of_a_sata_map_matches(pad_to, truncate):
    bm = np.array(jbm.sata_block_plan(
        jnp.asarray(_topk_masks(5, 3, 64, 6)), 16, 16)[2])
    bm[0, 1] = False                                     # an empty row
    if pad_to is not None and not truncate:
        pad_to = int(bm.sum(-1).max())
    want = jbm.compact_kv_plan(jnp.asarray(bm), pad_to=pad_to,
                               truncate=truncate)
    got = tbm.compact_kv_plan(torch.from_numpy(bm), pad_to=pad_to,
                              truncate=truncate)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("s,chunk,qb", [(64, None, 16), (64, 40, 16),
                                        (96, 64, 16), (32, 32, 32)])
def test_resolve_sel_chunk(s, chunk, qb):
    assert tbm.resolve_sel_chunk(chunk, s, qb) == \
        jbm.resolve_sel_chunk(chunk, s, qb)


def _thr_close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=THR_RTOL * scale)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [16, 32])
def test_chunked_selection_matches(causal, chunk):
    q, k = _qk(6, 4, 64, 16)
    kw = dict(causal=causal, chunk=chunk, q_block=16, k_block=16)
    thr_w, bm_w = jsel.select_thresholds_chunked(
        jnp.asarray(q), jnp.asarray(k), 8, **kw)
    thr_g, bm_g = tsel.select_thresholds_chunked(
        torch.from_numpy(q), torch.from_numpy(k), 8, **kw)
    assert thr_g.shape == (4, 64, 1) and bm_g.dtype == torch.bool
    _thr_close(thr_g, thr_w)
    _eq(bm_g, bm_w)
    # the re-streamed occupancy from the SAME thresholds, and the plan
    want = jbm.compact_plan_from_chunks(
        jnp.asarray(q), jnp.asarray(k), thr_w, **kw)
    got = tbm.compact_plan_from_chunks(
        torch.from_numpy(q), torch.from_numpy(k),
        torch.from_numpy(np.array(thr_w)), **kw)
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(got[0], bm_w)


def test_chunked_threshold_equals_the_full_row_bisect():
    """Row-local bisection: chunking over queries changes nothing."""
    q, k = _qk(7, 2, 64, 16)
    thr, _ = tsel.select_thresholds_chunked(
        torch.from_numpy(q), torch.from_numpy(k), 8, causal=True, chunk=16,
        q_block=16, k_block=16)
    sc = torch.einsum("bqd,bkd->bqk", torch.from_numpy(q),
                      torch.from_numpy(k)) * 0.25
    adm = torch.ones(64, 64, dtype=torch.bool).tril()
    full = tsel.kth_largest_bisect(torch.where(adm, sc, tsel.NEG_INF), 8)
    torch.testing.assert_close(thr, full, rtol=0, atol=0)


def test_occupancy_bound_matches():
    rng = np.random.default_rng(8)
    cnt = rng.integers(0, 9, (3, 5))
    for pct in (100.0, 90.0, 50.0):
        assert tbm.occupancy_bound(torch.from_numpy(cnt), pct) == \
            jbm.occupancy_bound(cnt, pct)
    assert tbm.occupancy_bound(np.zeros((0,), int)) == 1


@pytest.mark.parametrize("max_kv_blocks", [None, 3])
def test_kernel_fetch_stats_identical(max_kv_blocks):
    bm = np.array(jbm.sata_block_plan(
        jnp.asarray(_topk_masks(9, 3, 64, 6)), 16, 16)[2])
    kw = dict(q_block=16, k_block=16, d=16, dtype_bytes=2,
              max_kv_blocks=max_kv_blocks)
    assert tops.kernel_fetch_stats(torch.from_numpy(bm), **kw) == \
        jops.kernel_fetch_stats(bm, **kw)
