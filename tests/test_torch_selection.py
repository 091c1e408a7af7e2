"""Port parity: selection primitives and plan layout.

The same numpy inputs go through ``repro.core`` (JAX) and
``repro_torch.core`` (PyTorch, CPU).  Selection is integer/boolean state,
so it must match EXACTLY; the bisect thresholds are built from fp32
min/max and midpoints only, so they match bitwise too."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax.numpy as jnp  # noqa: E402

from repro.core import blockmap as jbm  # noqa: E402
from repro.core import decode_plan as jdp  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro_torch.core import blockmap as tbm  # noqa: E402
from repro_torch.core import decode_plan as tdp  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402


def _scores(seed, shape, masked_frac=0.3):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal(shape).astype(np.float32)
    s[rng.random(shape) < masked_frac] = tsel.NEG_INF
    return s


def test_neg_inf_sentinel_matches():
    assert tsel.NEG_INF == jsel.NEG_INF == -2.0 ** 30


@pytest.mark.parametrize("seed", [0, 1])
def test_bisect_select_exact(seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((4, 33)).astype(np.float32)
    t = rng.standard_normal((4, 1)).astype(np.float32)
    # values one fp32 ulp apart straddle bf16 rounding boundaries
    s[:, :8] = np.nextafter(t, np.inf)
    want = np.asarray(jbm.bisect_select(jnp.asarray(s), jnp.asarray(t)))
    got = tbm.bisect_select(torch.from_numpy(s), torch.from_numpy(t))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 4, 17])
def test_kth_largest_bisect_exact(k):
    s = _scores(k, (3, 2, 5, 64))
    want = np.asarray(jsel.kth_largest_bisect(jnp.asarray(s), k))
    got = tsel.kth_largest_bisect(torch.from_numpy(s), k).numpy()
    np.testing.assert_array_equal(got, want)


def test_kth_largest_bisect_per_row_k():
    s = _scores(3, (4, 2, 40))
    k = np.array([1, 3, 7, 40], np.int32)[:, None, None]
    want = np.asarray(jsel.kth_largest_bisect(jnp.asarray(s), jnp.asarray(k)))
    got = tsel.kth_largest_bisect(torch.from_numpy(s),
                                  torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got, want)


def test_kth_largest_bisect_all_masked_row():
    s = _scores(4, (2, 16))
    s[1] = tsel.NEG_INF
    want = np.asarray(jsel.kth_largest_bisect(jnp.asarray(s), 3))
    got = tsel.kth_largest_bisect(torch.from_numpy(s), 3).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [2, 9])
def test_topk_mask_bisect_exact(k):
    s = _scores(10 + k, (2, 3, 48))
    want = np.asarray(jsel.topk_mask_bisect(jnp.asarray(s), k))
    got = tsel.topk_mask_bisect(torch.from_numpy(s), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) >= np.minimum(k, (s > tsel.NEG_INF / 2).sum(-1))).all()


def _block_map(seed):
    rng = np.random.default_rng(seed)
    bm = rng.random((3, 6, 10)) < 0.35
    bm[0, 0] = False                    # leading empty row
    bm[0, 3] = False                    # empty row after a non-empty one
    bm[1] = False                       # all-empty batch entry
    bm[2, 5] = True                     # a full row
    return bm


@pytest.mark.parametrize("pad_to,truncate", [(None, False), (10, False),
                                             (4, True), (1, True)])
def test_compact_kv_plan_exact(pad_to, truncate):
    bm = _block_map(5)
    wi, wc = jbm.compact_kv_plan(jnp.asarray(bm), pad_to=pad_to,
                                 truncate=truncate)
    gi, gc = tbm.compact_kv_plan(torch.from_numpy(bm), pad_to=pad_to,
                                 truncate=truncate)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert gi.dtype == gc.dtype == torch.int32


def test_compact_kv_plan_rejects_silent_drop():
    bm = _block_map(6)
    with pytest.raises(ValueError):
        tbm.compact_kv_plan(torch.from_numpy(bm), pad_to=2)


def test_incremental_summaries_equal_recompute_bitwise():
    """Step-by-step ``update_block_summaries`` == ``summaries_from_cache``
    in the port (min/max is associative), and both equal the JAX
    reference's recompute."""
    rng = np.random.default_rng(0)
    b, s, kv, d, blk = 3, 32, 2, 8, 8
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    plan = tdp.init_decode_plan(b, kv, s, d, blk, device="cpu")
    steps = [5, 17, 31]
    for t in range(max(steps) + 1):
        pos = torch.tensor([min(t, p) for p in steps], dtype=torch.int32)
        rows = torch.from_numpy(k)[torch.arange(b), pos.long()][:, None]
        tdp.update_block_summaries(plan, rows, pos, k_block=blk)
    pos = torch.tensor(steps, dtype=torch.int32)
    lo, hi = tdp.summaries_from_cache(torch.from_numpy(k), pos, k_block=blk)
    assert torch.equal(plan["k_min"], lo) and torch.equal(plan["k_max"], hi)
    jlo, jhi = jdp.summaries_from_cache(jnp.asarray(k), jnp.asarray(steps),
                                        k_block=blk)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
