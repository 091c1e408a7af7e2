"""Port parity for the cross-replica prefix index: ``SharedPrefixIndex``
(publish / lookup sequences, stats, payload bits), ``serve(prefix_index=,
replica_id=)`` replica by replica on one index, ``serve_replicated`` and
the migration given up under pool pressure — each against the
reference on the same inputs: counts, stats and token streams ``==``.

The index's own payloads are compared by their bits: the reference's
bf16 rows are ml_dtypes ``bfloat16``, the port's ``int16`` bit patterns,
so both are viewed as ``uint16`` (fp32 as ``uint32``).  Payloads that
``serve()`` gathered hold K/V rows each package projected itself, so
they are held to ``ROW_ATOL`` (fp32 summation order of one projection,
as ``tests/test_torch_prefix_cache.py`` holds them); the digests, owners
and tokens beside them are exact.  The serve tests build the
reference's replica test config (``tests/test_mesh_serving.py``) with
the flat kwargs on both sides, through each package's shim, and serve
the reference's weights in the port through ``params_from_jax``."""
import dataclasses
import warnings

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.core import paging as jpg  # noqa: E402
from repro.launch import serve as jsv  # noqa: E402
from repro.models import config as jconf  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.core import paging as tpg  # noqa: E402
from repro_torch.launch import serve as tsv  # noqa: E402
from repro_torch.models import config as tconf  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402

# tests/test_mesh_serving.py::test_serve_replicated_cross_replica_hits
FLAT = dict(attention_variant="topk", topk_impl="bisect", sata_decode="on",
            sata_decode_block=8, kv_cache_layout="paged", kv_page_size=8,
            kv_prefix_cache=True)
OPTS = dict(n_requests=4, batch_slots=2, gen_len=3, max_len=64,
            prompt_len=17, shared_prefix_len=16)
# the workload under pool pressure: 10 pages of 8 for two slots of
# 33-token prompts, so a claim whose local trie lost pages to eviction
# cannot take a migration's full page count and admits plainly
PRESSURE = dict(n_requests=4, batch_slots=2, gen_len=8, max_len=64,
                prompt_len=33, shared_prefix_len=16)
ROW_ATOL = 1e-5     # one freshly projected K / V row, fp32
REPLICA_KEYS = ("replica_id", "cross_replica_hits", "cross_replica_hit_rate",
                "migrated_pages", "migrated_tokens", "index_pages_published",
                "index")
PREFIX_KEYS = ("requests", "hits", "hit_rate", "prefill_tokens_saved",
               "cached_pages", "evictions", "invalidated",
               "prefill_tokens_total", "cow_copies", "shared_pages_peak")


@pytest.fixture(autouse=True)
def _fresh_warn_registries(monkeypatch):
    """The flat-name registries are process-global; each test starts
    from fresh ones (other files may share this worker)."""
    for mod in (jconf, tconf):
        monkeypatch.setattr(mod, "_warned_flat", set())
    for mod in (jsv, tsv):
        monkeypatch.setattr(mod, "_warned_serve_legacy", False)


def _bits(a: np.ndarray) -> np.ndarray:
    """An array's raw bits (bf16 of either package as uint16)."""
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32, 1: np.uint8}[a.itemsize])


# ---------------------------------------------------------------------------
# SharedPrefixIndex: the same publish / lookup sequences on both packages
# ---------------------------------------------------------------------------

def _payload(rng, n_pages, page, dtype):
    """A gathered payload of ``n_pages`` pages, for (reference, port):
    K rows and a summary field; bf16 as ml_dtypes vs int16 bits."""
    k = rng.standard_normal((2, n_pages, page, 2, 4)).astype(np.float32)
    kmin = rng.standard_normal((2, n_pages, 2, 4)).astype(np.float32)
    if dtype == "bfloat16":
        jk = k.astype(ml_dtypes.bfloat16)
        return ({"kv.k_pages": jk, "kv.k_min": kmin},
                {"kv.k_pages": jk.view(np.int16), "kv.k_min": kmin})
    return {"kv.k_pages": k, "kv.k_min": kmin}, \
        {"kv.k_pages": k.copy(), "kv.k_min": kmin.copy()}


def _tokens(rng, n, share=None, keep=0):
    t = rng.integers(0, 50, n).astype(np.int64)
    if share is not None:
        t[:keep] = share[:keep]
    return t


def _script(name, rng):
    """(op, replica, tokens) steps of one scenario, page 8."""
    if name == "reference":        # tests/test_mesh_serving.py:141-157
        t = np.arange(16, dtype=np.int64)
        return [("lookup", 0, t), ("publish", 0, t), ("lookup", 0, t),
                ("lookup", 1, t), ("publish", 1, t)]
    a = _tokens(rng, 40)
    if name == "diverge":          # chains that part inside page 1 / 3
        b = _tokens(rng, 40, a, 12)
        c = _tokens(rng, 33, a, 28)
        return [("publish", 0, a), ("publish", 1, b), ("lookup", 2, a),
                ("lookup", 2, b), ("lookup", 0, b), ("lookup", 1, c),
                ("publish", 2, c), ("lookup", 0, c), ("lookup", 1, a[:7]),
                ("lookup", 1, _tokens(rng, 24))]
    if name == "dedup":            # first publisher wins; extensions add
        return [("publish", 1, a[:24]), ("publish", 0, a),
                ("publish", 0, a), ("publish", 2, a[:16]),
                ("lookup", 3, a), ("lookup", 1, a[:31]), ("lookup", 0, a)]
    if name == "self":             # a publisher reads its own pages back
        b = _tokens(rng, 32, a, 16)
        return [("publish", 0, a), ("lookup", 0, a), ("lookup", 0, b),
                ("publish", 0, b), ("lookup", 0, b), ("lookup", 1, b)]
    raise KeyError(name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["reference", "diverge", "dedup", "self"])
def test_index_sequences_match_reference(name, dtype):
    """Every publish's count, every lookup's (matched tokens, payload
    bits, remote pages) or None, and the stats after each step equal the
    reference's."""
    rng = np.random.default_rng(7)
    jidx, tidx = jpg.SharedPrefixIndex(), tpg.SharedPrefixIndex()
    for op, rid, toks in _script(name, rng):
        if op == "publish":
            jp, tp = _payload(rng, len(toks) // 8, 8, dtype)
            assert tidx.publish(rid, toks, 8, tp) == \
                jidx.publish(rid, toks, 8, jp)
        else:
            want, got = jidx.lookup(rid, toks), tidx.lookup(rid, toks)
            assert (got is None) == (want is None), (op, rid)
            if want is not None:
                assert got[0] == want[0] and got[2] == want[2]
                assert sorted(got[1]) == sorted(want[1])
                for k in want[1]:
                    np.testing.assert_array_equal(_bits(got[1][k]),
                                                  _bits(want[1][k]), k)
        assert tidx.stats() == jidx.stats()
    assert tidx.host_bytes() == sum(
        a.nbytes for _, _, pl in jidx._pages.values() for a in pl.values())


def test_index_refuses_a_second_page_size():
    for pg in (jpg, tpg):
        idx = pg.SharedPrefixIndex()
        idx.publish(0, np.arange(16), 8,
                    {"kv.k_pages": np.zeros((1, 2, 8, 1, 1), np.float32)})
        with pytest.raises(AssertionError, match="page size"):
            idx.publish(1, np.arange(16), 4,
                        {"kv.k_pages": np.zeros((1, 4, 4, 1, 1),
                                                np.float32)})


# ---------------------------------------------------------------------------
# serve(prefix_index=, replica_id=) and serve_replicated
# ---------------------------------------------------------------------------

def _cfgs(**extra):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return [dataclasses.replace(smoke["qwen3-4b"], **FLAT, **extra)
                for smoke in (JSMOKE, TSMOKE)]


@pytest.fixture(scope="module")
def weights():
    """The reference's seed-0 weights, and the port's model made from
    them."""
    jc, tc = _cfgs()
    params = jmdl.init_params(jax.random.PRNGKey(0), jc)
    return params, params_from_jax(jax.tree.map(np.asarray, params), tc,
                                   device="cpu")


def test_reference_replica_config_builds_with_flat_kwargs():
    """The reference's replica test writes its config with flat kwargs:
    the port's shim folds them into the same nested groups."""
    jc, tc = _cfgs()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.kv.prefix_cache and tc.kv.page_size == 8
    assert tc.sata.decode.mode == "on" and tc.sata.decode.block == 8


def _check_reports(want, got):
    assert got["outputs"] == want["outputs"]
    assert got["steps"] == want["steps"]
    for k in REPLICA_KEYS:
        assert got["replica"][k] == want["replica"][k], k
    for k in PREFIX_KEYS:
        assert got["prefix_cache"][k] == want["prefix_cache"][k], k
    for k in ("deferred_claims", "pages_in_use_peak", "audits_run"):
        assert got["page_occupancy"][k] == want["page_occupancy"][k], k


def _check_indexes(jidx, tidx):
    """Both indexes hold the same digests, owners and tokens, and each
    page's payload fields at the same dtype and shape, within
    ``ROW_ATOL``."""
    assert tidx.stats() == jidx.stats()
    assert set(tidx._pages) == set(jidx._pages)
    for d, (rid, toks, pl) in jidx._pages.items():
        trid, ttoks, tpl = tidx._pages[d]
        assert (trid, ttoks) == (rid, toks)
        assert sorted(tpl) == sorted(pl)
        for k in pl:
            assert tpl[k].dtype == pl[k].dtype == np.float32, k
            np.testing.assert_allclose(tpl[k], pl[k], rtol=0, atol=ROW_ATOL,
                                       err_msg=k)


def _replicas(weights, n, opts, **extra):
    """``n`` replicas of each package served one after another on one
    index each: (reference reports, port reports, the two indexes)."""
    params, model = weights
    jc, tc = _cfgs(**extra)
    jidx, tidx = jpg.SharedPrefixIndex(), tpg.SharedPrefixIndex()
    want, got = [], []
    for rid in range(n):
        want.append(jsv.serve("qwen3-4b", cfg=jc, params=params,
                              options=jsv.ServeOptions(**opts),
                              prefix_index=jidx, replica_id=rid))
        got.append(tsv.serve("qwen3-4b", cfg=tc, model=model, device="cpu",
                             options=tsv.ServeOptions(**opts),
                             prefix_index=tidx, replica_id=rid))
    return want, got, jidx, tidx


def test_serve_replica_by_replica_matches_reference(weights):
    """Two replicas on one index: replica 0 prefills cold and publishes
    the shared prefix's two pages, replica 1's first claim migrates them
    and the rest hit its own trie.  Streams, the ``replica`` report, the
    prefix cache's counters and the index (digests, owners, tokens,
    payload bits) equal the reference's."""
    want, got, jidx, tidx = _replicas(weights, 2, OPTS)
    for w, g in zip(want, got):
        _check_reports(w, g)
    _check_indexes(jidx, tidx)
    r0, r1 = (g["replica"] for g in got)
    assert r0["cross_replica_hits"] == 0 and r0["index_pages_published"] == 2
    assert (r1["cross_replica_hits"], r1["migrated_pages"],
            r1["migrated_tokens"]) == (1, 2, 16)
    assert r1["migrate_ms_mean"] is not None
    assert r0["migrations_dropped"] == r1["migrations_dropped"] == 0
    assert got[0]["outputs"] == got[1]["outputs"]


def test_migration_dropped_under_pool_pressure(weights):
    """Under pool pressure a migration (which pays for every prompt page)
    is given up before the claim defers: where the local trie still
    maps part of the prefix, the claim admits plainly.  Every counter
    equals the reference's, and the replicas still agree bitwise."""
    want, got, jidx, tidx = _replicas(weights, 2, PRESSURE,
                                      kv_pool_pages=10)
    for w, g in zip(want, got):
        _check_reports(w, g)
    _check_indexes(jidx, tidx)
    r1, occ = got[1]["replica"], got[1]["page_occupancy"]
    # more migrations given up than claims deferred: at least one gave up
    # its migration and was admitted on its local match instead
    assert r1["migrations_dropped"] > occ["deferred_claims"] > 0
    assert r1["cross_replica_hits"] > 0
    assert got[0]["outputs"] == got[1]["outputs"]


@pytest.mark.parametrize("n", [2, 3])
def test_serve_replicated_matches_reference(weights, n):
    """The N-replica harness against the reference's: the aggregate
    report, each replica's report and the asserted bitwise agreement;
    ``model=`` serves the reference's weights on every replica."""
    params, model = weights
    jc, tc = _cfgs()
    with warnings.catch_warnings():
        # the reference builds each replica's weights with jax.random
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jsv.serve_replicated("qwen3-4b", n_replicas=n, cfg=jc,
                                    options=jsv.ServeOptions(**OPTS))
    got = tsv.serve_replicated("qwen3-4b", n_replicas=n, cfg=tc, model=model,
                               options=tsv.ServeOptions(**OPTS), device="cpu")
    for k in want:
        if k != "replicas":
            assert got[k] == want[k], k
    for w, g in zip(want["replicas"], got["replicas"]):
        _check_reports(w, g)
    assert got["outputs_equal"] and got["cross_replica_hits"] == n - 1
    assert got["index"]["remote_hits"] == n - 1


def test_serve_replicated_holds_no_device_state(weights):
    """A replica's report carries host values only: its pool and cache
    are gone when the next replica starts."""
    _, model = weights
    _, tc = _cfgs()
    out = tsv.serve_replicated("qwen3-4b", n_replicas=2, cfg=tc, model=model,
                               options=tsv.ServeOptions(**OPTS), device="cpu")

    def walk(x):
        assert not isinstance(x, torch.Tensor)
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(out)
