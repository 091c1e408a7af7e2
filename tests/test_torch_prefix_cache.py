"""Port parity: the shared-prefix page cache — the allocator's refcounts,
copy-on-write and lazy write leases, the prompt-prefix trie (match,
register, evict), the device-side page copy, the paged write path's
shared-page protect, the cache-hit install, and ``serve()`` with the
cache on, each against the JAX reference on the same inputs.

Tolerances: host state (trie contents, page tables, refcounts, free
lists, leases, hit and copy counters) and greedy token streams are
exact; logits 1e-4 and freshly computed K rows 1e-5 against the
reference (fp32 summation order, as in ``test_torch_serve.py``), while
the port's own cache hit is bitwise its miss.  Both packages serve at
their default ``ResilienceOptions()``: a preemption is a host swap whose
handle pins the trie's shared pages, and the swap counters are equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.core import paging as jpg  # noqa: E402
from repro.launch import serve as jsv  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.models.config import KVCacheConfig as JKV  # noqa: E402
from repro.models.config import SataDecodeConfig as JDec  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.core import paging as tpg  # noqa: E402
from repro_torch.launch import serve as tsv  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models.config import KVCacheConfig as TKV  # noqa: E402
from repro_torch.models.config import SataDecodeConfig as TDec  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402

LOGIT_ATOL = 1e-4    # fp32 summation order over 4 layers
ROW_ATOL = 1e-5      # one freshly projected K row


def _cfgs(sata="on", summary="fp32", replan=1, dec=None, **kv):
    """(JAX, port) qwen3-4b smoke configs: bisect, decode block 8 (plus
    the ``dec`` overrides), paged with the prefix cache on unless ``kv``
    overrides."""
    kv = {"layout": "paged", "prefix_cache": True, **kv}
    dec = dict(mode=sata, block=8, replan=replan, summary=summary,
               **(dec or {}))
    out = []
    for smoke, dcls, kvc in ((JSMOKE, JDec, JKV), (TSMOKE, TDec, TKV)):
        base = smoke["qwen3-4b"]
        out.append(dataclasses.replace(
            base, topk_impl="bisect",
            sata=dataclasses.replace(base.sata, decode=dcls(**dec)),
            kv=kvc(**kv)))
    return out


def _weights(seed=0):
    jc, tc = _cfgs()
    params = jmdl.init_params(jax.random.PRNGKey(seed), jc)
    return params, params_from_jax(jax.tree.map(np.asarray, params), tc,
                                   device="cpu")


@pytest.fixture(scope="module")
def weights():
    return _weights(0)


# ---------------------------------------------------------------------------
# Allocator + trie: the same operations on both packages' host state
# ---------------------------------------------------------------------------

def _pool(pg, n_pages=16, slots=4, max_pages=8, page=4):
    a = pg.PageAllocator(n_pages, slots, max_pages, page)
    return a, pg.PrefixCache(a)


def _state(a, pc):
    """Everything the host bookkeeping decides, as plain values."""
    return {
        "table": a.table.tolist(), "n_mapped": a.n_mapped.tolist(),
        "ref": a.ref.tolist(), "free": list(a.free),
        "leases": dict(a.cow_leases), "skips": a.lazy_cow_skips,
        "peaks": (a.pages_in_use_peak, a.shared_pages_peak),
        "retained": pc.retained_pages(), "nodes": pc.node_count,
        "stats": pc.stats(),
    }


def _sc_register_then_match(pg):
    a, pc = _pool(pg, page=4)
    toks = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10])
    obs = [a.ensure(0, 9)]
    obs.append(pc.register(toks, a.table[0].copy()))
    for t in (toks[:-1], [1, 2, 3, 4, 5, 6, 7, 8, 99, 100], [1, 2, 42, 43],
              [9, 9, 9]):
        obs.append(pc.match(np.array(t)))
    return obs, a, pc


def _sc_chain_digest_depth(pg):
    a, pc = _pool(pg, page=2)
    obs = [a.ensure(0, 5)]
    obs.append(pc.register(np.array([7] * 6), a.table[0].copy()))
    obs.append(pc.match(np.array([5, 5, 7, 7])))
    obs.append(pc.match(np.array([7, 7, 7, 7])))
    return obs, a, pc


def _sc_free_slot_keeps_cached(pg):
    a, pc = _pool(pg)
    obs = [a.ensure(0, 7), pc.register(np.arange(8), a.table[0].copy())]
    obs += [a.free_slot(0), a.pages_in_use, pc.match(np.arange(8))]
    return obs, a, pc


def _sc_evict_lru(pg):
    a, pc = _pool(pg, n_pages=16, page=4)
    obs = [a.ensure(0, 7)]
    obs.append(pc.register(np.array([1, 2, 3, 4, 5, 6, 7, 8]), a.table[0]))
    obs.append(a.ensure(1, 7))
    obs.append(pc.register(np.array([1, 2, 3, 4, 9, 9, 9, 9]), a.table[1]))
    a.free_slot(0)
    a.free_slot(1)
    obs.append(pc.evict(len(a.free) + 3))
    obs.append(pc.match(np.array([1, 2, 3, 4])))
    return obs, a, pc


def _sc_evict_skips_mapped(pg):
    a, pc = _pool(pg)
    obs = [a.ensure(0, 7), pc.register(np.arange(8), a.table[0].copy())]
    obs += [pc.evict(len(a.free) + 1), pc.cached_pages]
    return obs, a, pc


def _sc_map_shared_and_cow(pg):
    a, pc = _pool(pg, n_pages=8, page=4)
    obs = [a.ensure(0, 6)]
    row = a.table[0].copy()
    obs.append(pc.register(np.arange(7), row))
    a.map_shared(1, [int(row[0]), int(row[1])])
    obs.append(a.shared_pages)
    for pos in (3, 3, 8):
        obs.append(a.ensure_writable(1, pos))
    return obs, a, pc


def _sc_cow_stalls_when_dry(pg):
    a, pc = _pool(pg, n_pages=4, page=4)
    obs = [a.ensure(0, 7), pc.register(np.arange(8), a.table[0].copy())]
    a.map_shared(1, [int(a.table[0, 0])])
    obs += [a.ensure(1, 7), a.ensure_writable(1, 0)]
    a.free_slot(0)
    obs += [a.ensure_writable(1, 0), pc.evict(1), a.ensure_writable(1, 0)]
    return obs, a, pc


def _sc_free_never_frees_shared(pg):
    a, pc = _pool(pg, n_pages=8, page=4)
    obs = [a.ensure(0, 3)]
    row = a.table[0].copy()
    obs.append(pc.register(np.arange(4), row))
    a.map_shared(1, [int(row[0])])
    obs += [a.free_slot(1), int(a.ref[row[0]]), a.free_slot(0),
            int(a.ref[row[0]]), int(row[0]) in a.free]
    return obs, a, pc


def _sc_lazy_lease_lifecycle(pg):
    a, pc = _pool(pg, n_pages=12, slots=3)
    a.lazy_cow = True
    obs = [a.ensure(0, 5), pc.register(np.arange(6), a.table[0])]
    p1 = int(a.table[0, 1])
    obs += [pc.covered_rows(p1), a.ensure_writable(0, 6),
            a.writable_ref_view().tolist(), a.ensure_writable(0, 6)]
    a.map_shared(2, [p1])
    obs += [a.writable_ref_view().tolist(), a.ensure_writable(0, 7)]
    return obs, a, pc


def _sc_lazy_no_lease_inside_covered(pg):
    a, pc = _pool(pg, n_pages=12, slots=3)
    a.lazy_cow = True
    obs = [a.ensure(0, 5), pc.register(np.arange(6), a.table[0])]
    p0, p1 = int(a.table[0, 0]), int(a.table[0, 1])
    a.free_slot(0)
    a.map_shared(1, [p0, p1])
    obs.append(a.ensure_writable(1, 5))
    return obs, a, pc


def _sc_lazy_lease_dropped_with_slot(pg):
    a, pc = _pool(pg, n_pages=12, slots=3)
    a.lazy_cow = True
    obs = [a.ensure(0, 5), pc.register(np.arange(6), a.table[0]),
           a.ensure_writable(0, 6), dict(a.cow_leases)]
    a.free_slot(0)
    return obs, a, pc


def _sc_random_interleaving(pg):
    """Seeded claim / append / register / free / evict / invalidate over
    two overlapping prompt families, lazy leases on."""
    a, pc = _pool(pg, n_pages=10, slots=3, max_pages=6, page=4)
    a.lazy_cow = True
    rng = np.random.default_rng(5)
    base = rng.integers(0, 30, 14)
    fams = [base, np.concatenate([base[:9], rng.integers(0, 30, 5)])]
    pos = np.zeros(3, np.int64)
    hist = [None] * 3
    obs = []
    for _ in range(120):
        op, s = int(rng.integers(0, 6)), int(rng.integers(0, 3))
        if op == 0 and hist[s] is None:                        # claim
            toks = fams[int(rng.integers(0, 2))]
            m, phys, part = pc.match(toks[:-1])
            obs.append((m, list(phys), part))
            if m:
                a.map_shared(s, phys)
            hist[s], pos[s] = toks, m
        elif op == 1 and hist[s] is not None and pos[s] < 23:  # append
            ok, cp = a.ensure_writable(s, int(pos[s]))
            ok = ok and a.ensure(s, int(pos[s]))
            obs.append((ok, cp))
            pos[s] += int(ok)
        elif op == 2 and hist[s] is not None and pos[s] > 0:   # register
            n = int(min(pos[s], len(hist[s])))
            obs.append(pc.register(hist[s][:n], a.table[s]))
        elif op == 3 and hist[s] is not None:                  # free
            obs.append(a.free_slot(s))
            hist[s] = None
        elif op == 4:
            obs.append(pc.evict(len(a.free) + 1))
        elif op == 5 and rng.random() < 0.2:
            obs.append(pc.invalidate_pages(pc.retained_pages()[:1]))
        obs.append(a.writable_ref_view().tolist())
        a.check_invariants(pc)
    return obs, a, pc


SCENARIOS = {f.__name__[4:]: f for f in (
    _sc_register_then_match, _sc_chain_digest_depth,
    _sc_free_slot_keeps_cached, _sc_evict_lru, _sc_evict_skips_mapped,
    _sc_map_shared_and_cow, _sc_cow_stalls_when_dry,
    _sc_free_never_frees_shared, _sc_lazy_lease_lifecycle,
    _sc_lazy_no_lease_inside_covered, _sc_lazy_lease_dropped_with_slot,
    _sc_random_interleaving)}


def _plain(x):
    """Observations as plain Python values (numpy ints compare equal
    to ints, but tuples of them print unhelpfully)."""
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, np.generic):
        return x.item()
    return x


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_allocator_and_trie_match_reference(name):
    """Each scenario of ``tests/test_prefix_cache.py`` (trie match /
    register / evict, refcounted CoW, lazy leases) plus a seeded random
    interleaving: every return value and the whole host state equal the
    reference's, and the port's invariant audit passes."""
    jobs, ja, jpc = SCENARIOS[name](jpg)
    tobs, ta, tpc = SCENARIOS[name](tpg)
    assert _plain(tobs) == _plain(jobs)
    assert _plain(_state(ta, tpc)) == _plain(_state(ja, jpc))
    ta.check_invariants(tpc)
    if name == "map_shared_and_cow":          # the reference test's pins
        (src, dst) = tobs[3][1]
        assert ta.table[1, 0] == dst and ta.ref[dst] == 1 \
            and ta.ref[src] == 2
        assert tobs[4] == (True, None) and tobs[5] == (True, None)


def test_check_invariants_catches_corruption():
    """The audit fails on a leaked reference, a double-listed page, a
    stale table entry and a dead trie page, as the reference's does."""
    def fresh():
        a, pc = _pool(tpg)
        assert a.ensure(0, 7)
        pc.register(np.arange(8), a.table[0].copy())
        a.check_invariants(pc)
        return a, pc

    a, pc = fresh()
    a.ref[int(a.table[0, 0])] += 1
    with pytest.raises(AssertionError, match="refcount mismatch"):
        a.check_invariants(pc)
    a, pc = fresh()
    a.free.append(a.free[-1])
    with pytest.raises(AssertionError, match="duplicates"):
        a.check_invariants(pc)
    a, pc = fresh()
    a.table[0, 5] = 3
    with pytest.raises(AssertionError, match="stale table entry"):
        a.check_invariants(pc)
    a, pc = fresh()
    a.free_slot(0)
    a.ref[pc.retained_pages()[0]] = 0
    with pytest.raises(AssertionError, match="dead page"):
        a.check_invariants(pc)


def test_prefix_cache_requires_paged_layout():
    jc, tc = _cfgs(layout="contiguous")
    for mod, cfg in ((jattn, jc), (tattn, tc)):
        with pytest.raises(ValueError, match="paged"):
            mod.prefix_cache_on(cfg)


# ---------------------------------------------------------------------------
# Device side: CoW copy + shared-page write protect
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("summary", ["fp32", "int8"])
def test_copy_phys_pages_matches(summary):
    """K/V and every per-page summary row move together, across layers,
    exactly as the reference's copy moves them."""
    jc, tc = _cfgs(summary=summary)
    jcache = jdec.init_cache(jc, 2, 32)
    tcache = tdec.init_cache(tc, 2, 32, device="cpu")
    fields = ("k_pages", "v_pages") + tpg.page_summary_fields(summary)
    assert set(fields) <= set(tcache["kv"])
    rng = np.random.default_rng(0)
    jkv = dict(jcache["kv"])
    for f in fields:
        a = np.asarray(jkv[f])
        v = rng.standard_normal(a.shape) * 50
        v = v.astype(a.dtype)
        jkv[f] = jnp.asarray(v)
        tcache["kv"][f].copy_(torch.from_numpy(v))
    jout = jdec.copy_phys_pages({**jcache, "kv": jkv}, [(3, 5), (1, 2)])
    tdec.copy_phys_pages(tcache, [(3, 5), (1, 2)])
    for f in fields:
        np.testing.assert_array_equal(tcache["kv"][f].numpy(),
                                      np.asarray(jout["kv"][f]), err_msg=f)
    np.testing.assert_array_equal(tcache["kv"]["k_pages"][:, 5].numpy(),
                                  tcache["kv"]["k_pages"][:, 3].numpy())


def test_paged_write_protect_matches():
    """A decode append aimed at a shared page (refcount > 1) lands in the
    overflow page and leaves the page's bytes untouched; at refcount 1
    the same write mutates it.  Outputs match the reference's."""
    jc, tc = _cfgs(sata="off")
    b, max_len = 2, 32
    jp = jattn.attention_init(jax.random.PRNGKey(0), jc)
    tp = {n: torch.from_numpy(np.array(a)) for n, a in jp.items()}
    x = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                     (b, 1, jc.d_model)))
    for ref2 in (2, 1):
        jcache = jattn.init_kv_cache(jc, b, max_len, jnp.float32)
        tcache = tattn.init_kv_cache(tc, b, max_len, torch.float32,
                                     device="cpu")
        page = int(jcache["k_pages"].shape[1])
        tbl = np.full((b, max_len // page), jpg.OVERFLOW_PAGE, np.int32)
        tbl[0, 0] = 2                         # slot 0 writes into page 2
        ref = np.zeros(jcache["k_pages"].shape[0], np.int32)
        ref[2] = ref2
        jcache["page_table"], jcache["page_ref"] = (jnp.asarray(tbl),
                                                    jnp.asarray(ref))
        tcache["page_table"].copy_(torch.from_numpy(tbl))
        tcache["page_ref"].copy_(torch.from_numpy(ref))
        before = tcache["k_pages"][2].clone()
        jy, jout = jattn.attention_decode(jp, jc, jnp.asarray(x), jcache,
                                          jnp.zeros((b,), jnp.int32))
        with torch.no_grad():
            ty, tout = tattn.attention_decode(
                tp, tc, torch.from_numpy(x), tcache,
                torch.zeros((b,), dtype=torch.int32))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   atol=ROW_ATOL, rtol=0)
        np.testing.assert_allclose(tout["k_pages"].numpy(),
                                   np.asarray(jout["k_pages"]),
                                   atol=ROW_ATOL, rtol=0)
        moved = bool((tout["k_pages"][2] != before).any())
        assert moved == (ref2 == 1)


# ---------------------------------------------------------------------------
# Install path: cache-hit install vs the reference and vs the miss install
# ---------------------------------------------------------------------------

def _hit_vs_miss(pkg, cfg, model, toks, max_len=32, b=2):
    """Request A misses (full prefill into slot 0, registered); request
    B with the same prompt hits: tail prefill into slot 1 over the
    gathered prefix.  ``pkg`` is (paging, decode, to-device, argmax)."""
    pg, dec, put, cache = pkg["pg"], pkg["dec"], pkg["put"], pkg["cache"]
    page = int(cache["kv"]["k_pages"].shape[2])
    alloc = pg.PageAllocator(int(cache["kv"]["k_pages"].shape[1]), b,
                             max_len // page, page)
    pc = pg.PrefixCache(alloc)
    sp = toks.shape[1]
    assert alloc.ensure(0, sp - 1)
    lg_a, st_a = dec.prefill_prompt(model, cfg, put(toks), max_len)
    cache = dec.set_page_table(cfg, cache, alloc.table, alloc.ref)
    cache = dec.install_prefill(cfg, cache, 0, st_a,
                                alloc.table[0, :alloc.pages_for(sp)])
    pc.register(toks[0], alloc.table[0])
    m, phys, _ = pc.match(toks[0, :-1])
    alloc.map_shared(1, phys)
    ok, cp = alloc.ensure_writable(1, m)
    assert ok
    if cp is not None:
        cache = dec.copy_phys_pages(cache, [cp])
    assert alloc.ensure(1, sp - 1)
    cache = dec.set_page_table(cfg, cache, alloc.table, alloc.ref)
    prefix = dec.gather_prefix_kv(cache, alloc.table[1], m)
    lg_b, st_b = dec.prefill_prompt(model, cfg, put(toks[:, m:]), max_len,
                                    prefix_kv=prefix)
    cache = dec.install_prefill(cfg, cache, 1, st_b,
                                alloc.table[1, :alloc.pages_for(sp)],
                                prefix_len=m)
    return m, alloc, cache, np.asarray(lg_a), np.asarray(lg_b)


@pytest.mark.parametrize("summary,rows", [("fp32", None), ("int8", None),
                                          ("fp32", 4)])
def test_hit_install_matches_reference(weights, summary, rows, monkeypatch):
    """The cache-hit handoff on both packages: equal pages and matched
    rows, logits within 1e-4, identical plan integer fields; and the
    port's own hit install bitwise equal to its miss install — the
    matched region, the summary-cache seed of fully matched blocks under
    both backends, and (the prefill running in aligned row blocks: one
    block, or with 4-row blocks a tail starting mid-block) the tail's
    rows, the logits and the plan too."""
    if rows is not None:
        monkeypatch.setattr(tdec, "PREFILL_ROWS", rows)
    params, model = weights
    jc, tc = _cfgs(summary=summary, replan=4)
    toks = np.random.default_rng(3).integers(0, jc.vocab_size,
                                             (1, 11)).astype(np.int32)
    jm, jal, jcache, jla, jlb = _hit_vs_miss(
        {"pg": jpg, "dec": jdec, "put": jnp.asarray,
         "cache": jdec.init_cache(jc, 2, 32)}, jc, params, toks)
    with torch.no_grad():
        tm, tal, tcache, tla, tlb = _hit_vs_miss(
            {"pg": tpg, "dec": tdec, "put": torch.from_numpy,
             "cache": tdec.init_cache(tc, 2, 32, device="cpu")},
            tc, model, toks)
    assert tm == jm == 10
    assert tal.table.tolist() == jal.table.tolist()
    assert tal.ref.tolist() == jal.ref.tolist()
    for got, want in ((tla, jla), (tlb, jlb)):
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(tlb, tla)
    kv, jkv = tcache["kv"], jcache["kv"]
    np.testing.assert_allclose(kv["k_pages"].numpy(),
                               np.asarray(jkv["k_pages"]), atol=ROW_ATOL,
                               rtol=0)
    for name in ("kv_indices", "kv_counts", "step"):
        np.testing.assert_array_equal(kv["plan"][name].numpy(),
                                      np.asarray(jkv["plan"][name]),
                                      err_msg=name)
    # the port's hit install against its own miss install
    view_k = tpg.logical_kv_view(kv["k_pages"][0], kv["page_table"][0])
    torch.testing.assert_close(view_k[1, :tm], view_k[0, :tm], rtol=0,
                               atol=0)
    torch.testing.assert_close(view_k[1, tm:11], view_k[0, tm:11], rtol=0,
                               atol=0)
    plan, page = kv["plan"], int(kv["k_pages"].shape[2])
    n_shared = tm // page
    fields = ("k_min", "k_max") + (("k_scale", "k_zero")
                                   if summary == "int8" else ())
    for name in fields:
        torch.testing.assert_close(plan[name][:, 1, :, :n_shared],
                                   plan[name][:, 0, :, :n_shared], rtol=0,
                                   atol=0, msg=name)
    for name in fields + ("kv_indices", "kv_counts", "step"):
        torch.testing.assert_close(plan[name][:, 1], plan[name][:, 0],
                                   rtol=0, atol=0, msg=name)
    # the page-summary cache holds the per-page recompute of full pages
    for lp in range(11 // page):
        ph = int(tal.table[0, lp])
        lo = kv["k_pages"][:, ph].float().amin(dim=1)
        hi = kv["k_pages"][:, ph].float().amax(dim=1)
        if summary == "int8":
            from repro_torch.core.decode_plan import quantize_summaries
            q_lo, q_hi, sc, zp = quantize_summaries(lo, hi)
            want = {"page_k_min": q_lo, "page_k_max": q_hi,
                    "page_k_scale": sc, "page_k_zero": zp}
        else:
            want = {"page_k_min": lo, "page_k_max": hi}
        for f, w in want.items():
            torch.testing.assert_close(kv[f][:, ph], w, rtol=0, atol=0,
                                       msg=f)


# ---------------------------------------------------------------------------
# serve(): the shared-prefix workloads against the reference
# ---------------------------------------------------------------------------

DEMO = dict(n_requests=6, batch_slots=3, gen_len=8, max_len=64,
            prompt_len=20, shared_prefix_len=16)
SERVES = {  # name: (seed, ServeOptions kwargs, config overrides)
    # examples/serve_topk.py::shared_prefix_demo
    "shared_prefix_demo": (0, DEMO, {}),
    # tests/test_prefix_cache.py::test_serve_prefix_cache_under_pool_pressure
    "pool_pressure": (1, dict(n_requests=5, batch_slots=2, gen_len=8,
                              max_len=64, prompt_len=16,
                              shared_prefix_len=8), {"pool_pages": 7}),
    # tests/test_prefix_cache.py::test_serve_lazy_cow_skips_eager_copies
    "lazy_cow": (0, dict(n_requests=6, batch_slots=3, gen_len=6,
                         max_len=64, prompt_len=20, shared_prefix_len=18),
                 {"lazy_cow": True}),
    # the demo through the summary-backend planner: int8 summaries,
    # sketch re-plans, the churn trigger and a 4-block plan
    "int8_sketch_auto": (0, DEMO, {"summary": "int8", "replan": "auto",
                                   "dec": dict(blocks=4,
                                               replan_mode="sketch",
                                               sketch_factor=2)}),
}
OCC_KEYS = ("pages_in_use_peak", "shared_pages_peak", "stalled_steps",
            "preemptions", "deferred_claims", "audits_run",
            "lazy_cow_skips", "host_swaps", "swap_restores",
            "requeue_preemptions", "host_swap_bytes_peak")
PREFIX_KEYS = ("requests", "hits", "prefill_tokens_saved", "cached_pages",
               "evictions", "prefill_tokens_total", "cow_copies",
               "shared_pages_peak")


def serve_pair(name, jcfg, tcfg):
    """The reference's and the port's ``serve()`` on workload ``name``
    with the seed's weights on both sides; also the port with the cache
    off on the same prompts."""
    seed, kw, _ = SERVES[name]
    params, model = _weights(seed)
    want = jsv.serve("qwen3-4b", smoke=True, cfg=jcfg, params=params,
                     seed=seed, options=jsv.ServeOptions(**kw))
    got = tsv.serve("qwen3-4b", smoke=True, cfg=tcfg, model=model,
                    seed=seed, options=tsv.ServeOptions(**kw), device="cpu")
    off = tsv.serve("qwen3-4b", smoke=True, model=model, seed=seed,
                    cfg=dataclasses.replace(tcfg, kv=dataclasses.replace(
                        tcfg.kv, prefix_cache=False, lazy_cow=False)),
                    options=tsv.ServeOptions(**kw), device="cpu")
    return want, got, off


def check_serve(want, got, off):
    assert got["outputs"] == want["outputs"]
    assert got["outputs"] == off["outputs"]
    assert got["steps"] == want["steps"]
    for k in PREFIX_KEYS:
        assert got["prefix_cache"][k] == want["prefix_cache"][k], k
    for k in OCC_KEYS:
        assert got["page_occupancy"][k] == want["page_occupancy"][k], k
    for k in ("kv_fetch_tiles_plan", "kv_fetch_tiles_dense",
              "plan_fetch_bytes", "replans", "summary_backend",
              "replan_mode"):
        assert got["decode_fetch"][k] == want["decode_fetch"][k], k


@pytest.mark.parametrize("name", sorted(SERVES))
def test_serve_prefix_cache_matches_reference(name):
    """The shared-prefix workloads — the example's, under pool pressure,
    with lazy copy-on-write, and through int8 summaries with sketch
    re-plans and the churn trigger.  Token streams, steps, the
    ``prefix_cache`` report's integer fields, the page occupancy (audits included: the same allocator
    mutations in the same order) and the fetch counters equal the
    reference's, and the cache leaves the port's outputs unchanged."""
    jc, tc = _cfgs(**SERVES[name][2])
    want, got, off = serve_pair(name, jc, tc)
    check_serve(want, got, off)
    p = got["prefix_cache"]
    assert p["hits"] > 0
    if name == "shared_prefix_demo":
        assert p["cow_copies"] > 0 and p["shared_pages_peak"] > 0
    if name == "pool_pressure":
        occ = got["page_occupancy"]
        assert (occ["stalled_steps"] + occ["deferred_claims"]
                + occ["preemptions"] + p["evictions"]) > 0
    if name == "lazy_cow":
        assert got["page_occupancy"]["lazy_cow_skips"] > 0
    if name == "int8_sketch_auto":
        f = got["decode_fetch"]
        assert f["summary_backend"] == "int8" and f["replans"] > 0
