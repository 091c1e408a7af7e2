"""Port parity: cascade retirement below ``serve()`` — the allocator's
holes (``retire_compact`` with pinned pages skipped and swapped
requests untouched, holes through ``swap_out`` / ``swap_in`` and
``swap_to_full``, ``check_invariants`` and the light audit), the plan
repair ``retire_plan_blocks`` for both summary backends, the
retirement state through ``capture_plan_slot`` / ``install_plan_slot``,
the retirement-free plan, the decode step's importance update and live
masks, ``retire_phys_pages`` and the live-block pricing of
``decode_fetch_stats``.

The two allocators run in lockstep on the same operations and their
host state must be EQUAL after each one (tables, refcounts, free lists,
holes, handles); plan fields are held bitwise, thresholds to 1e-6 of
the threshold scale (fp32 score summation order), as in
``test_torch_decode_plan.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.core import decode_plan as jdp  # noqa: E402
from repro.core import paging as jpg  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.core import decode_plan as tdp  # noqa: E402
from repro_torch.core import paging as tpg  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402

THR_RTOL = 1e-6
B, KV, G, D, BLK, S = 3, 2, 2, 16, 8, 64
NKB = S // BLK
TOPK = 5


# ---------------------------------------------------------------------------
# Allocators in lockstep
# ---------------------------------------------------------------------------

class Pair:
    """The reference's and the port's allocator driven by the same
    calls; every call's result and the host state after it must be
    equal."""

    def __init__(self, *args, trie=False, **kw):
        self.j = jpg.PageAllocator(*args, **kw)
        self.t = tpg.PageAllocator(*args, **kw)
        self.tries = ((jpg.PrefixCache(self.j), tpg.PrefixCache(self.t))
                      if trie else None)

    def __call__(self, name, *args, **kw):
        want = getattr(self.j, name)(*args, **kw)
        got = getattr(self.t, name)(*args, **kw)
        if not isinstance(want, dict):
            assert got == want, (name, got, want)
        self.same()
        return got, want

    def same(self):
        j, t = self.j, self.t
        np.testing.assert_array_equal(t.table, j.table)
        np.testing.assert_array_equal(t.n_mapped, j.n_mapped)
        np.testing.assert_array_equal(t.ref, j.ref)
        assert t.free == j.free and t.squeezed == j.squeezed
        assert t.retired == j.retired
        assert t.pages_retired == j.pages_retired
        assert [(h["n_pages"], list(h["resident"]), list(h["retired"]))
                for h in t.swapped] == \
            [(h["n_pages"], list(h["resident"]), list(h["retired"]))
             for h in j.swapped]


def test_retire_compact_frees_pages_and_leaves_holes():
    a = Pair(12, 2, 8, 4, audit=True)
    a("ensure", 0, 15)                            # 4 pages mapped
    row = a.t.table[0].copy()
    before = a.t.free_pages
    (freed, skipped), _ = a("retire_compact", 0, [0, 2])
    assert sorted(freed) == sorted([int(row[0]), int(row[2])])
    assert skipped == [] and a.t.free_pages == before + 2
    assert a.t.table[0, 0] == a.t.table[0, 2] == tpg.OVERFLOW_PAGE
    assert int(a.t.n_mapped[0]) == 4 and a.t.retired[0] == {0, 2}
    a("ensure", 0, 16)                            # holes never remap
    assert a.t.table[0, 0] == tpg.OVERFLOW_PAGE
    for alloc in (a.j, a.t):
        with pytest.raises(AssertionError, match="already retired"):
            alloc.retire_compact(0, [0])
    a("free_slot", 0)
    assert a.t.retired[0] == set() and a.t.free_pages == 11
    assert a.t.stats(row_bytes=1)["pages_retired"] == 2


def test_retire_compact_skips_pinned_pages():
    """A page the trie retains or another slot maps is skipped."""
    a = Pair(12, 2, 8, 4, audit=True, trie=True)
    a("ensure", 0, 11)                            # 3 pages
    row = a.t.table[0].copy()
    for tr in a.tries:
        tr.register(np.arange(8), row)            # trie retains pages 0-1
    a("map_shared", 1, [int(row[2])])             # slot 1 shares page 2
    (freed, skipped), _ = a("retire_compact", 0, [0, 1, 2])
    assert freed == [] and skipped == [0, 1, 2]
    a("free_slot", 1)
    (freed, skipped), _ = a("retire_compact", 0, [0, 2])
    assert freed == [int(row[2])] and skipped == [0]


def test_retire_compact_never_touches_swapped_requests():
    """A swapped request's resident pin blocks retirement of the page
    it shares; its own pages have no table row to be named through."""
    a = Pair(12, 2, 8, 4, audit=True)
    a("ensure", 0, 7)
    shared = int(a.t.table[0, 0])
    a("map_shared", 1, [shared])
    a("swap_out", 1, lambda phys: {})
    (freed, skipped), _ = a("retire_compact", 0, [0, 1])
    assert skipped == [0] and shared not in freed and len(freed) == 1
    ok_j = a.j.swap_in(1, a.j.swapped[0], lambda f, p: None)
    ok_t = a.t.swap_in(1, a.t.swapped[0], lambda f, p: None)
    assert ok_j and ok_t
    a.same()
    assert int(a.t.table[1, 0]) == shared


@pytest.mark.parametrize("to_full", [False, True])
def test_holes_roundtrip_host_swap(to_full):
    """Holes move nothing at ``swap_out``, ride the handle, survive
    ``swap_to_full`` (the crash path, into a fresh allocator) and are
    holes again after ``swap_in``; the surviving pages' payload lands."""
    stores = {}

    def io(key):
        store = stores.setdefault(key, {})

        def gather(phys):
            return {"x": np.asarray([store[p] for p in phys], np.int64)}

        def scatter(fresh, payload):
            for p, v in zip(fresh, payload["x"]):
                store[p] = int(v)
        return store, gather, scatter

    a = Pair(12, 2, 8, 4, audit=True)
    a("ensure", 0, 15)
    a("map_shared", 1, [int(a.t.table[0, 3])])    # logical page 3 is shared
    allocs = {"j": a.j, "t": a.t}
    for key, alloc in allocs.items():
        store, _, _ = io(key)
        for lp in range(4):
            store[int(alloc.table[0, lp])] = 100 + lp
    a("retire_compact", 0, [1])
    handles = {k: alloc.swap_out(0, io(k)[1]) for k, alloc in allocs.items()}
    a.same()
    assert handles["t"]["retired"] == [1]
    assert handles["t"]["resident"].tolist() == [-1, -1, -1,
                                                 int(a.t.table[1, 0])]
    if to_full:
        for k, alloc in allocs.items():
            alloc.swap_to_full(handles[k], io(k)[1])
            alloc.free_slot(1)
            fresh = type(alloc)(12, 2, 8, 4, audit=True)
            fresh.swapped = alloc.swapped
            allocs[k] = fresh
        a.j, a.t = allocs["j"], allocs["t"]
        a.same()
    for k, alloc in allocs.items():
        assert alloc.swap_in(0, handles[k], io(k)[2])
    a.same()
    assert a.t.retired[0] == {1} and a.t.table[0, 1] == tpg.OVERFLOW_PAGE
    store = stores["t"]
    assert sorted(store[int(a.t.table[0, lp])] for lp in (0, 2, 3)) == \
        [100, 102, 103]
    a.t.check_invariants()


def _drive(seed: int, n_ops: int, audit) -> None:
    """The reference's random claim / append / retire / swap / free /
    pressure schedule through both allocators in lockstep."""
    rng = np.random.default_rng(seed)
    a = Pair(14, 3, 8, 4, audit=audit)
    pos = np.full(3, -1, np.int64)
    handles = {}

    def live_lps(i):
        return [lp for lp in range(int(a.t.n_mapped[i]))
                if lp not in a.t.retired[i]]

    for _ in range(n_ops):
        op = int(rng.integers(0, 6))
        i = int(rng.integers(0, 3))
        if op == 0:
            if i in handles:
                continue
            nxt = int(pos[i]) + int(rng.integers(1, 6))
            ok, _ = a("ensure", i, max(nxt, 0))
            if ok:
                pos[i] = max(nxt, int(pos[i]))
        elif op == 1 and pos[i] >= 0 and i not in handles:
            cand = [lp for lp in live_lps(i) if lp < int(pos[i]) // 4]
            if cand:
                n = int(rng.integers(1, len(cand) + 1))
                picks = [int(x) for x in rng.choice(cand, size=n,
                                                    replace=False)]
                a("retire_compact", i, picks)
        elif op == 2 and pos[i] >= 0 and i not in handles:
            if a.t.n_mapped[i] > 0:
                hj = a.j.swap_out(i, lambda phys: {"x": np.asarray(phys)})
                ht = a.t.swap_out(i, lambda phys: {"x": np.asarray(phys)})
                handles[i] = (hj, ht)
                a.same()
                pos[i] = -1
        elif op == 3 and i in handles:
            hj, ht = handles[i]
            ok_j = a.j.swap_in(i, hj, lambda f, p: None)
            ok_t = a.t.swap_in(i, ht, lambda f, p: None)
            assert ok_j == ok_t
            a.same()
            if ok_t:
                handles.pop(i)
                pos[i] = ht["n_pages"] * 4 - 1
        elif op == 4 and pos[i] >= 0 and i not in handles:
            a("free_slot", i)
            pos[i] = -1
        elif op == 5:
            if rng.integers(0, 2):
                a("squeeze", int(rng.integers(1, 3)))
            else:
                a("unsqueeze")
    a.j.check_invariants()
    a.t.check_invariants()
    assert a.t.audits_run == a.j.audits_run
    assert a.t.light_audits_run == a.j.light_audits_run


@pytest.mark.parametrize("audit", [True, "light"])
@pytest.mark.parametrize("seed", range(6))
def test_random_retire_schedules_in_lockstep(seed, audit):
    _drive(seed, 60, audit)


def test_audits_catch_a_mapped_hole():
    """A hole that still maps a page, or a hole whose page is freed
    without the bookkeeping, fails both packages' audits."""
    for mod in (jpg, tpg):
        a = mod.PageAllocator(12, 2, 8, 4)
        a.ensure(0, 15)
        a.retire_compact(0, [1])
        a.table[0, 1] = a.free[-1]
        with pytest.raises(AssertionError, match="retired logical page"):
            a.check_invariants()
        b = mod.PageAllocator(12, 2, 8, 4)
        b.ensure(0, 15)
        b.retired[0].add(2)                   # marked, never freed
        b.table[0, 2] = mod.OVERFLOW_PAGE
        with pytest.raises(AssertionError):
            b._light_audit()


# ---------------------------------------------------------------------------
# Plan state
# ---------------------------------------------------------------------------

def _seeded_plan(summary, seed=0):
    """A retire plan whose slot 0 plans blocks {0, 2, 5}, with bounded
    summaries and nonzero importance everywhere — both packages."""
    rng = np.random.default_rng(seed)
    jp = jdp.init_decode_plan(2, 2, 64, 8, 8, summary=summary, retire=True)
    occ = np.zeros((2, 2, NKB), bool)
    occ[0, :, [0, 2, 5]] = True
    occ[1] = rng.random((2, NKB)) < 0.5
    idx, cnt = jdp._compact_rows(jnp.asarray(occ),
                                 jp["kv_indices"].shape[-1])
    jp.update(kv_indices=idx.astype(jnp.int32), kv_counts=cnt.astype(
        jnp.int32), imp=jnp.asarray(rng.random((2, 2, NKB)), jnp.float32))
    if summary == "int8":
        jp.update(k_min=jnp.asarray(rng.integers(-9, 0, (2, 2, NKB, 8)),
                                    jnp.int8),
                  k_max=jnp.asarray(rng.integers(0, 9, (2, 2, NKB, 8)),
                                    jnp.int8),
                  k_scale=jnp.asarray(rng.random((2, 2, NKB)), jnp.float32),
                  k_zero=jnp.asarray(rng.random((2, 2, NKB)), jnp.float32))
    else:
        jp.update(k_min=jnp.zeros_like(jp["k_min"]),
                  k_max=jnp.ones_like(jp["k_max"]))
    return jp, {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}


@pytest.mark.parametrize("summary", ["fp32", "int8"])
def test_retire_plan_blocks(summary):
    """Dead blocks leave ``live_blk`` and the plan, their importance is
    zeroed and their summaries take the backend's empty sentinel; the
    other slot is untouched — equal to the reference field by field."""
    jp, tp = _seeded_plan(summary)
    before = {n: v[1].clone() for n, v in tp.items()}
    want = jdp.retire_plan_blocks(jp, 0, [2, 5])
    got = tdp.retire_plan_blocks(tp, 0, [2, 5])
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
        assert torch.equal(got[name][1], before[name]), name
    occ = tdp._plan_occupancy(got["kv_indices"], got["kv_counts"], NKB)
    assert occ[0, 0].tolist() == [True] + [False] * 7


def test_retire_plan_blocks_layer_stacked():
    """``batch_axis=1`` on an (L, B, ...) state, as ``retire_plan``
    applies it to every layer."""
    pairs = [_seeded_plan("fp32", seed) for seed in range(3)]
    jp = {n: jnp.stack([p[0][n] for p in pairs]) for n in pairs[0][0]}
    tp = {n: torch.stack([p[1][n] for p in pairs]) for n in pairs[0][1]}
    want = jdp.retire_plan_blocks(jp, 1, [0, 3], batch_axis=1)
    got = tdp.retire_plan_blocks(tp, 1, [0, 3], batch_axis=1)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


def test_retire_state_rides_plan_slot_capture():
    """``imp`` / ``live_blk`` belong to the request: a capture and an
    install into another slot carry them, as the reference's do."""
    jp, tp = _seeded_plan("fp32")
    jp = jdp.retire_plan_blocks(jp, 0, [1, 4])
    tdp.retire_plan_blocks(tp, 0, [1, 4])
    jsnap, tsnap = jdp.capture_plan_slot(jp, 0), tdp.capture_plan_slot(tp, 0)
    assert sorted(tsnap) == sorted(jsnap)
    for n in jsnap:
        np.testing.assert_array_equal(tsnap[n], jsnap[n], err_msg=n)
    back = tdp.install_plan_slot(
        tdp.init_decode_plan(2, 2, 64, 8, 8, device="cpu", retire=True),
        1, tsnap)
    assert torch.equal(back["live_blk"][1], tp["live_blk"][0])
    assert torch.equal(back["imp"][1], tp["imp"][0])
    tdp.reset_plan_slot(back, 1)
    assert back["live_blk"][1].all() and not back["imp"][1].any()


def _cfg(smoke, **retire):
    base = smoke["qwen3-4b"]
    return dataclasses.replace(base, topk_impl="bisect", sata=dataclasses.replace(
        base.sata, decode=dataclasses.replace(base.sata.decode, mode="on",
                                              block=8, replan=1),
        retire=dataclasses.replace(base.sata.retire, **retire)),
        kv=dataclasses.replace(base.kv, layout="paged"))


def test_retire_off_plan_has_no_retire_state():
    """Retirement off: neither package's plan carries ``imp`` or
    ``live_blk``; on, both do, with equal contents."""
    assert "imp" not in tdp.init_decode_plan(2, 2, 64, 8, 8, device="cpu")
    for mode in ("off", "on"):
        jc = jattn.init_kv_cache(_cfg(JSMOKE, mode=mode), 2, 64, jnp.float32)
        tc = tattn.init_kv_cache(_cfg(TSMOKE, mode=mode), 2, 64,
                                 torch.float32, device="cpu")
        assert sorted(tc["plan"]) == sorted(jc["plan"])
        assert ("live_blk" in tc["plan"]) == (mode == "on")
        for n in jc["plan"]:
            np.testing.assert_array_equal(tc["plan"][n].numpy(),
                                          np.asarray(jc["plan"][n]))


@pytest.mark.parametrize("mode", ["exact", "sketch", "incremental"])
def test_decode_step_masks_retired_blocks(mode):
    """The decode step over a plan with retired blocks: no planner names
    a retired block (their pages map the overflow page), and the plan,
    the thresholds and the importance update equal the reference's."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    pos = np.asarray([63, 44, 30], np.int32)
    jp = jdp.init_decode_plan(B, KV, S, D, BLK, retire=True)
    lo, hi = jdp.summaries_from_cache(jnp.asarray(k), jnp.asarray(pos),
                                      k_block=BLK)
    jp.update(k_min=lo, k_max=hi, step=jnp.ones((B,), jnp.int32),
              imp=jnp.asarray(rng.random((B, KV, NKB)), jnp.float32))
    for slot, blocks in ((0, [1, 2, 6]), (1, [0, 3])):
        jp = jdp.retire_plan_blocks(jp, slot, blocks)
    tp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    kw = {"exact": {}, "sketch": {"replan_mode": "sketch",
                                  "replan_interval": 1},
          "incremental": {"replan_interval": 4}}[mode]
    jp, jthr = jdp.decode_plan_update(jp, jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(pos), topk_k=TOPK,
                                      k_block=BLK, retire_decay=0.8, **kw)
    tp, tthr = tdp.decode_plan_update(tp, *[torch.from_numpy(a)
                                            for a in (q, k, pos)],
                                      topk_k=TOPK, k_block=BLK,
                                      retire_decay=0.8, **kw)
    for n in ("kv_indices", "kv_counts", "live_blk", "step", "replans"):
        np.testing.assert_array_equal(tp[n].numpy(), np.asarray(jp[n]),
                                      err_msg=n)
    np.testing.assert_allclose(tthr.numpy(), np.asarray(jthr),
                               rtol=THR_RTOL,
                               atol=THR_RTOL * float(np.abs(jthr).max()))
    np.testing.assert_array_equal(tp["imp"].numpy(), np.asarray(jp["imp"]))
    occ = tdp._plan_occupancy(tp["kv_indices"], tp["kv_counts"], NKB)
    assert not (occ & ~tp["live_blk"][:, None, :]).any()


@pytest.mark.parametrize("summary", ["fp32", "int8"])
def test_retire_phys_pages(summary):
    """Freed pages' K/V rows zeroed and page-summary rows at the empty
    sentinel in every layer; other pages untouched — equal to the
    reference's scrub."""
    def cfg(smoke):
        c = _cfg(smoke)
        return dataclasses.replace(
            c, sata=dataclasses.replace(c.sata, decode=dataclasses.replace(
                c.sata.decode, summary=summary)),
            kv=dataclasses.replace(c.kv, prefix_cache=True))
    jcache = jdec.init_cache(cfg(JSMOKE), 2, 64)
    tcache = tdec.init_cache(cfg(TSMOKE), 2, 64, device="cpu")
    rng = np.random.default_rng(2)
    kv = jcache["kv"]
    for name in ("k_pages", "v_pages", "page_k_min", "page_k_max",
                 "page_k_scale", "page_k_zero"):
        if name in kv:
            a = np.asarray(kv[name])
            v = (rng.integers(-5, 5, a.shape) if a.dtype == np.int8
                 else rng.standard_normal(a.shape)).astype(a.dtype)
            kv = {**kv, name: jnp.asarray(v)}
            tcache["kv"][name].copy_(torch.from_numpy(np.asarray(v)))
    jcache = jdec.retire_phys_pages({**jcache, "kv": kv}, [3, 7])
    tdec.retire_phys_pages(tcache, [3, 7])
    for name, want in jcache["kv"].items():
        if name in ("plan",):
            continue
        np.testing.assert_array_equal(tcache["kv"][name].numpy(),
                                      np.asarray(want), err_msg=name)
    assert not tcache["kv"]["k_pages"][:, [3, 7]].any()


# ---------------------------------------------------------------------------
# Live-block pricing
# ---------------------------------------------------------------------------

def test_fetch_stats_live_blocks_pricing():
    """The reference test's pins, and equality with the reference at
    every argument mix."""
    cnt = np.asarray([[2, 2], [3, 3]])
    pos = np.asarray([31, 47])
    kw = dict(k_block=8, d=16, replan=np.asarray([1.0, 0.0]), nkb=8,
              dtype_bytes=4)
    base = tops.decode_fetch_stats(cnt, pos, **kw)
    assert tops.decode_fetch_stats(cnt, pos, live_blocks=np.asarray([8, 8]),
                                   **kw) == base
    out = tops.decode_fetch_stats(cnt, pos, live_blocks=np.asarray([2, 5]),
                                  **kw)
    k_tile = 8 * 16 * 4
    assert out["plan_fetch_bytes_step"] == (2 * 2 * k_tile
                                            + tdp.summary_bytes(5, 16) * 2
                                            + 6 * k_tile)
    for extra in ({}, {"quant": np.asarray([True, False])},
                  {"replan_mode": "sketch", "plan_blocks": 4},
                  {"sketch": np.asarray([True, False]), "summary": "int8"}):
        args = dict(kw, live_blocks=np.asarray([2, 5]), **extra)
        assert tops.decode_fetch_stats(cnt, pos, **args) == \
            jops.decode_fetch_stats(cnt, pos, **args), extra
