"""Port parity: the host state of fault-tolerant serving — ``FaultPlan``
schedules, the allocator's squeeze / swap / integrity operations, the
page payload gather / scatter and the plan-state capture / restore,
each against the JAX reference on the same seeded inputs.

Everything here is exact: schedules, allocator state (tables,
refcounts, free and squeezed lists, handles' pins, chunk pages and crc32
sums, audit counters), payload bytes and plan snapshots.  bf16 pools
travel as their 16-bit patterns, whose bytes (and so crc32 sums) equal
the reference's ml_dtypes bfloat16 payload's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.core import paging as jpg  # noqa: E402
from repro.launch.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models.config import KVCacheConfig as JKV  # noqa: E402
from repro.models.config import SataDecodeConfig as JDec  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.core import paging as tpg  # noqa: E402
from repro_torch.launch.faults import FaultPlan as TFaultPlan  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models.config import KVCacheConfig as TKV  # noqa: E402
from repro_torch.models.config import SataDecodeConfig as TDec  # noqa: E402


# ---------------------------------------------------------------------------
# FaultPlan: the same seed gives the same schedule in both packages
# ---------------------------------------------------------------------------

SEEDED = {  # name: (classmethod name, kwargs)
    "seeded_crash": ("seeded", dict(steps=40, slots=3, allow_crash=True)),
    "seeded_no_slots": ("seeded", dict(steps=24, n_events=8,
                                       max_squeeze=2)),
    "faults_demo": ("seeded", dict(steps=24, n_events=3, max_squeeze=2,
                                   slots=2)),
    "overload": ("seeded_overload", dict(steps=30)),
    "overload_corrupt": ("seeded_overload", dict(steps=24, n_spikes=3,
                                                 max_severity=3,
                                                 n_corrupt=2, n_slow=3)),
}


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_schedules_match_reference(name, seed):
    method, kw = SEEDED[name]
    want = getattr(JFaultPlan, method)(seed, **kw)
    got = getattr(TFaultPlan, method)(seed, **kw)
    assert got.describe() == want.describe()
    assert got._events == want._events
    assert (got.empty, got.has_crash, got.last_step) == \
        (want.empty, want.has_crash, want.last_step)
    for step in range(-1, want.last_step + 2):
        assert got.at(step) == want.at(step)


# ---------------------------------------------------------------------------
# Allocator: seeded sequences of fault operations on both packages
# ---------------------------------------------------------------------------

def _alloc_state(a):
    return {
        "table": a.table.tolist(), "n_mapped": a.n_mapped.tolist(),
        "ref": a.ref.tolist(), "free": list(a.free),
        "squeezed": list(a.squeezed),
        "peaks": (a.pages_in_use_peak, a.shared_pages_peak),
        "audits": (a.audits_run, a.light_audits_run),
        "handles": [(h["n_pages"], h["resident"].tolist(),
                     [list(lps) for lps, _ in h["chunks"]], h["sums"],
                     list(h["retired"])) for h in a.swapped],
    }


class _Side:
    """One package's allocator plus a synthetic host 'pool' (one fp32
    and one int8 row per physical page) that gather/scatter move."""

    def __init__(self, pg, n_pages, slots, audit, rows):
        self.pg = pg
        self.a = pg.PageAllocator(n_pages, slots, 8, 4, audit=audit)
        self.pool = {k: v.copy() for k, v in rows.items()}
        self.handles = []

    def gather(self, phys):
        return {k: v[phys] for k, v in self.pool.items()}

    def scatter(self, fresh, payload):
        for k in self.pool:
            self.pool[k][fresh] = payload[k]


def _rows(rng, n_pages):
    return {"rows": rng.standard_normal((n_pages, 4)).astype(np.float32),
            "codes": rng.integers(-128, 128, (n_pages, 4)).astype(np.int8)}


# operation: relative weight (swap-in twice as often: it needs an empty
# slot and free pages, so it fails to apply more often than the others)
OPS = {"ensure": 2, "append": 2, "map_shared": 1, "squeeze": 1,
       "unsqueeze": 1, "swap_out": 2, "swap_to_full": 1, "swap_in": 4,
       "discard": 1, "free": 1, "crash": 0.5}


def _apply(sd, op, slot, pos, n, empty, new_rows, audit):
    """One operation on one side; returns what the allocator returned."""
    a = sd.a
    if op == "ensure" and a.n_mapped[slot] == 0:
        return a.ensure(slot, pos)
    if op == "append" and 0 < a.n_mapped[slot] < a.max_pages:
        return a.ensure(slot, int(a.n_mapped[slot]) * a.page)
    if op == "map_shared" and empty and a.n_mapped[slot] > 0:
        k = int(a.n_mapped[slot])
        return a.map_shared(empty[0], [int(p) for p in a.table[slot, :k]])
    if op == "squeeze":
        return a.squeeze(n)
    if op == "unsqueeze":
        return a.unsqueeze()
    if op == "swap_out" and a.n_mapped[slot] > 0:
        sd.handles.append(a.swap_out(slot, sd.gather))
    elif op == "swap_to_full" and sd.handles:
        return a.swap_to_full(sd.handles[slot % len(sd.handles)], sd.gather)
    elif op == "swap_in" and sd.handles and empty:
        h = sd.handles[slot % len(sd.handles)]
        ok = a.swap_in(empty[0], h, sd.scatter)
        if ok:
            sd.handles.remove(h)
        return ok
    elif op == "discard" and sd.handles:
        return a.discard_handle(sd.handles.pop(slot % len(sd.handles)))
    elif op == "free" and a.n_mapped[slot] > 0:
        return a.free_slot(slot)
    elif op == "crash":
        # serve's crash path, allocator side: every live slot and handle
        # goes to host in full, the allocator is rebuilt around the
        # handles with the squeeze kept, and the pool's contents are lost
        for s in range(a.table.shape[0]):
            if a.n_mapped[s] > 0:
                sd.handles.append(a.swap_out(s, sd.gather))
        for h in sd.handles:
            a.swap_to_full(h, sd.gather)
        fresh = sd.pg.PageAllocator(a.n_pages, a.table.shape[0], 8, 4,
                                    audit=audit)
        fresh.swapped = a.swapped
        fresh.squeeze(len(a.squeezed))
        sd.a = fresh
        sd.pool = {k: v.copy() for k, v in new_rows.items()}
    return None


@pytest.mark.parametrize("audit", [True, "light"])
@pytest.mark.parametrize("seed", range(4))
def test_allocator_fault_ops_match_reference(seed, audit):
    """100 seeded operations (map, share, squeeze, swap out / to full /
    in, discard, free, and a crash that rebuilds the allocator around
    its handles) applied to both packages in lockstep: after every
    operation the return values and the whole host state are equal, the
    synthetic pools hold equal bytes (every swap round-trips), and the
    port's audit passes."""
    rng = np.random.default_rng(seed)
    n_pages, slots = int(rng.integers(8, 14)), 3
    rows = _rows(rng, n_pages)
    sides = [_Side(jpg, n_pages, slots, audit, rows),
             _Side(tpg, n_pages, slots, audit, rows)]
    weights = np.array(list(OPS.values()), float)
    weights /= weights.sum()
    seen = set()
    for _ in range(100):
        op = str(rng.choice(list(OPS), p=weights))
        slot, pos, n = (int(rng.integers(slots)), int(rng.integers(12)),
                        int(rng.integers(1, 4)))
        new_rows = _rows(rng, n_pages) if op == "crash" else None
        ref = sides[0].a
        empty = [s for s in range(slots) if ref.n_mapped[s] == 0]
        before = _alloc_state(ref)
        want, got = (_apply(sd, op, slot, pos, n, empty, new_rows, audit)
                     for sd in sides)
        assert got == want, op
        if _alloc_state(sides[0].a) != before:
            seen.add(op)
        assert _alloc_state(sides[1].a) == _alloc_state(sides[0].a), op
        for k in rows:
            np.testing.assert_array_equal(sides[1].pool[k], sides[0].pool[k])
        sides[1].a.check_invariants()
    assert {"swap_out", "swap_in"} <= seen, seen
    a = sides[1].a
    assert (a.audits_run, a.light_audits_run) == \
        (sides[0].a.audits_run, sides[0].a.light_audits_run)


# ---------------------------------------------------------------------------
# Page payloads and plan snapshots on real caches
# ---------------------------------------------------------------------------

POOL_FIELDS = ("k_pages", "v_pages", "page_k_min", "page_k_max",
               "page_k_scale", "page_k_zero")


def _cfgs(dtype="float32", summary="fp32"):
    """(JAX, port) qwen3-4b smoke configs, paged (8-token pages) with the
    prefix cache on, so the per-page summary arrays exist too."""
    out = []
    for smoke, dcls, kvc in ((JSMOKE, JDec, JKV), (TSMOKE, TDec, TKV)):
        base = smoke["qwen3-4b"]
        out.append(dataclasses.replace(
            base, topk_impl="bisect", dtype=dtype,
            sata=dataclasses.replace(base.sata, decode=dcls(
                mode="on", block=8, replan=4, summary=summary)),
            kv=kvc(layout="paged", pool_pages=8, prefix_cache=True)))
    return out


def _fill(rng, shape, dtype):
    """Seeded values for one array of ``dtype`` (a numpy dtype name)."""
    if dtype == "bool":
        return rng.random(shape) < 0.5
    if dtype == "int8":
        return rng.integers(-128, 128, shape).astype(np.int8)
    if dtype == "int32":
        return rng.integers(0, 4, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def _torch_to_jax(t):
    """A port tensor's exact bits as a JAX array (bf16 through its
    16-bit pattern)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _caches(dtype="float32", summary="fp32", batch=2, seed=0):
    """Both packages' serving caches holding the same seeded pool and
    plan values."""
    jc, tc = _cfgs(dtype, summary)
    jcache = jdec.init_cache(jc, batch, 32)
    tcache = tdec.init_cache(tc, batch, 32, device="cpu")
    rng = np.random.default_rng(seed)
    jkv = dict(jcache["kv"])
    tkv = tcache["kv"]
    for f in POOL_FIELDS:
        if f in tkv:
            vals = _fill(rng, tuple(tkv[f].shape),
                         "int8" if tkv[f].dtype == torch.int8 else "f32")
            tkv[f].copy_(torch.from_numpy(vals).to(tkv[f].dtype))
            jkv[f] = _torch_to_jax(tkv[f])
    jplan = dict(jkv["plan"])
    for name, t in tkv["plan"].items():
        t.copy_(torch.from_numpy(_fill(rng, tuple(t.shape),
                                       str(t.dtype).split(".")[1])))
        jplan[name] = jnp.asarray(t.numpy())
    jkv["plan"] = jplan
    return (jc, {**jcache, "kv": jkv}), (tc, tcache)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("summary", ["fp32", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_scatter_round_trip_matches_reference(dtype, summary):
    """``gather_phys_pages`` gives the reference's payload bit for bit
    (bf16 as its 16-bit pattern) with equal crc32 sums; the payload owns
    its bytes (zeroing the source pages leaves it); and
    ``scatter_phys_pages`` into other pages restores every field
    bitwise, as the reference's scatter does."""
    (jc, jcache), (tc, tcache) = _caches(dtype, summary)
    src, dst = [2, 5, 3], [6, 1, 4]
    want = jdec.gather_phys_pages(jcache, src)
    got = tdec.gather_phys_pages(tcache, src)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == _bits(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], _bits(want[k]), err_msg=k)
    assert tpg._payload_checksums(got) == jpg._payload_checksums(want)
    if dtype == "bfloat16":
        assert got["kv.k_pages"].dtype == np.int16
    kv = tcache["kv"]
    orig = {f: kv[f].clone() for f in POOL_FIELDS if f in kv}
    for f in orig:
        kv[f][:, src] = 0
    assert tpg._payload_checksums(got) == jpg._payload_checksums(want)
    tdec.scatter_phys_pages(tcache, dst, got)
    jrest = jdec.scatter_phys_pages(jcache, dst, want)
    for f, t in orig.items():
        assert torch.equal(kv[f][:, dst], t[:, src]), f
        np.testing.assert_array_equal(
            _bits(_torch_to_jax(kv[f][:, dst])),
            _bits(jrest["kv"][f][:, np.asarray(dst)]), err_msg=f)


def _shared_slot(pg, payload_of):
    """An allocator whose slot 1 maps one page shared with slot 0 and two
    private pages, swapped out: a handle with a resident pin and one
    payload chunk."""
    a = pg.PageAllocator(8, 2, 4, 8, audit=True)
    assert a.ensure(0, 20)
    a.map_shared(1, [int(a.table[0, 0])])
    assert a.ensure(1, 20)
    return a, a.swap_out(1, payload_of)


@pytest.mark.parametrize("field", POOL_FIELDS)
def test_flipped_byte_caught_before_swap_in(field):
    """One flipped byte in any payload array (bf16 K/V, int8 summaries)
    fails ``verify_handle`` with ``PageIntegrityError`` in both packages,
    and ``swap_in`` of the corrupted handle raises before changing the
    allocator; flipped back, the handle verifies and restores."""
    _, (tc, tcache) = _caches("bfloat16", "int8")

    def gather(phys):
        return tdec.gather_phys_pages(tcache, phys)

    for pg in (jpg, tpg):
        a, h = _shared_slot(pg, gather)
        assert h["resident"].tolist() == [int(a.table[0, 0]), -1, -1]
        assert [lps for lps, _ in h["chunks"]] == [[1, 2]]
        flat = h["chunks"][0][1][f"kv.{field}"].view(np.uint8).reshape(-1)
        flat[flat.size // 3] ^= 0x10
        with pytest.raises(pg.PageIntegrityError, match="checksum"):
            a.verify_handle(h)
        before = _alloc_state(a)
        with pytest.raises(pg.PageIntegrityError, match=f"kv.{field}"):
            a.swap_in(1, h, lambda fresh, payload: None)
        assert _alloc_state(a) == before
        flat[flat.size // 3] ^= 0x10
        a.verify_handle(h)
        assert a.swap_in(1, h, lambda fresh, payload: None)
        assert a.table[1, 0] == a.table[0, 0] and not a.swapped


@pytest.mark.parametrize("audit", ["full", "light"])
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_audit_catches_forged_resident_pin(pkg, audit):
    """A handle naming a page it never took a reference on breaks the
    refcount audit: the full audit counts per page, the light one the
    total."""
    pg = jpg if pkg == "jax" else tpg
    a, h = _shared_slot(pg, lambda phys: {"x": np.zeros(len(phys))})
    a.check_invariants()
    a._light_audit()
    h["resident"][1] = int(a.table[0, 1])
    with pytest.raises(AssertionError, match="refcount"):
        a.check_invariants() if audit == "full" else a._light_audit()


@pytest.mark.parametrize("summary", ["fp32", "int8"])
def test_plan_capture_restore_matches_reference(summary):
    """``capture_plan_state`` equals the reference's snapshot field for
    field; it is an owning copy (resetting and refilling the slot leaves
    it); and ``restore_plan_state`` into another slot lands it bitwise,
    as the reference's restore does, touching no other slot."""
    (jc, jcache), (tc, tcache) = _caches("float32", summary, batch=3)
    want = jdec.capture_plan_state(jc, jcache, 1)
    got = tdec.capture_plan_state(tc, tcache, 1)
    assert list(got) == list(want) == ["kv"]
    assert sorted(got["kv"]) == sorted(want["kv"])
    for name, w in want["kv"].items():
        assert got["kv"][name].dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(got["kv"][name], np.asarray(w), name)
    kept = {n: v.copy() for n, v in got["kv"].items()}
    plan = tcache["kv"]["plan"]
    tdec.reset_slot(tc, tcache, 1)
    rng = np.random.default_rng(9)
    for name, t in plan.items():
        t[:, 1] = torch.from_numpy(_fill(rng, tuple(t[:, 1].shape),
                                         str(t.dtype).split(".")[1]))
    for name, v in kept.items():
        np.testing.assert_array_equal(got["kv"][name], v, name)
    slot2 = {n: t[:, 2].clone() for n, t in plan.items()}
    tdec.restore_plan_state(tc, tcache, 0, got)
    jrest = jdec.restore_plan_state(jc, jcache, 0, want)["kv"]["plan"]
    for name, t in plan.items():
        np.testing.assert_array_equal(t[:, 0].numpy(), kept[name], name)
        np.testing.assert_array_equal(t[:, 0].numpy(),
                                      np.asarray(jrest[name])[:, 0], name)
        assert torch.equal(t[:, 2], slot2[name]), name
