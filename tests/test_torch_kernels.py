"""Port parity: the decode gather attention module.

On the CPU the port's ``kernels.ops.sata_decode_attention`` runs the
plain PyTorch version; the JAX side runs its Pallas kernel in interpret
mode, as the JAX tests do.  fp32, atol 1e-6: only the order of the fp32
dot-product and softmax sums differs.  The CUDA kernel itself is held
against the plain version by the ``cuda``-marked test (it runs on a GPU
machine and skips elsewhere) and by ``chip_smoke.py``."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import decode_plan as jdp  # noqa: E402
from repro.core.paging import PageAllocator as JAlloc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sata_decode as tsd  # noqa: E402

ATOL = 1e-6          # fp32 summation order (dots, softmax sums)


def _case(seed, g, *, b=3, kv=2, d=16, blk=8, s=64, pos=(63, 21, 5),
          topk=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    idx, cnt, thr = (np.array(a) for a in jdp.full_replan(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), topk_k=topk,
        k_block=blk, plan_blocks=s // blk))
    alloc = JAlloc(b * (s // blk) + 1, b, s // blk, blk, audit=False)
    for i in range(b):
        assert alloc.ensure(i, s - 1)
    kp = np.zeros((alloc.n_pages, blk, kv, d), np.float32)
    vp = np.zeros_like(kp)
    for i in range(b):
        for lp in range(s // blk):
            kp[alloc.table[i, lp]] = k[i, lp * blk:(lp + 1) * blk]
            vp[alloc.table[i, lp]] = v[i, lp * blk:(lp + 1) * blk]
    return dict(q=q, k=k, v=v, kp=kp, vp=vp, table=alloc.table.copy(),
                idx=idx, cnt=cnt, thr=thr, pos=pos, blk=blk)


def _jax(c, paged):
    k, v = (c["kp"], c["vp"]) if paged else (c["k"], c["v"])
    return np.asarray(jops.sata_decode_attention(
        jnp.asarray(c["q"]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(c["idx"]), jnp.asarray(c["cnt"]), jnp.asarray(c["thr"]),
        jnp.asarray(c["pos"]), k_block=c["blk"],
        page_table=jnp.asarray(c["table"]) if paged else None,
        interpret=True))


def _port(c, paged):
    k, v = (c["kp"], c["vp"]) if paged else (c["k"], c["v"])
    t = lambda n: torch.from_numpy(np.asarray(c[n]))  # noqa: E731
    return tops.sata_decode_attention(
        t("q"), torch.from_numpy(k), torch.from_numpy(v), t("idx"), t("cnt"),
        t("thr"), t("pos"), k_block=c["blk"],
        page_table=t("table") if paged else None)


VARIANTS = ["G1", "G2", "G4", "count0_padding", "pos_inside_page", "P0"]


@functools.cache
def _variant(name):
    """G in {1, 2, 4}, count-0 rows, padding slots past a shortened
    count, pos inside a page, P == 0 (built on first use, not while the
    module is collected)."""
    if name.startswith("G"):
        return _case(int(name[1:]), int(name[1:]))
    if name == "count0_padding":
        c = _case(7, 2)
        c["cnt"][0, 1] = 0                   # a row with no planned block
        c["cnt"][1, 0] = max(int(c["cnt"][1, 0]) - 2, 0)   # padding
        return c
    if name == "pos_inside_page":
        return _case(8, 2, pos=(12, 29, 50))
    c = _case(9, 2)
    c["idx"] = c["idx"][..., :0]
    return c


@pytest.mark.parametrize("name", VARIANTS)
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_decode_attention_matches_jax(name, paged):
    case = _variant(name)
    want = _jax(case, paged)
    got = _port(case, paged)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    if name == "count0_padding":
        assert (got.numpy()[0, 1] == 0).all()      # no planned block
    if name == "P0":
        assert (got.numpy() == 0).all()


@pytest.mark.parametrize("name", VARIANTS)
def test_paged_equals_contiguous_bitwise(name):
    case = _variant(name)
    assert torch.equal(_port(case, False), _port(case, True))


def test_decode_fetch_stats_identical():
    rng = np.random.default_rng(0)
    cnt = rng.integers(0, 6, (4, 3, 2))          # (L, B, KV)
    pos = np.array([7, 30, 61])
    kw = dict(k_block=8, d=16, dtype_bytes=4, nkb=8)
    for replan in (None, 1.0, 0.25, np.array([1.0, 0.0, 0.5])):
        want = jops.decode_fetch_stats(cnt, pos, replan=replan, **kw)
        got = tops.decode_fetch_stats(cnt, pos, replan=replan, **kw)
        assert got == want


def test_cuda_tensor_never_takes_the_plain_version():
    """The CUDA wrappers refuse CPU tensors instead of computing them,
    and a launch count moves only on a real launch."""
    c = _case(1, 2)
    t = lambda n: torch.from_numpy(np.asarray(c[n]))  # noqa: E731
    before = tsd.sata_decode_attention_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsd.sata_decode_attention_kernel(
            t("q"), t("k"), t("v"), t("idx"), t("cnt"), t("thr"), t("pos"),
            k_block=c["blk"])
    assert tsd.sata_decode_attention_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cuda_kernel_matches_plain_version(dtype, tol):
    """Needs a CUDA GPU (and nvcc): the hand-written kernel against its
    plain version on the card, both layouts, paged == contiguous
    bitwise.  Tolerances: fp32 summation order; bf16 output rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    for g in (1, 2, 4):
        c = _case(20 + g, g, d=64, blk=16, s=128, pos=(127, 40, 3))
        dev = {n: torch.from_numpy(np.asarray(c[n])).cuda()
               for n in ("q", "k", "v", "kp", "vp", "idx", "cnt", "thr",
                         "pos", "table")}
        for n in ("q", "k", "v", "kp", "vp"):
            dev[n] = dev[n].to(dt)
        outs = []
        for paged in (False, True):
            kk, vv = (dev["kp"], dev["vp"]) if paged else (dev["k"], dev["v"])
            got = tops.sata_decode_attention(
                dev["q"], kk, vv, dev["idx"], dev["cnt"], dev["thr"],
                dev["pos"], k_block=c["blk"],
                page_table=dev["table"] if paged else None)
            want = tsd.sata_decode_attention_ref(
                dev["q"], kk, vv, dev["idx"], dev["cnt"], dev["thr"],
                dev["pos"], k_block=c["blk"],
                page_table=dev["table"] if paged else None)
            torch.cuda.synchronize()
            assert float((got.float() - want.float()).abs().max()) <= tol
            outs.append(got)
        assert torch.equal(outs[0], outs[1])
