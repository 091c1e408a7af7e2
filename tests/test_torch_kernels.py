"""Port parity: the decode gather attention module.

On the CPU the port's ``kernels.ops.sata_decode_attention`` runs the
plain PyTorch version; the JAX side runs its Pallas kernel in interpret
mode, as the JAX tests do.  fp32, atol 1e-6: only the order of the fp32
dot-product and softmax sums differs.  The CUDA kernel itself is held
against the plain version by the ``cuda``-marked test (it runs on a GPU
machine and skips elsewhere) and by ``chip_smoke.py``."""
import functools
import itertools
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
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


@functools.cache
def _serving_case():
    """The serving shape's widths (G 4, D 128, page 64) at a small B and
    S: 2 slots x 2 KV heads over 4 pages, top-k 16."""
    return _case(3, 4, b=2, kv=2, d=128, blk=64, s=256, pos=(200, 90), topk=16)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax_serving_widths(dtype, paged):
    """The plain version against the Pallas kernel (interpret mode) at the
    serving widths.  fp32: ATOL (summation order over D = 128); bf16:
    both sides round the same fp32 sums to bf16, so they differ by at
    most one bf16 step (2^-8 relative) where the order moves a sum across
    a rounding boundary."""
    c = dict(_serving_case())
    if dtype == "bfloat16":
        for n in ("q", "k", "v", "kp", "vp"):
            c[n] = np.asarray(jnp.asarray(c[n]).astype(jnp.bfloat16))
    want = np.asarray(_jax(c, paged), np.float32)
    k, v = (c["kp"], c["vp"]) if paged else (c["k"], c["v"])
    dt = getattr(torch, dtype)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    f = lambda a: t(np.asarray(a, np.float32)).to(dt)  # noqa: E731
    got = tops.sata_decode_attention(
        f(c["q"]), f(k), f(v), t(c["idx"]), t(c["cnt"]), t(c["thr"]),
        t(c["pos"]), k_block=c["blk"],
        page_table=t(c["table"]) if paged else None)
    assert got.dtype == dt and got.shape == want.shape
    rtol = 0 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL,
                               rtol=rtol)


@pytest.mark.parametrize("k_block", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_config_fits(dtype, k_block):
    """Every shape the wrapper takes gets a ring of at least two stages
    in the 232,448 bytes of shared memory a block may use on an H100,
    a chunk of whole k-blocks or a divisor of one, and a window that
    holds at least one chunk."""
    for g, d in itertools.product(range(1, 9), (16, 32, 64, 128)):
        cfg = tsd.launch_config(g, d, k_block, getattr(torch, dtype))
        assert cfg.stages >= 2 and cfg.smem_bytes <= 232_448, cfg
        assert cfg.chunk % k_block == 0 or k_block % cfg.chunk == 0, cfg
        assert cfg.win_blocks * k_block >= max(cfg.chunk, k_block), cfg
        assert cfg.v_rows >= 1, cfg


def test_smem_layout_matches_the_cuda_source(tmp_path):
    """``smem_bytes`` is the byte count of ``csrc/sata_decode.cu``'s
    ``make_layout``: its host part is compiled with the host C++ compiler
    and both are compared over every launch_config shape, those of a row
    split over a cluster (G 12 and 16: the tensor cores' PV in bf16)
    included."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    src = (pathlib.Path(tsd.__file__).parent / "csrc" /
           "sata_decode.cu").read_text()
    a = src.index("__host__ __device__ constexpr int threads_for")
    b = src.index("  return L;\n}\n", a) + len("  return L;\n}\n")
    prog = ("#define __host__\n#define __device__\n#include <cstdio>\n"
            + src[a:b] + """
int main() {
  int v[8];
  while (scanf("%d %d %d %d %d %d %d %d", v, v + 1, v + 2, v + 3, v + 4,
               v + 5, v + 6, v + 7) == 8)
    printf("%d\\n", make_layout(v[0], v[1], v[2], v[3], v[4], v[5], v[6],
                                 v[7]).total);
}
""")
    cases, want = [], []
    for dtype, d, kb, g in itertools.product(
            ("float32", "bfloat16"), (9, 16, 20, 64, 128), (8, 48, 64, 128),
            (1, 3, 4, 8, 12, 16)):
        cfg = tsd.launch_config(g, d, kb, getattr(torch, dtype))
        es = 4 if dtype == "float32" else 2
        cases.append((g, d, kb, es, cfg.chunk, cfg.stages, cfg.win_blocks,
                      cfg.v_rows))
        want.append(cfg.smem_bytes)
    (tmp_path / "layout.cpp").write_text(prog)
    exe = tmp_path / "layout"
    subprocess.run([cxx, "-std=c++17", "-o", str(exe),
                    str(tmp_path / "layout.cpp")], check=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True, input="\n".join(
                             " ".join(map(str, c)) for c in cases))
    assert [int(x) for x in out.stdout.split()] == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cuda_kernel_matches_plain_version(dtype, tol):
    """Needs a CUDA GPU (and nvcc): the hand-written kernel against its
    plain version on the card, both layouts, paged == contiguous
    bitwise, at small widths and at the serving widths (with a count-0
    row and P == 0 there).  Tolerances: fp32 summation order; bf16
    output rounding, and at most 1% of the bf16 outputs off the plain
    version's bits (the kernel sums in another order, which flips ~0.1%
    of the roundings; a fault in the predicate or the p rounding moves
    far more)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    cases = [_case(20 + g, g, d=64, blk=16, s=128, pos=(127, 40, 3))
             for g in (1, 2, 4)]
    serving = dict(_serving_case())
    serving["cnt"] = serving["cnt"].copy()
    serving["cnt"][1, 0] = 0                       # a row with no block
    p0 = dict(serving)
    p0["idx"] = p0["idx"][..., :0]                 # P == 0
    for c in cases + [serving, p0]:
        dev = {n: torch.from_numpy(np.ascontiguousarray(c[n])).cuda()
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
            if dt == torch.bfloat16:
                assert float((got != want).float().mean()) <= 0.01
            outs.append(got)
        assert torch.equal(outs[0], outs[1])
        if c is serving:
            assert not outs[0][1, 0].any()        # the count-0 row
        if c is p0:
            assert not outs[0].any()
