"""The decode kernel past G = 8: qwen3-moe-235b-a22b groups 64 query
heads over 4 KV heads, so G = 16.

``launch_config`` must find a layout for every G in 1..16 whose size is
``csrc/sata_decode.cu``'s own (its ``make_layout`` compiled with the
host C++ compiler), and refuse G = 17 naming the shape.  The plain
version at G = 12 and 16 is held to the JAX Pallas kernel in interpret
mode and to the reference's pure-jnp top-k decode (fp32, atol 1e-6: the
order of the fp32 dot-product and softmax sums), and the CUDA kernel to
the plain version and to the plain model of its split over a cluster on
a GPU (the ``cuda``-marked test; fp32 1e-5, bf16 2e-2 and at most 1% of
the outputs off the model's bits, as ``chip_smoke.py``'s phase 2)."""
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

ATOL = 1e-6
SMEM_MAX = 232_448      # dynamic shared memory a block may use on an H100


def _case(seed, g, *, b=3, kv=2, d=16, blk=8, s=64, pos=(63, 21, 5),
          topk=4):
    """Random q/K/V, the reference planner's plan over them, and the
    same cache laid out as a page pool."""
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


def _args(c, paged, device="cpu", dtype=torch.float32):
    t = {n: torch.from_numpy(np.ascontiguousarray(c[n])).to(device)
         for n in ("q", "k", "v", "kp", "vp", "idx", "cnt", "thr", "pos",
                   "table")}
    for n in ("q", "k", "v", "kp", "vp"):
        t[n] = t[n].to(dtype)
    kk, vv = (t["kp"], t["vp"]) if paged else (t["k"], t["v"])
    return (t["q"], kk, vv, t["idx"], t["cnt"], t["thr"], t["pos"]), dict(
        k_block=c["blk"], page_table=t["table"] if paged else None)


def _layout_program(tmp_path):
    """``make_layout`` of the CUDA source as a host program reading
    shapes on stdin and printing each layout's bytes."""
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
    (tmp_path / "layout.cpp").write_text(prog)
    exe = tmp_path / "layout"
    subprocess.run([cxx, "-std=c++17", "-o", str(exe),
                    str(tmp_path / "layout.cpp")], check=True)
    return exe


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_config_fits_every_g_up_to_16(tmp_path, dtype):
    """At D 128 and page 64 (the serving widths), and at a few other
    widths and pages, every G in 1..16 gets a ring of at least two stages
    and a window of at least one chunk within the H100's shared memory
    (past G = 8, a block of a row split over a cluster: within half an
    SM's, so that two fit), and the CUDA source's layout has the same
    size."""
    exe = _layout_program(tmp_path)
    es = 4 if dtype == "float32" else 2
    cases, want = [], []
    for g, (d, kb) in itertools.product(
            range(1, 17), ((128, 64), (128, 128), (64, 16), (20, 48))):
        cfg = tsd.launch_config(g, d, kb, getattr(torch, dtype))
        limit = tsd.SMEM_SPLIT if tsd.tc_pv(g, es) else SMEM_MAX
        assert cfg.stages >= 2 and cfg.smem_bytes <= limit, (g, d, cfg)
        assert cfg.cluster == tsd.cluster_for(g, es), (g, cfg)
        assert cfg.chunk % kb == 0 or kb % cfg.chunk == 0, (g, d, cfg)
        assert cfg.win_blocks * kb >= max(cfg.chunk, kb), (g, d, cfg)
        cases.append((g, d, kb, es, cfg.chunk, cfg.stages, cfg.win_blocks,
                      cfg.v_rows))
        want.append(cfg.smem_bytes)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True, input="\n".join(
                             " ".join(map(str, c)) for c in cases))
    assert [int(x) for x in out.stdout.split()] == want


def test_g_up_to_8_keeps_its_layout():
    """The redesigns past G = 8 leave G <= 8's layout where it was: one
    head group and the PV product on the CUDA cores, so the row subsets,
    the final reduction and the staging of the serving shapes are those
    of before (G 4 D 128, G 1 D 64 and D 80, page 64, bf16), the scores
    at an odd head stride (no bank conflicts across heads); G = 1
    keeps one block a row, G 2..8 splits a row over a cluster of two
    with that same staging.  Past 8: two head groups on the CUDA cores
    in fp32 (a cluster of two) or the tensor cores in bf16 (a cluster of
    four, staged for two blocks an SM)."""
    for g in range(1, 9):
        assert tsd.head_groups(g) == 1 and not tsd.tc_pv(g, 2)
        for dt in (torch.bfloat16, torch.float32):
            assert tsd.launch_config(g, 128, 64, dt).cluster == (
                1 if g == 1 else 2)
    assert tsd.head_groups(9) == tsd.head_groups(16) == 2
    assert tsd.tc_pv(9, 2) and tsd.tc_pv(16, 2) and not tsd.tc_pv(16, 4)
    bf16 = torch.bfloat16
    # (chunk, stages, window, V rows) as before; the scores' odd head
    # stride adds G * 4 bytes (rounded to 16)
    assert tsd.launch_config(4, 128, 64, bf16) == tsd.LaunchConfig(
        192, 2, 45, 192, 231_024 + 16, 2)
    assert tsd.launch_config(1, 64, 64, bf16) == tsd.LaunchConfig(
        256, 3, 116, 384, 230_496 + 16, 1)
    assert tsd.launch_config(1, 80, 64, bf16) == tsd.LaunchConfig(
        256, 2, 156, 307, 231_008 + 16, 1)


@pytest.mark.parametrize("g", [17, 32])
def test_launch_config_refuses_a_g_past_the_kernel(g):
    with pytest.raises(ValueError, match=f"G={g}, D=128, k_block=64"):
        tsd.launch_config(g, 128, 64, torch.bfloat16)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("g", [12, 16])
def test_plain_version_matches_jax_past_g8(g, paged):
    """The plain version (what ``kernels.ops`` runs for CPU tensors) at
    G = 12 and 16 against the reference's Pallas kernel in interpret
    mode, both layouts; paged == contiguous bitwise."""
    c = _case(40 + g, g, pos=(63, 30, 9))
    k, v = (c["kp"], c["vp"]) if paged else (c["k"], c["v"])
    want = np.asarray(jops.sata_decode_attention(
        jnp.asarray(c["q"]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(c["idx"]), jnp.asarray(c["cnt"]), jnp.asarray(c["thr"]),
        jnp.asarray(c["pos"]), k_block=c["blk"],
        page_table=jnp.asarray(c["table"]) if paged else None,
        interpret=True))
    args, kw = _args(c, paged)
    got = tops.sata_decode_attention(*args, **kw)
    assert got.shape == want.shape == (3, 2, g, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    other, kw2 = _args(c, not paged)
    assert torch.equal(got, tops.sata_decode_attention(*other, **kw2))


@pytest.mark.parametrize("g", [12, 16])
def test_plain_version_past_g8_equals_the_jnp_oracle(monkeypatch, g):
    """With a full re-plan over every block, the plain version at G = 12
    and 16 equals the reference's pure-jnp dense top-k decode (the
    oracle of ``benchmarks/bench_decode.py``'s ``decode/parity_vs_jnp``
    row) within ATOL, on both layouts."""
    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).parents[1]))
    from benchmarks.bench_decode import _jnp_topk_decode
    c = _case(80 + g, g, pos=(63, 17, 40))
    want = np.asarray(_jnp_topk_decode(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["pos"]), 4))
    for paged in (False, True):
        args, kw = _args(c, paged)
        got = tops.sata_decode_attention(*args, **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cuda_kernel_matches_plain_version_past_g8(dtype, tol):
    """Needs a CUDA GPU (and nvcc): the kernel at G = 12 and 16 against
    its plain version, small widths and the serving widths (D 128, page
    64), both layouts, paged == contiguous bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    cases = [_case(60 + g, g, d=64, blk=16, s=128, pos=(127, 40, 3))
             for g in (12, 16)]
    cases.append(_case(77, 16, b=2, kv=2, d=128, blk=64, s=256,
                       pos=(200, 90), topk=16))
    for c in cases:
        outs = []
        for paged in (False, True):
            args, kw = _args(c, paged, "cuda", dt)
            got = tops.sata_decode_attention(*args, **kw)
            want = tsd.sata_decode_attention_ref(*args, **kw)
            model = tsd.sata_decode_attention_ref(
                *args, splits=tsd.launch_config(
                    args[0].shape[2], args[0].shape[3], c["blk"],
                    dt).cluster, **kw)
            torch.cuda.synchronize()
            for w in (want, model):
                assert float((got.float() - w.float()).abs().max()) <= tol
            if dt == torch.bfloat16:
                assert float((got != model).float().mean()) <= 0.01
            outs.append(got)
        assert torch.equal(outs[0], outs[1])
