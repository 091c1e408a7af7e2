"""Port parity for context-parallel decode: ``make_serve_step(cfg,
mesh=)`` over the reference's sequence-split serving cache
(``CACHE_SEQ_SHARD``), where a rank of a ("data", "model") mesh holds
its contiguous 1/m of every slot's keys, plans and attends over them,
and the ranks' partials combine (``tests/torch_cp_decode_ranks.py``).

World 2 runs every case on (1, 2), world 4 on (2, 2) and (1, 4), each
started once for the module through a ``FileStore`` under the test's
temp directory, while the reference's jitted ``make_serve_step`` runs
the same (mesh, case) pairs over its ``cache_specs`` in REF_PARTS
subprocesses with 4 forced host devices, and the test process runs the
port's one-device cases.  Cases (SMOKE, fp32, ``topk_impl="bisect"``, 3
steps fed seeded tokens, slots at 5, 31, 47 and 62: one slot with no
key past the first rank's, writes that cross the ranks' boundaries, a
last write clamped to the last row): qwen3-4b on the kernel route (the
exact re-plan on the rank's blocks, the decode kernel's partial mode:
its plain version here) and on the dense route (``_attend_split``, the
reference's path); its GQA config (4 query over 2 KV heads: no
attention region on (1, 4), so the weights are gathered) on both;
qwen3-moe; llama-3.2-vision (``kv`` and ``cross_kv``, and with context
lengths, whose ``valid`` splits too: port only, the reference's
``cache_specs`` has no rule for it); whisper-base at 16 encoder frames
(``cross_kv`` split) and at 9 (not split: the head layout); zamba2
(``shared_kv``); rwkv6 (no KV cache: the head layout's specs).

Held: every step's global logits within MESH_ATOL (1e-5) of the port's
one device (rwkv6's third step SSM_ATOL, as ``test_torch_serve_mesh``)
and within LOGIT_ATOL (1e-4) of the reference on the same mesh; every
top-k threshold bitwise one device's on the same scores (the rank's
scores gathered and bisected whole: the bisection's min, max and counts
reduced over the ranks); the ranks' planned blocks (local id +
the rank's offset) equal to one device's, per (slot, KV head) and
step; ``block_cache`` → ``gather_cache`` bitwise; the refusals (paged,
a plan narrower than its blocks, and every plan mode but the exact
re-plan); the plain partial mode against the whole output."""
import ctypes
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402

import torch_cp_decode_ranks as C  # noqa: E402
from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.models.config import KVCacheConfig as JKV  # noqa: E402
from repro.models.config import SataDecodeConfig as JDec  # noqa: E402
from repro_torch.configs.archs import SMOKE  # noqa: E402
from repro_torch.core import decode_plan as dp  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.sharding import KeySplit, ShardLayout  # noqa
from repro_torch.kernels import sata_decode as tsd  # noqa: E402
from repro_torch.launch.mesh import ShardMesh  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models.config import KVCacheConfig, SataDecodeConfig  # noqa

MESH_ATOL = 1e-5
SSM_ATOL = 1e-4
LOGIT_ATOL = 1e-4
PARTIAL_ATOL = 1e-6
REF_PARTS = 4
WORKER = pathlib.Path(C.__file__)
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT_CASES = [*C.CASES, "vlm-len"]
SHAPES = [s for shapes in C.MESHES.values() for s in shapes]
JOBS = [(s, c) for s in SHAPES for c in PORT_CASES]
IDS = [f"{s[0]}x{s[1]}-{c}" for s, c in JOBS]
KERNEL = [(s, c) for s, c in JOBS if C.CASES.get(c, C.CASES["vlm"])[1]
          == "kernel"]
REF = [(s, c) for s, c in JOBS if c not in C.PORT_ONLY]


def _start(args, env):
    return subprocess.Popen([sys.executable, str(WORKER), *map(str, args)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(procs):
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({world: [rank 0's results, ...]}, the reference's logits by
    "<shape>/<case>/<step>", the port's one-device results by case)."""
    tmp = tmp_path_factory.mktemp("cp_decode")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), str(WORKER.parent), os.environ.get("PYTHONPATH", "")]))
    procs = [_start(["reference", tmp, i, REF_PARTS], dict(
        env, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4"))
        for i in range(REF_PARTS)]
    procs += [_start([r, w, tmp], env) for w in C.MESHES for r in range(w)]
    try:         # the ranks wait for each case's weights as they come
        C.write_weights(str(tmp), jmdl.init_params(
            jax.random.PRNGKey(0), C.case_cfg(JSMOKE, JDec, JKV, "ssm")),
            "ssm")
        one = {case: C.port_case(str(tmp), case, None)
               for case in PORT_CASES}
    finally:
        _finish(procs)
    worlds = {w: torch.load(tmp / f"world{w}.pt", weights_only=False)
              for w in C.MESHES}
    want = {}
    for i in range(REF_PARTS):
        with np.load(tmp / f"reference{i}.npz") as z:
            want.update({n: z[n] for n in z.files})
    return worlds, want, one


def _ranks(worlds, shape):
    return worlds[next(w for w, s in C.MESHES.items() if shape in s)]


@pytest.mark.parametrize("shape,case", JOBS, ids=IDS)
def test_mesh_matches_one_device(runs, shape, case):
    """Logits, thresholds (bitwise) and the round trip on every rank."""
    worlds, _, one = runs
    ranks = _ranks(worlds, shape)
    want = one[case]
    for r, res in enumerate(ranks):
        out = res[(shape, case)]
        for i, (got, ref) in enumerate(zip(out["logits"], want["logits"])):
            atol = SSM_ATOL if case == "ssm" and i >= 2 else MESH_ATOL
            np.testing.assert_allclose(got, ref, atol=atol, rtol=0,
                                       err_msg=f"rank {r} step {i}")
            np.testing.assert_array_equal(got, ranks[0][(shape, case)][
                "logits"][i])
        assert len(out["thresholds"]) == len(want["thresholds"])
        assert (len(want["thresholds"]) > 0) == (case != "ssm")
        # every bisection bitwise one device's on the same scores (the
        # ranks' scores gathered, bisected whole); the scores themselves
        # carry the ranks' fp32 reordering (row-parallel sums, a column
        # block's GEMM), which moves a threshold by a bisection step
        # (whisper's 9 frames stay whole: its cross bisections, every
        # second, run on one rank's whole row)
        n = len(out["thresholds"])
        assert out["whole_row"] == [True] * (n // 2 if case == "audio9"
                                             else n), r
        assert out["roundtrip"], (r, shape, case)


@pytest.mark.parametrize("shape,case", REF, ids=[f"{s[0]}x{s[1]}-{c}"
                                                 for s, c in REF])
def test_mesh_matches_the_reference_on_the_same_mesh(runs, shape, case):
    worlds, want, _ = runs
    key = f"{shape[0]}x{shape[1]}/{C.reference_name(case)}"
    got = _ranks(worlds, shape)[0][(shape, case)]["logits"]
    for i, a in enumerate(got):
        np.testing.assert_allclose(a, want[f"{key}/{i}"], atol=LOGIT_ATOL,
                                   rtol=0, err_msg=f"{key} step {i}")


@pytest.mark.parametrize("shape,case", KERNEL,
                         ids=[f"{s[0]}x{s[1]}-{c}" for s, c in KERNEL])
def test_the_ranks_plan_blocks_are_one_device_s(runs, shape, case):
    """After every step, layer 0's planned blocks of the ranks (local id
    + the rank's first block) make up one device's, per (slot, KV
    head); a rank plans in its own block ids."""
    worlds, _, one = runs
    ranks = _ranks(worlds, shape)
    for i, (idx, cnt) in enumerate(one[case]["plans"]):
        union = {}
        for res in ranks:
            out = res[(shape, case)]
            d, r = out["coords"]
            lidx, lcnt = out["plans"][i]
            nkb = lidx.shape[-1]
            assert (lidx < nkb).all() and (lcnt <= nkb).all()
            for b, h in np.ndindex(lcnt.shape):
                got = union.setdefault((d * lcnt.shape[0] + b, h), set())
                got.update(int(x) + r * nkb for x in lidx[b, h, :lcnt[b, h]])
        for b, h in np.ndindex(cnt.shape):
            assert union[(b, h)] == set(idx[b, h, :cnt[b, h]].tolist()), \
                (i, b, h)


def _layout(case, m=2, flag=True, paged=False):
    cfg = C.case_cfg(SMOKE, SataDecodeConfig, KVCacheConfig, case)
    if paged:
        cfg = dataclasses.replace(cfg, kv=KVCacheConfig(layout="paged"))
    mesh = ShardMesh(("data", "model"), {"data": 1, "model": m}, None, 0,
                     torch.device("cpu"))
    old, sharding.CACHE_SEQ_SHARD = sharding.CACHE_SEQ_SHARD, flag
    try:
        layout = ShardLayout(cfg, mesh, mode="infer_tp")
    finally:
        sharding.CACHE_SEQ_SHARD = old
    return cfg, layout, tdec.init_cache(cfg, C.B, C.MAX_LEN, device="meta")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_the_rank_holds_its_keys(runs, shape):
    """A rank's ``kv`` holds S / m positions of its batch rows and all
    KV heads, its plan summaries nkb / m blocks; whisper's 16 frames
    split, its 9 keep the head layout; zamba2's ``shared_kv`` splits;
    rwkv6's specs are the head layout's (``CACHE_SEQ_SHARD`` False)."""
    m, nd = shape[1], shape[0]
    res = _ranks(runs[0], shape)[0]
    s_loc, nkb = C.MAX_LEN // m, C.MAX_LEN // C.PAGE // m
    dense = res[(shape, "qwen3-4b")]["shapes"]
    cfg = SMOKE["qwen3-4b"]
    assert dense["kv/k"] == (cfg.n_layers, C.B // nd, s_loc, cfg.n_kv_heads,
                             cfg.hd)
    assert dense["kv/plan/k_min"][:4] == (cfg.n_layers, C.B // nd,
                                          cfg.n_kv_heads, nkb)
    assert dense["kv/plan/kv_indices"][-1] == nkb
    assert res[(shape, "audio")]["shapes"]["cross_kv/k"][2] == 16 // m
    audio9 = res[(shape, "audio9")]
    assert audio9["shapes"]["cross_kv/k"][2] == 9
    _, head, cache = _layout("audio9", m, flag=False)
    assert audio9["specs"]["cross_kv/k"] == head.cache_specs(cache)[
        ("cross_kv", "k")]
    assert res[(shape, "hybrid")]["shapes"]["shared_kv/k"][2] == s_loc
    assert res[(shape, "vlm-len")]["shapes"]["cross_kv/valid"][2] == 8 // m
    cfg, head, cache = _layout("ssm", m, flag=False)
    assert res[(shape, "ssm")]["specs"] == {
        "/".join(p): tuple(s) for p, s in head.cache_specs(cache).items()}


def test_gqa_on_four_ranks_gathers_the_attention(runs):
    """4 query over 2 KV heads on (1, 4): no attention region (its four
    weights gathered over "model" in every layer); on (1, 2) the region
    holds the rank's heads."""
    n = SMOKE["qwen3-4b"].n_layers
    got = _ranks(runs[0], (1, 4))[0][((1, 4), "gqa")]["counts"]
    assert got["gathered_over_model"] == 4 * n, got
    assert _ranks(runs[0], (1, 2))[0][((1, 2), "gqa")]["counts"][
        "gathered_over_model"] == 0


@pytest.mark.parametrize("what", ["paged", "narrow plan", "indivisible"])
def test_the_layout_refuses(what):
    kw = {"paged": dict(paged=True)}.get(what, {})
    cfg, layout, cache = _layout("qwen3-4b", 3 if what == "indivisible"
                                 else 2, **kw)
    if what == "narrow plan":
        cfg = dataclasses.replace(cfg, sata=dataclasses.replace(
            cfg.sata, decode=dataclasses.replace(cfg.sata.decode, blocks=2)))
        cache = tdec.init_cache(cfg, C.B, C.MAX_LEN, device="meta")
    match = {"paged": "no paged layout", "narrow plan": "plan width",
             "indivisible": "do not split over 3"}[what]
    with pytest.raises(ValueError, match=match):
        layout.cache_specs(cache)


_MODES = {"incremental": dict(replan_interval=2),
          "churn": dict(churn_budget=0.25),
          "sketch": dict(replan_mode="sketch"),
          "budget": dict(qos=True), "retirement": dict(retire=True),
          "paged": dict(page_table=True)}


@pytest.mark.parametrize("mode", list(_MODES))
def test_every_plan_mode_but_the_exact_re_plan_is_refused(mode):
    kw = dict(_MODES[mode])
    init = {k: kw.pop(k) for k in ("qos", "retire") if k in kw}
    plan = dp.init_decode_plan(2, 2, 32, 8, 8, device="cpu", **init)
    if kw.pop("page_table", False):
        kw["page_table"] = torch.zeros((2, 4), dtype=torch.int32)
    q = torch.zeros((2, 2, 2, 8))
    k = torch.zeros((2, 32, 2, 8))
    with pytest.raises(ValueError, match="re-plans exactly every step"):
        dp.decode_plan_update(plan, q, k, torch.zeros(2, dtype=torch.int32),
                              topk_k=4, k_block=8, over=object(), **kw)


class _Parts:
    """``KeySplit.combine``'s gather over partials held in one process."""

    def __init__(self, outs, lses):
        self.i = iter((outs, lses))

    def gather(self, x, dim):
        return torch.stack(next(self.i))


def _decode_case(seed, g=4, d=16, kb=8, s=64, dead=False):
    rng = np.random.default_rng(seed)
    b, kv = 3, 2
    q = torch.from_numpy(rng.standard_normal((b, kv, g, d)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kv, d)).astype(
        np.float32)) for _ in range(2))
    nkb = s // kb
    idx = torch.arange(nkb, dtype=torch.int32).expand(b, kv, nkb).contiguous()
    cnt = torch.full((b, kv), nkb, dtype=torch.int32)
    if dead:
        cnt[0, 1] = 0                   # a row with no planned block
    thr = torch.from_numpy((0.5 * rng.standard_normal((b, kv, g, 1)) - 1.5
                            ).astype(np.float32))
    pos = torch.tensor([s - 1, s // 2, 5], dtype=torch.int32)
    return q, k, v, idx, cnt, thr, pos


def test_one_partial_combined_alone_is_the_output():
    """The partial mode's out, combined alone, is the normal output
    bitwise; a count-0 row's lse is −inf and its out 0."""
    args = _decode_case(0, dead=True)
    want = tsd.sata_decode_attention_ref(*args, k_block=8)
    out, lse = tsd.sata_decode_attention_ref(*args, k_block=8, partial=True)
    assert out.dtype == lse.dtype == torch.float32
    assert lse.shape == args[0].shape[:-1] + (1,)
    assert torch.isneginf(lse[0, 1]).all() and (out[0, 1] == 0).all()
    assert torch.isfinite(lse[1:]).all()
    got = KeySplit.combine(_Parts([out], [lse]), out, lse)
    assert torch.equal(got.to(args[0].dtype), want)


@pytest.mark.parametrize("g,d", [(4, 16), (16, 8), (1, 20)])
def test_two_halves_combined_are_the_whole(g, d):
    """The keys split in two at a block boundary (the second half's
    positions local to it), each half's partial, combined: the whole
    output within PARTIAL_ATOL (fp32)."""
    q, k, v, idx, cnt, thr, pos = _decode_case(g * 7 + d, g=g, d=d)
    want = tsd.sata_decode_attention_ref(q, k, v, idx, cnt, thr, pos,
                                         k_block=8)
    half, nkb = k.shape[1] // 2, idx.shape[-1] // 2
    parts = []
    for r in range(2):
        sl = slice(r * half, (r + 1) * half)
        lidx = torch.arange(nkb, dtype=torch.int32).expand(
            *idx.shape[:2], nkb).contiguous()
        lcnt = torch.full(cnt.shape, nkb, dtype=torch.int32)
        parts.append(tsd.sata_decode_attention_ref(
            q, k[:, sl].contiguous(), v[:, sl].contiguous(), lidx, lcnt, thr,
            pos - r * half, k_block=8, partial=True))
    outs, lses = zip(*parts)
    got = KeySplit.combine(_Parts(list(outs), list(lses)), outs[0], lses[0])
    assert torch.isneginf(lses[1][2]).all()     # slot 2: no key past 32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=PARTIAL_ATOL,
                               rtol=0)


def test_partial_signature_matches_the_c_interface():
    """``PARTIAL_ARGTYPES`` list ``sata_decode_attention_partial``'s
    parameters in order; the default entry's stay ``ARGTYPES``."""
    text = (pathlib.Path(tsd.__file__).parent / "csrc" /
            "sata_decode.cu").read_text()
    for symbol, want in (("sata_decode_attention_partial",
                          tsd.PARTIAL_ARGTYPES),
                         ("sata_decode_attention", tsd.ARGTYPES)):
        sig = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)", text,
                        re.S).group(1)
        assert [ctypes.c_void_p if "*" in a else ctypes.c_int
                for a in sig.split(",")] == want, symbol


def test_the_meta_stand_in_counts_the_partial_bytes():
    """The partial mode's stand-in returns the fp32 out and lse shapes,
    and its work adds the fp32 output and lse bytes."""
    from repro_torch.kernels import ops
    q = torch.empty((2, 4, 4, 16), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 64, 4, 16), dtype=torch.bfloat16, device="meta")
    idx = torch.empty((2, 4, 8), dtype=torch.int32, device="meta")
    out, lse = ops.sata_decode_attention(
        q, k, k, idx, idx[..., 0], torch.empty((2, 4, 4, 1), device="meta"),
        torch.empty((2,), dtype=torch.int32, device="meta"), k_block=8,
        partial=True)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert lse.shape == (2, 4, 4, 1)
    _, whole = ops.decode_attention_work(q, idx, k_block=8)
    _, part = ops.decode_attention_work(q, idx, k_block=8, partial=True)
    assert part - whole == 2 * 4 * 4 * (16 * 4 + 4) - 2 * 4 * 4 * 16 * 2
