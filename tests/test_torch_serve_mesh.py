"""Port parity: ``make_serve_step(cfg, mesh=)``, the decode step on a
rank's view of a ("data", "model") mesh, and ``ShardLayout``'s serving-
cache layout.

Every case of ``tests/torch_serve_mesh_ranks.py`` (the dense, moe, vlm,
audio, hybrid and ssm SMOKE configs in fp32; dense and hybrid on both
cache layouts) runs three teacher-forced steps on one device, then on
gloo ranks on (1, 2), (2, 1) and (2, 2) with the weights in "infer_tp"
mode (and dense on (2, 2) in "train" mode), fed one device's greedy
tokens.  Held:

* every step's global logits within ``MESH_ATOL`` (1e-5) of one
  device's: the row-parallel out-projections and the vocab-parallel
  sums add fp32 partial sums in another order.  ssm's third step is
  held to ``SSM_ATOL`` (1e-4, ``test_torch_serve_hybrid_ssm``'s): SMOKE
  rwkv6's group norm divides a head of variance ~1e-4, which turns that
  reordering into 5.9e-5 of logit (ROADMAP C10 measured 3.7e-5 for the
  jitted reference's reordering); its first two steps stay at 1e-5;
* layer 0's plan rows after the first step equal one device's exactly
  (a wrong KV axis of a plan leaf moves them);
* on the first mesh of each world, the rank's blocks of the whole cache
  gather back to it bitwise (``block_cache`` / ``gather_cache``);
* paged == contiguous bitwise on every rank.

One device's port step equals the reference's ``serve_step`` on weights
carried over from numpy at ``LOGIT_ATOL`` (1e-4, the serve tests'), the
plan rows exactly; the reference runs on one CPU device, eagerly for
rwkv6 (ROADMAP C10).  Without a mesh ``make_serve_step`` is bitwise the
model's own ``dec.serve_step``.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_serve_mesh_ranks as R  # noqa: E402
from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.core.paging import PageAllocator as JAlloc  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.models.config import KVCacheConfig as JKV  # noqa: E402
from repro.models.config import SataDecodeConfig as JDec  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models.model import Model, params_from_jax  # noqa: E402
from repro_torch.train.step import make_serve_step  # noqa: E402

MESH_ATOL = 1e-5
SSM_ATOL = 1e-4
LOGIT_ATOL = 1e-4
ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = pathlib.Path(R.__file__)
CASES = [(f, lay) for f, lays in R.CASES.items() for lay in lays]
MESH_CASES = [(w, shape, f, lay, "infer_tp") for w, shapes in R.MESHES.items()
              for shape in shapes for f, lay in CASES] + \
    [(4, R.TRAIN_MODE[0], R.TRAIN_MODE[1], "contiguous", "train")]


def _ids(case):
    w, shape, f, lay, mode = case
    return f"{shape[0]}x{shape[1]}-{f}-{lay}-{mode}"


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """Both gloo worlds, started when the module starts (the reference's
    cases run meanwhile); ``worlds`` waits for their results."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(WORKER.parent),
         os.environ.get("PYTHONPATH", "")]))
    procs = {w: [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(w), str(tmp)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(w)] for w in R.MESHES}
    done = {}

    def get():
        if not done:
            try:
                logs = {w: [p.communicate(timeout=300)[0] for p in ps]
                        for w, ps in procs.items()}
            finally:
                for ps in procs.values():
                    for p in ps:
                        p.kill()
                        p.wait()
            for w, ps in procs.items():
                for p, log in zip(ps, logs[w]):
                    assert p.returncode == 0, log[-4000:]
            done.update({w: torch.load(tmp / f"world{w}.pt",
                                       weights_only=False)
                         for w in R.MESHES})
        return done
    yield get
    for ps in procs.values():
        for p in ps:
            p.kill()
            p.wait()


@pytest.fixture
def worlds(started):
    """{world: [rank 0's results, rank 1's, ...]}."""
    return started()


class _Ref:
    """The reference's side of a case on one CPU device."""

    dec, alloc = jdec, JAlloc

    def cfg(self, family, layout):
        return R.case_cfg(JSMOKE, JDec, JKV, family, layout)

    def init_cache(self, cfg):
        return jdec.init_cache(cfg, R.B, R.MAX_LEN)

    def to(self, a):
        return jnp.asarray(a)


@pytest.mark.parametrize("family,layout", CASES)
def test_one_device_matches_the_reference(family, layout):
    ref, port = _Ref(), R.Port()
    jc, tc = ref.cfg(family, layout), port.cfg(family, layout)
    params = jmdl.init_params(jax.random.PRNGKey(0), jc)
    model = params_from_jax(jax.tree.map(np.asarray, params), tc,
                            device="cpu")
    eager = family == "ssm"
    jstep = jdec.serve_step if eager else jax.jit(
        lambda p, c, t, q: jdec.serve_step(p, jc, c, t, q))

    def ref_step(cache, tok, pos):
        if eager:
            with jax.disable_jit():
                lg, cache = jdec.serve_step(params, jc, cache,
                                            jnp.asarray(tok),
                                            jnp.asarray(pos))
        else:
            lg, cache = jstep(params, cache, jnp.asarray(tok),
                              jnp.asarray(pos))
        return np.asarray(lg), cache

    plans = {}

    def recorded(name, fn):
        def step(cache, tok, pos):
            lg, cache = fn(cache, tok, pos)
            plans.setdefault(name, R.plan_rows(cache))
            return lg, cache
        return step

    jcache, jtok = R.fill_cache(ref, params, jc, family, layout)
    want, fed, _ = R.drive(recorded("ref", ref_step), jcache, jtok)
    tcache, ttok = R.fill_cache(port, model, tc, family, layout)
    np.testing.assert_array_equal(ttok, jtok)
    got, _, _ = R.drive(recorded("port", lambda c, t, p: port.step(
        model, tc, c, t, p)), tcache, None, feed=fed)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {i}")
    if family == "ssm":
        assert plans["port"] is None and plans["ref"] is None
    else:
        for a, b in zip(plans["port"], plans["ref"]):
            # vlm: the reference nests its self layers (n_cross, per_group)
            np.testing.assert_array_equal(a, b[0] if family == "vlm" else b)


@pytest.mark.parametrize("case", MESH_CASES, ids=_ids)
def test_mesh_step_matches_one_device(worlds, case):
    world, shape, family, layout, mode = case
    key = (shape, family, layout, mode)
    for r, res in enumerate(worlds[world]):
        out = res[key]
        one = out["one"]
        for i, (got, want) in enumerate(zip(out["logits"], one["logits"])):
            atol = SSM_ATOL if family == "ssm" and i >= 2 else MESH_ATOL
            np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                       err_msg=f"rank {r} step {i}")
            # the logits are gathered whole: every rank returns the same
            np.testing.assert_array_equal(got, worlds[world][0][key][
                "logits"][i])
        if family == "ssm":
            assert out["plan0"] is None and one["plan0"] is None
        else:
            for got, want in zip(out["plan0"], one["plan0"]):
                np.testing.assert_array_equal(got, want)
        if "roundtrip" in out:
            assert out["roundtrip"], (r, key)
        regions = out["counts"]["tensor_parallel"]
        assert (regions > 0) == (shape[1] > 1), out["counts"]
        # zamba2's shared_in is the one leaf gathered over "model"
        assert out["counts"]["gathered_over_model"] == (
            1 if family == "hybrid" and shape[1] > 1 else 0)


@pytest.mark.parametrize("shape", [s for w in R.MESHES for s in R.MESHES[w]],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_paged_equals_contiguous_on_every_rank(worlds, shape, family):
    world = next(w for w, shapes in R.MESHES.items() if shape in shapes)
    for res in worlds[world]:
        got = res[(shape, family, "paged", "infer_tp")]
        want = res[(shape, family, "contiguous", "infer_tp")]
        for a, b in zip(got["logits"], want["logits"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got["plan0"], want["plan0"]):
            np.testing.assert_array_equal(a, b)


def test_blocks_are_the_rank_s_heads_and_rows(worlds):
    """On (2, 2): a rank's dense cache holds 2 of the 4 slots and 1 of the
    2 KV heads, its plan rows likewise, the page table its 2 slots' rows
    and the per-slot vectors its 2 slots; hybrid's conv state holds the
    rank's half of the channels, rwkv6's token shift stays whole."""
    res = worlds[4][0]
    dense = res[((2, 2), "dense", "paged", "infer_tp")]["shapes"]["cache"]
    cfg = R.Port().cfg("dense", "paged")
    n_pages = R.B * (R.MAX_LEN // R.PAGE) + 1
    assert dense["kv/k_pages"] == (cfg.n_layers, n_pages, R.PAGE, 1, cfg.hd)
    assert dense["kv/page_table"] == (cfg.n_layers, 2, R.MAX_LEN // R.PAGE)
    assert dense["kv/plan/kv_indices"] == (cfg.n_layers, 2, 1,
                                           R.MAX_LEN // R.PAGE)
    assert dense["kv/plan/k_min"][:3] == (cfg.n_layers, 2, 1)
    assert dense["kv/plan/step"] == (cfg.n_layers, 2)
    hyb = res[((2, 2), "hybrid", "contiguous", "infer_tp")]["shapes"]["cache"]
    hc = R.Port().cfg("hybrid", "contiguous")
    assert hyb["mamba/conv"] == (hc.n_layers, 2, hc.ssm_conv - 1,
                                 (hc.d_inner + 2 * hc.ssm_state) // 2)
    assert hyb["mamba/ssm"][:3] == (hc.n_layers, 2, hc.ssm_heads // 2)
    ssm = res[((2, 2), "ssm", "contiguous", "infer_tp")]["shapes"]["cache"]
    sc = R.Port().cfg("ssm", "contiguous")
    assert ssm["rwkv/tm_x"] == (sc.n_layers, 2, sc.d_model)
    assert ssm["rwkv/state"][:3] == (sc.n_layers, 2,
                                     sc.d_model // sc.rwkv_head_dim // 2)


@pytest.mark.parametrize("family", list(R.FAMILIES))
def test_no_mesh_is_bitwise_the_models_serve_step(family):
    port = R.Port()
    cfg = port.cfg(family, R.CASES[family][-1])
    model = Model(cfg, device="cpu", seed=0)
    step = make_serve_step(cfg)
    assert step.layout.m == 1 and not step.layout.data
    a, tok = R.fill_cache(port, model, cfg, family, R.CASES[family][-1])
    b, _ = R.fill_cache(port, model, cfg, family, R.CASES[family][-1])
    got, _, a = R.drive(lambda c, t, p: tuple(
        x.numpy() if i == 0 else x for i, x in enumerate(
            step(model, c, port.to(t), port.to(p)))), a, tok)
    want, _, b = R.drive(lambda c, t, p: port.step(model, cfg, c, t, p), b,
                         tok)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    assert R._equal_trees(a, b)
    assert tdec.kv_group(a) == tdec.kv_group(b)
