"""Port parity: the dry run's inputs and steps — ``launch.inputs``
(``batch_specs_for``, ``state_specs_for``, ``decode_specs_for``: meta
tensors for the reference's ``ShapeDtypeStruct``s), ``train.step``'s
``make_serve_step`` and ``make_prefill_step(mesh=)``.

Shapes and dtypes are compared exactly: the batch for every arch ×
shape, the state leaf by leaf through ``params_from_jax``'s name map
(its leaves as meta tensors: full-width qwen3-4b is never allocated) for
every SMOKE arch and full qwen3-4b, the decode cache for SMOKE dense.
``make_serve_step`` against the reference's on SMOKE qwen3-4b, fed the
same tokens for 6 steps from an empty cache: logits within 1e-4
(``test_torch_serve.py``'s LOGIT_ATOL: fp32 summation order over 4
layers).  ``make_prefill_step()`` and ``make_prefill_step(mesh=
make_local_mesh())`` are bitwise the model's own forward's last
position."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.launch import inputs as jin  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.optim.adamw import OptConfig as JOpt  # noqa: E402
from repro.train.step import make_serve_step as jserve_step  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.launch import inputs as tin  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import model as tmdl  # noqa: E402
from repro_torch.optim.adamw import OptConfig as TOpt  # noqa: E402
from repro_torch.train.step import make_prefill_step, \
    make_serve_step  # noqa: E402

LOGIT_ATOL = 1e-4
DTYPES = {"int32": torch.int32, "float32": torch.float32,
          "bfloat16": torch.bfloat16, "bool": torch.bool,
          "int8": torch.int8, "uint8": torch.uint8}


def _same(t, sds, what):
    assert t.device.type == "meta", what
    assert tuple(t.shape) == tuple(sds.shape), (what, t.shape, sds.shape)
    assert t.dtype == DTYPES[str(np.dtype(sds.dtype))], (what, t.dtype,
                                                         sds.dtype)


@pytest.mark.parametrize("shape", sorted(jarchs.SHAPES))
def test_batch_specs_match_reference(shape):
    for arch in jarchs.ARCHS:
        want = jin.batch_specs_for(jarchs.ARCHS[arch], jarchs.SHAPES[shape])
        got = tin.batch_specs_for(tarchs.ARCHS[arch], tarchs.SHAPES[shape])
        assert list(got) == list(want), (arch, shape)
        for k in want:
            _same(got[k], want[k], (arch, shape, k))


def _reference_leaves_as_meta(monkeypatch, tree, cfg):
    """``params_from_jax`` over the reference's abstract leaves: each
    leaf a zero-strided numpy array (never materialized) and each port
    tensor a meta tensor of its shape and dtype."""
    monkeypatch.setattr(
        tmdl, "_to_tensor", lambda a, device: torch.empty(
            a.shape, dtype=DTYPES[str(a.dtype)], device="meta"))
    arrays = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), tree)
    return tmdl.params_from_jax(arrays, cfg, device="meta")


@pytest.mark.parametrize("arch", sorted(jarchs.SMOKE) + ["qwen3-4b:full"])
def test_state_specs_match_reference_leaf_by_leaf(arch, monkeypatch):
    name, full = arch.split(":")[0], arch.endswith(":full")
    jc = (jarchs.ARCHS if full else jarchs.SMOKE)[name]
    tc = (tarchs.ARCHS if full else tarchs.SMOKE)[name]
    want = jin.state_specs_for(jc, JOpt())
    got = tin.state_specs_for(tc, TOpt())
    mapped = _reference_leaves_as_meta(monkeypatch, want["params"], tc)
    ref = dict(mapped.named_parameters())
    params = dict(got["params"].named_parameters())
    assert list(params) == list(ref)
    moments = {k: dict(_reference_leaves_as_meta(
        monkeypatch, want["opt"][k], tc).named_parameters()) for k in "mv"}
    for n, p in params.items():
        assert p.device.type == "meta"
        assert p.shape == ref[n].shape and p.dtype == ref[n].dtype, n
        for k in "mv":
            m = got["opt"][k][n]
            assert m.device.type == "meta" and m.dtype == torch.float32
            assert m.shape == moments[k][n].shape == p.shape, (k, n)
    _same(got["opt"]["step"], want["opt"]["step"], "step")


def test_decode_specs_match_reference_for_dense():
    jc, tc = jarchs.SMOKE["qwen3-4b"], tarchs.SMOKE["qwen3-4b"]
    for shape in ("decode_32k", "long_500k"):
        jcache, jtok, jpos = jin.decode_specs_for(jc, jarchs.SHAPES[shape])
        tcache, ttok, tpos = tin.decode_specs_for(tc, tarchs.SHAPES[shape])
        _same(ttok, jtok, "tokens")
        _same(tpos, jpos, "pos")
        want = jax.tree_util.tree_flatten_with_path(jcache)[0]
        got = {}

        def walk(tree, prefix=()):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, prefix + (k,))
                else:
                    got[prefix + (k,)] = v
        walk(tcache)
        assert len(got) == len(want)
        for path, leaf in want:
            _same(got[tuple(p.key for p in path)], leaf, (shape, path))


def test_serve_step_matches_reference():
    jc, tc = jarchs.SMOKE["qwen3-4b"], tarchs.SMOKE["qwen3-4b"]
    params = jmdl.init_params(jax.random.PRNGKey(0), jc)
    model = tmdl.params_from_jax(jax.tree.map(np.asarray, params), tc,
                                 device="cpu")
    b, max_len = 2, 32
    from repro.models import decode as jdec
    jcache = jdec.init_cache(jc, b, max_len)
    tcache = tdec.init_cache(tc, b, max_len, device="cpu")
    jstep = jax.jit(jserve_step(jc))
    tstep = make_serve_step(tc)
    toks = np.random.default_rng(0).integers(0, 256, (6, b, 1)).astype(
        np.int32)
    with torch.inference_mode():
        for i, tok in enumerate(toks):
            jl, jcache = jstep(params, jcache, jnp.asarray(tok),
                               jnp.int32(i))
            tl, tcache = tstep(model, tcache, torch.from_numpy(tok),
                               torch.tensor(i, dtype=torch.int32))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=LOGIT_ATOL, rtol=0,
                                       err_msg=f"step {i}")


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-235b-a22b"])
def test_prefill_step_on_the_local_mesh_is_bitwise_the_plain_step(arch):
    cfg = dataclasses.replace(tarchs.SMOKE[arch], remat="full")
    model = tmdl.Model(cfg, device="cpu", seed=0)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    batch = {"tokens": tokens}
    with torch.no_grad():
        want = tmdl.forward(model, cfg, batch)[0][:, -1, :]
    for mesh in (None, make_local_mesh(device="cpu")):
        got = make_prefill_step(cfg, mesh=mesh)(model, batch)
        assert got.shape == (2, cfg.vocab_size) and \
            got.dtype == torch.float32
        assert torch.equal(got, want)
