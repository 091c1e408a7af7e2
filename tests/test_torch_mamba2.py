"""Port parity: the Mamba2 (SSD) block (``models/mamba2.py``) against
the JAX reference on the same numpy weights and inputs.

SMOKE zamba2-2.7b widths, fp32: d_model 64, d_inner 128, 16 SSM heads ×
8, state 8, conv 4, chunk 8.  ``mamba2_apply`` (the chunked form, with
its inter-chunk recurrence as a Python loop) and its gradients,
``mamba2_decode`` and its cache.  Tolerances: outputs and states 1e-5
absolute + 1e-5 relative (fp32 summation order of the einsums),
gradients 1e-5 + 1e-4 relative; the chunk-size invariance and the
recurrent step against the chunked form 1e-4, as the reference's own
tests hold them (`tests/test_model_consistency.py`)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402
from repro_torch.models.model import _Init  # noqa: E402

ATOL, RTOL = 1e-5, 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
INV_TOL = 1e-4
ARCH = "zamba2-2.7b"


def _cfgs(**kw):
    return [dataclasses.replace(s[ARCH], **kw) for s in (JSMOKE, TSMOKE)]


def _params(jc, seed=0, perturb=True):
    """The reference's init with the fp32 leaves moved off their
    constant init values (dt_bias, d_skip, norm_scale), so every leaf
    reaches the output."""
    p = jm.mamba2_init(jax.random.PRNGKey(seed), jc)
    p = {k: np.asarray(v) for k, v in p.items()}
    if perturb:
        rng = np.random.default_rng(seed + 100)
        for k in ("dt_bias", "d_skip", "norm_scale"):
            p[k] = (p[k] + 0.3 * rng.standard_normal(p[k].shape)).astype(
                np.float32)
    return p


def _torch(p, grad=False):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in p.items()}


def _x(seed, b=2, s=16, d=64):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


def test_module_has_the_reference_leaves():
    """``Mamba2``'s parameters: the reference's names, shapes and dtypes,
    fp32 leaves at the reference's initial values (a_log within two
    ulps: torch's linspace and log round differently from XLA's)."""
    jc, tc = _cfgs()
    want = jm.mamba2_init(jax.random.PRNGKey(0), jc)
    init = _Init(tc, torch.device("cpu"), torch.Generator().manual_seed(0))
    mod = tm.Mamba2(tc, init)
    got = dict(mod.named_parameters())
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert tuple(got[k].shape) == a.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(a.dtype), k
    for k in ("a_log", "d_skip", "dt_bias", "norm_scale"):
        _close(got[k], want[k], atol=0, rtol=2.5e-7, msg=k)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_apply_matches_reference_at_each_chunk(chunk):
    """``mamba2_apply`` at ssm_chunk 4 / 8 / 16 over S = 16 (4, 2 and 1
    chunks through the inter-chunk loop) equals the reference's."""
    jc, tc = _cfgs(ssm_chunk=chunk)
    p = _params(jc)
    x = _x(1)
    got = tm.mamba2_apply(_torch(p), tc, torch.from_numpy(x))
    want = jm.mamba2_apply(p, jc, jnp.asarray(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)


def test_output_does_not_depend_on_the_chunk_size():
    """The port's own chunk invariance (the reference's
    ``test_mamba_chunk_size_invariance``): 4, 8 and 16 agree."""
    jc, tc = _cfgs()
    p = _torch(_params(jc, seed=3))
    x = torch.from_numpy(_x(2))
    outs = [tm.mamba2_apply(p, dataclasses.replace(tc, ssm_chunk=c), x)
            for c in (4, 8, 16)]
    _close(outs[0], outs[1].numpy(), atol=INV_TOL, rtol=INV_TOL)
    _close(outs[1], outs[2].numpy(), atol=INV_TOL, rtol=INV_TOL)


def test_ragged_length_takes_one_chunk():
    """S = 12 with chunk 8 does not tile: one chunk of 12, as in the
    reference (``s % q != 0 → q = s``)."""
    jc, tc = _cfgs(ssm_chunk=8)
    p = _params(jc, seed=4)
    x = _x(3, s=12)
    got = tm.mamba2_apply(_torch(p), tc, torch.from_numpy(x))
    want = jm.mamba2_apply(p, jc, jnp.asarray(x))
    _close(got, want)
    one = tm.mamba2_apply(_torch(p), dataclasses.replace(tc, ssm_chunk=12),
                          torch.from_numpy(x))
    assert torch.equal(got, one)


@pytest.mark.parametrize("chunk", [4, 16])
def test_gradients_match_jax_grad(chunk):
    """Every leaf's gradient and the input's, of a random projection of
    the output, against ``jax.grad``."""
    jc, tc = _cfgs(ssm_chunk=chunk)
    p = _params(jc, seed=5)
    x = _x(4)
    proj = np.random.default_rng(6).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, x):
        return (jm.mamba2_apply(p, jc, x) * proj).sum()

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = _torch(p, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    (tm.mamba2_apply(tp, tc, tx) * torch.from_numpy(proj)).sum().backward()
    for k, g in jg.items():
        _close(tp[k].grad, g, atol=GRAD_ATOL, rtol=GRAD_RTOL, msg=k)
    _close(tx.grad, jgx, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_strong_decay_keeps_gradients_finite():
    """A steep decay (a_log up to 8, dt ~ 5) makes the upper triangle's
    exp(lcum_i - lcum_j) overflow if it were taken before the mask: the
    mask goes first, so outputs and gradients stay finite."""
    jc, tc = _cfgs(ssm_chunk=16)
    p = _params(jc, seed=7)
    p["a_log"] = np.linspace(0.0, 8.0, p["a_log"].size).astype(np.float32)
    p["dt_bias"] = np.full_like(p["dt_bias"], 5.0)
    tp = _torch(p, grad=True)
    y = tm.mamba2_apply(tp, tc, torch.from_numpy(_x(8)))
    y.sum().backward()
    assert torch.isfinite(y).all()
    assert all(torch.isfinite(t.grad).all() for t in tp.values())
    _close(y, jm.mamba2_apply(p, jc, jnp.asarray(_x(8))))


def test_decode_steps_match_reference_and_the_chunked_form():
    """Eight ``mamba2_decode`` steps from ``init_mamba_cache``: each
    step's output and state equal the reference's, the input cache is
    left as it was, and the outputs reproduce ``mamba2_apply`` over the
    same eight tokens."""
    jc, tc = _cfgs(ssm_chunk=4)
    p = _params(jc, seed=9)
    x = _x(10, s=8)
    tp = _torch(p)
    jcache = jm.init_mamba_cache(jc, 2, jnp.float32)
    tcache = tm.init_mamba_cache(tc, 2, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    assert tcache["ssm"].dtype == torch.float32
    outs = []
    for t in range(8):
        xt = x[:, t:t + 1]
        want, jcache = jm.mamba2_decode(p, jc, jnp.asarray(xt), jcache)
        before = {k: v.clone() for k, v in tcache.items()}
        got, new = tm.mamba2_decode(tp, tc, torch.from_numpy(xt), tcache)
        for k in tcache:
            assert torch.equal(tcache[k], before[k]), k
        tcache = new
        _close(got, want, msg=f"step {t}")
        for k in new:
            _close(new[k], jcache[k], msg=f"step {t} {k}")
        outs.append(got)
    full = tm.mamba2_apply(tp, tc, torch.from_numpy(x))
    _close(torch.cat(outs, dim=1), full.numpy(), atol=INV_TOL, rtol=INV_TOL)


def test_bf16_activations_stay_bf16():
    """bf16 in, bf16 out, through both forms; the SSM state stays fp32
    and the conv history takes the model dtype."""
    _, tc = _cfgs(dtype="bfloat16")
    init = _Init(tc, torch.device("cpu"), torch.Generator().manual_seed(1))
    mod = tm.Mamba2(tc, init)
    x = torch.from_numpy(_x(11)).to(torch.bfloat16)
    with torch.no_grad():
        y = tm.mamba2_apply(mod, tc, x)
        cache = tm.init_mamba_cache(tc, 2, torch.bfloat16, device="cpu")
        yd, new = tm.mamba2_decode(mod, tc, x[:, :1], cache)
    assert y.dtype == yd.dtype == torch.bfloat16
    assert torch.isfinite(y.float()).all()
    assert new["ssm"].dtype == torch.float32
    assert new["conv"].dtype == torch.bfloat16
