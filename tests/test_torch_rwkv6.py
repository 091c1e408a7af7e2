"""Port parity: the RWKV6 "Finch" block (``models/rwkv6.py``) against the
JAX reference on the same numpy weights and inputs.

SMOKE rwkv6-1.6b widths, fp32: d_model 64, 8 heads × 8, d_ff 128, LoRA
rank 32.  The time mix (from zero state and from a carried state and
last token), the channel mix, the chunked time scan (under
``torch.utils.checkpoint`` when autograd records) against the plain
one, ``rwkv6_decode`` and its cache, gradients against ``jax.grad``,
and the bf16 carry dtype.  Tolerances: outputs and states 1e-5 absolute
+ 1e-5 relative (fp32 summation order), gradients 1e-5 + 1e-4
relative; chunked against unchunked 1e-5, as the reference's
``test_rwkv_chunked_scan_matches_unchunked`` holds it."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.models import rwkv6 as jr  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.models import rwkv6 as tr  # noqa: E402
from repro_torch.models.model import _Init  # noqa: E402

ATOL, RTOL = 1e-5, 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
ARCH = "rwkv6-1.6b"
B, D, H, HD = 2, 64, 8, 8


def _cfgs(**kw):
    return [dataclasses.replace(s[ARCH], **kw) for s in (JSMOKE, TSMOKE)]


def _params(jc, seed=0):
    """The reference's init with the constant fp32 leaves (mix ratios,
    w0, bonus_u, ln_scale) drawn off their init values, so every leaf
    reaches the output and the decay varies by channel."""
    p = {k: np.asarray(v) for k, v in
         jr.rwkv6_init(jax.random.PRNGKey(seed), jc).items()}
    rng = np.random.default_rng(seed + 100)
    for k in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "cmix_k",
              "cmix_r"):
        p[k] = rng.uniform(0.1, 0.9, p[k].shape).astype(np.float32)
    p["w0"] = rng.uniform(-3.0, -0.5, p["w0"].shape).astype(np.float32)
    p["bonus_u"] = (0.5 * rng.standard_normal(p["bonus_u"].shape)).astype(
        np.float32)
    p["ln_scale"] = (1 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    return p


def _torch(p, grad=False):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in p.items()}


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


def test_module_has_the_reference_leaves():
    jc, tc = _cfgs()
    want = jr.rwkv6_init(jax.random.PRNGKey(0), jc)
    init = _Init(tc, torch.device("cpu"), torch.Generator().manual_seed(0))
    got = dict(tr.RWKV6(tc, init).named_parameters())
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert tuple(got[k].shape) == a.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(a.dtype), k
    for k in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "w0", "bonus_u",
              "ln_scale", "cmix_k", "cmix_r"):        # the constant inits
        _close(got[k], want[k], atol=0, rtol=0, msg=k)


@pytest.mark.parametrize("carried", [False, True])
def test_time_mix_matches(carried):
    """Output, final state and last token, from the zero state and from
    a carried state and last token."""
    jc, tc = _cfgs()
    p = _params(jc)
    x = _rand(1, B, 12, D)
    kw_j, kw_t = {}, {}
    if carried:
        st, last = _rand(2, B, H, HD, HD), _rand(3, B, D)
        kw_j = dict(state=jnp.asarray(st), last_x=jnp.asarray(last))
        kw_t = dict(state=torch.from_numpy(st), last_x=torch.from_numpy(last))
    want = jr.rwkv6_time_mix(p, jc, jnp.asarray(x), **kw_j)
    got = tr.rwkv6_time_mix(_torch(p), tc, torch.from_numpy(x), **kw_t)
    for g, w, name in zip(got, want, ("out", "state", "last_x")):
        _close(g, w, msg=name)
    assert got[1].dtype == torch.float32


@pytest.mark.parametrize("carried", [False, True])
def test_channel_mix_matches(carried):
    jc, tc = _cfgs()
    p = _params(jc, seed=1)
    x = _rand(4, B, 12, D)
    last = _rand(5, B, D) if carried else None
    want = jr.rwkv6_channel_mix(p, jc, jnp.asarray(x),
                                last_x=None if last is None
                                else jnp.asarray(last))
    got = tr.rwkv6_channel_mix(_torch(p), tc, torch.from_numpy(x),
                               last_x=None if last is None
                               else torch.from_numpy(last))
    _close(got[0], want[0])
    _close(got[1], want[1], atol=0, rtol=0)


def test_chunked_scan_equals_unchunked_and_the_reference():
    """rwkv_chunk = 4 over S = 16 (four chunks) against the plain scan
    (chunk past S) in the port, and each against the reference's."""
    jc, tc = _cfgs(rwkv_chunk=4)
    p = _params(jc, seed=2)
    x = _rand(6, B, 16, D)
    tp = _torch(p)
    y1, s1, _ = tr.rwkv6_time_mix(tp, tc, torch.from_numpy(x))
    y2, s2, _ = tr.rwkv6_time_mix(
        tp, dataclasses.replace(tc, rwkv_chunk=1 << 30), torch.from_numpy(x))
    _close(y1, y2.numpy())
    _close(s1, s2.numpy())
    want = jr.rwkv6_time_mix(p, jc, jnp.asarray(x))
    _close(y1, want[0])
    _close(s1, want[1])


@pytest.mark.parametrize("chunk", [4, 1 << 30])
def test_gradients_match_jax_grad(chunk):
    """Gradients of a random projection of the time mix and channel mix
    outputs and the final state (chunk 4: through the checkpointed
    chunks, 2^30: the plain loop) against ``jax.grad``; the reference
    runs its own chunking (``jax.checkpoint``) at the same chunk."""
    jc, tc = _cfgs(rwkv_chunk=chunk)
    p = _params(jc, seed=3)
    x = _rand(7, B, 16, D)
    proj = _rand(8, B, 16, D)
    sproj = _rand(9, B, H, HD, HD)

    def jloss(p, x):
        y, st, _ = jr.rwkv6_time_mix(p, jc, x)
        c, _ = jr.rwkv6_channel_mix(p, jc, x)
        return (y * proj).sum() + (c * proj).sum() + (st * sproj).sum()

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = _torch(p, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y, st, _ = tr.rwkv6_time_mix(tp, tc, tx)
    c, _ = tr.rwkv6_channel_mix(tp, tc, tx)
    tproj = torch.from_numpy(proj)
    ((y * tproj).sum() + (c * tproj).sum()
     + (st * torch.from_numpy(sproj)).sum()).backward()
    for k, g in jg.items():
        _close(tp[k].grad, g, atol=GRAD_ATOL, rtol=GRAD_RTOL, msg=k)
    _close(tx.grad, jgx, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_decode_steps_match_reference_and_the_scan():
    """Six ``rwkv6_decode`` steps from ``init_rwkv_cache``: output and
    cache equal the reference's at each step (``cm_x`` passes through),
    the input cache is left as it was, and the outputs equal one time
    mix over the six tokens."""
    jc, tc = _cfgs()
    p = _params(jc, seed=4)
    x = _rand(10, B, 6, D)
    tp = _torch(p)
    jcache = jr.init_rwkv_cache(jc, B, jnp.float32)
    tcache = tr.init_rwkv_cache(tc, B, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    outs = []
    for t in range(6):
        xt = x[:, t:t + 1]
        want, jcache = jr.rwkv6_decode(p, jc, jnp.asarray(xt), jcache)
        before = {k: v.clone() for k, v in tcache.items()}
        got, new = tr.rwkv6_decode(tp, tc, torch.from_numpy(xt), tcache)
        for k in tcache:
            assert torch.equal(tcache[k], before[k]), k
        tcache = new
        _close(got, want, msg=f"step {t}")
        for k in new:
            _close(new[k], jcache[k], msg=f"step {t} {k}")
        outs.append(got)
    full, _, _ = tr.rwkv6_time_mix(tp, tc, torch.from_numpy(x))
    _close(torch.cat(outs, dim=1), full.numpy())


def test_bf16_carry_dtype():
    """bf16 activations stay bf16 through the time and channel mix (the
    fp32 ratios must not promote the residual stream — the reference's
    ``test_bf16_forward_carry_dtypes``); the state stays fp32."""
    _, tc = _cfgs(dtype="bfloat16")
    init = _Init(tc, torch.device("cpu"), torch.Generator().manual_seed(2))
    mod = tr.RWKV6(tc, init)
    x = torch.from_numpy(_rand(11, B, 8, D)).to(torch.bfloat16)
    with torch.no_grad():
        y, st, last = tr.rwkv6_time_mix(mod, tc, x)
        c, cl = tr.rwkv6_channel_mix(mod, tc, x)
        assert tr._mix(x, x, mod["mix_r"]).dtype == torch.bfloat16
    assert y.dtype == c.dtype == last.dtype == cl.dtype == torch.bfloat16
    assert st.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(c.float()).all()
