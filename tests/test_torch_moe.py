"""Port parity: the MoE FFN (``models/moe.py``) against
``repro.models.moe`` on the same numpy-seeded inputs and weights.

Two configs: SMOKE qwen3-moe-235b-a22b's moe widths (4 experts, top-2,
group 16, d_model 64, d_ff 128) and a variant with 8 experts, top-2 and
a capacity factor of 0.5, so a group of 16 overflows its experts
(capacity 2) and drops tokens.  fp32.

Exact: expert ids, the kept mask, the capacity and the position in
expert (the reference's routing lines run in JAX beside the port's
``route``).  Within tolerances: the output (atol 1e-5), the aux loss
(rtol 1e-5) and the gradients of router, experts and input (atol 1e-5
+ rtol 1e-4) — fp32 summation order in the products and the softmax.
The port's index dispatch is also held to its one-hot einsum form
(``moe_apply_ref``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import argsort_descending as jargsort  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import argsort_descending  # noqa: E402

OUT_ATOL = 1e-5
AUX_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
ARCH = "qwen3-moe-235b-a22b"
VARIANTS = {"smoke": {}, "e8_overflow": dict(n_experts=8,
                                              capacity_factor=0.5)}


def _cfgs(**kw):
    return [dataclasses.replace(s[ARCH], **kw) for s in (JSMOKE, TSMOKE)]


def _weights(jc, seed=0):
    params = jmoe.moe_init(jax.random.PRNGKey(seed), jc)
    return params, {n: torch.from_numpy(np.array(a)) for n, a in
                    params.items()}


def _x(seed, b, s, d=64):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _jax_route(params, cfg, x):
    """The reference's routing lines (``repro/models/moe.py``), in JAX:
    → (expert ids, kept, position in expert, capacity)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    gsz = min(cfg.moe_group_size, b * s)
    tokens = jnp.asarray(x).reshape(-1, gsz, d)
    ng = tokens.shape[0]
    cap = jmoe._capacity(cfg, gsz)
    logits = jnp.einsum("gtd,de->gte", tokens.astype(jnp.float32),
                        params["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    ids = jargsort(probs)[..., :k]
    onehot = jax.nn.one_hot(ids, e, dtype=jnp.float32)
    flat = onehot.reshape(ng, gsz * k, e)
    pie = (jnp.cumsum(flat, axis=1) - flat).reshape(ng, gsz, k, e)
    keep = (pie < cap) & (onehot > 0)
    pie = jnp.where(keep, pie, 0.0)
    return (np.asarray(ids), np.asarray(keep.any(-1)),
            np.asarray(pie.sum(-1)).astype(np.int64), cap)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_routing_is_exactly_the_reference(variant):
    jc, tc = _cfgs(**VARIANTS[variant])
    params, tp = _weights(jc)
    x = _x(1, 2, 16)
    ids, keep, pie, cap = _jax_route(params, jc, x)
    r = tmoe.route(tp, tc, torch.from_numpy(x).reshape(-1, 16, 64))
    assert r.cap == cap == tmoe._capacity(tc, 16)
    assert r.expert_ids.dtype == torch.int32
    np.testing.assert_array_equal(r.expert_ids.numpy(), ids)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.pie.numpy(), pie)
    if variant == "e8_overflow":
        assert cap == 2 and not keep.all()          # tokens are dropped


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("shape", [(2, 16), (1, 48), (4, 1)],
                         ids=["two_groups", "three_groups", "decode_b4"])
def test_output_and_aux_match(variant, shape):
    """Several groups (a prompt), and one group of four tokens (a decode
    step over four slots)."""
    jc, tc = _cfgs(**VARIANTS[variant])
    params, tp = _weights(jc)
    x = _x(2, *shape)
    jy, jaux = jmoe.moe_apply(params, jc, jnp.asarray(x))
    ty, taux = tmoe.moe_apply(tp, tc, torch.from_numpy(x))
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=OUT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=AUX_RTOL)
    ry, raux, rids, rkeep = tmoe.moe_apply_ref(tp, tc, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), ry.numpy(), atol=1e-6, rtol=0)
    assert taux.item() == pytest.approx(raux.item(), rel=1e-6)
    r = tmoe.route(tp, tc, tmoe._groups(tc, torch.from_numpy(x)))
    assert torch.equal(rids, r.expert_ids) and torch.equal(rkeep, r.keep)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gradients_match(variant):
    """d(Σ y·c + 3·aux) w.r.t. router, wi, wg, wo and the input."""
    jc, tc = _cfgs(**VARIANTS[variant])
    params, tp = _weights(jc)
    x = _x(3, 2, 16)
    cot = _x(4, 2, 16)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, jc, xx)
        return (y * cot).sum() + 3.0 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tp = {n: t.requires_grad_() for n, t in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_apply(tp, tc, tx)
    ((y * torch.from_numpy(cot)).sum() + 3.0 * aux).backward()
    for n in ("router", "wi", "wg", "wo"):
        np.testing.assert_allclose(tp[n].grad.numpy(), np.asarray(jgp[n]),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=n)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_argsort_descending_ties_go_to_the_higher_index():
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0]],
                 np.float32)
    want = np.asarray(jargsort(jnp.asarray(x)))
    got = argsort_descending(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[0], [4, 2, 1, 0, 3])
    # torch's own descending stable sort would route the tie the other way
    assert torch.argsort(torch.from_numpy(x), dim=-1, descending=True,
                         stable=True)[0, 0] == 1


def test_router_ties_route_like_the_reference():
    """Experts 1 and 3 with identical router columns tie on every token:
    both packages send the token to expert 3 first."""
    jc, tc = _cfgs()
    params, _ = _weights(jc)
    router = np.array(params["router"])
    router[:, 1] = router[:, 3] = np.abs(router).max(axis=1) * 4
    params = dict(params, router=jnp.asarray(router))
    tp = {n: torch.from_numpy(np.array(a)) for n, a in params.items()}
    x = np.abs(_x(5, 1, 16))
    ids, keep, pie, _ = _jax_route(params, jc, x)
    r = tmoe.route(tp, tc, torch.from_numpy(x).reshape(1, 16, 64))
    np.testing.assert_array_equal(r.expert_ids.numpy(), ids)
    assert (ids[..., 0] == 3).all() and (ids[..., 1] == 1).all()
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.pie.numpy(), pie)


def test_tokens_not_a_multiple_of_the_group_raise_the_reference_error():
    """24 tokens over groups of 16: the reference's reshape fails, and so
    does the port, with the same type and message."""
    jc, tc = _cfgs()
    params, tp = _weights(jc)
    x = _x(6, 1, 24)
    with pytest.raises(TypeError) as jerr:
        jmoe.moe_apply(params, jc, jnp.asarray(x))
    with pytest.raises(TypeError) as terr:
        tmoe.moe_apply(tp, tc, torch.from_numpy(x))
    assert str(terr.value) == str(jerr.value)
    assert "(24, 64)" in str(terr.value)
