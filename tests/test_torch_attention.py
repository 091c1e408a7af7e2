"""Port parity: full-sequence attention (``attention_apply``) through the
SATA kernel route — chunked selection into the compacted grid, dense
selection through the SATA sort into the compacted or dense grid — and
through the dense top-k reference, outputs and gradients, against the
JAX reference on the same numpy inputs and weights.

The small GQA config of ``test_torch_train.py`` (4 query / 2 KV heads ×
16, S = 64, block 16, top-k 8), fp32.  Tolerances: outputs 1e-5,
gradients 1e-5 + 1e-4 relative (fp32 summation order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distributed import ctx as dctx  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from test_torch_train import (GRAD_ATOL, GRAD_RTOL, OUT_ATOL, S,  # noqa: E402
                              _cfgs, _jax_params, _np_tree, _rand)


@pytest.fixture(autouse=True)
def _no_reference_mesh():
    """A JAX ``train()`` that raised leaves its mesh installed, which
    would route the reference's attention away from its kernel."""
    dctx.clear()
    yield
    dctx.clear()


ROUTES = {  # name: (kernel on, topk_impl, schedule)
    "kernel_chunked": (True, "bisect", "compact"),
    "kernel_dense_compact": (True, "sort", "compact"),
    "kernel_dense_grid": (True, "sort", "dense"),
    "attend_bisect": (False, "bisect", "compact"),
    "attend_sort": (False, "sort", "compact"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_attention_apply_outputs_and_gradients_match(route):
    use, impl, schedule = ROUTES[route]
    jc, tc = _cfgs(use, impl, schedule)
    assert tattn._sata_kernel_ok(tc, S, False) == use
    p = _np_tree(_jax_params(jc))["layers"]["attn"]
    p = {n: a[0] for n, a in p.items()}
    x = _rand(1, 2, S, 64)
    ct = _rand(2, 2, S, 64)

    def jloss(pp, xx):
        return jnp.sum(jattn.attention_apply(pp, jc, xx) * ct)

    jout = jattn.attention_apply(jax.tree.map(jnp.asarray, p), jc,
                                 jnp.asarray(x))
    jg = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(x))
    tp = {n: torch.from_numpy(a).requires_grad_(True) for n, a in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = tattn.attention_apply(tp, tc, tx)
    (tout * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=OUT_ATOL, rtol=0)
    for n in p:
        np.testing.assert_allclose(tp[n].grad.numpy(), np.asarray(jg[0][n]),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=n)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_truncating_bound_refuses_the_backward():
    """A max_kv_blocks below the occupancy truncates the forward; the
    backward refuses to differentiate a different function, unless the
    loss-free dense fallback is on."""
    x = torch.from_numpy(_rand(3, 1, S, 64))
    for fallback, raises in (("truncate", True), ("dense", False)):
        _, tc = _cfgs(max_kv_blocks=2, bound_fallback=fallback)
        model = tmodel.DenseModel(tc, device="cpu", seed=0)
        out = tattn.attention_apply(model.layers[0].attn, tc, x)
        if raises:
            with pytest.raises(NotImplementedError, match="truncating"):
                out.sum().backward()
        else:
            out.sum().backward()
            assert model.layers[0].attn.wq.grad is not None
    with pytest.raises(NotImplementedError, match="truncating"):
        tattn._check_bwd_untruncated(2, 4)
    tattn._check_bwd_untruncated(2, 4, on_exceed="dense")
    tattn._check_bwd_untruncated(None, 4)
