"""Port parity: the vlm (llama-3.2-vision) and audio (whisper) families
through the whole model — ``forward`` / ``loss_fn`` and every gradient,
the audio encoder, the GELU MLP, ``params_from_jax``, the pipeline's
batches and ``train()`` — against the JAX reference on the same numpy
inputs and weights.

SMOKE configs, fp32: vlm 4 layers (2 self in 2 groups of 1, 2 cross
layers), 8 image tokens; audio 2 encoder + 2 decoder layers, layernorm,
GELU, 16 frames.  The vlm gates are opened (they init closed, tanh(0) =
0), so the cross layers reach the loss.  Tolerances: loss 1e-5
relative, gradients 1e-5 + 1e-4 relative (fp32 summation order over 4
layers), train() losses and grad norms 1e-4 relative."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.data.pipeline import SyntheticLM as JLM  # noqa: E402
from repro.distributed import ctx as dctx  # noqa: E402
from repro.launch.train import train as jtrain  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM as TLM  # noqa: E402
from repro_torch.launch.train import train as ttrain  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tmdl  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
TRAIN_RTOL = 1e-4
MM_ATOL = 1e-5
VLM, AUDIO = "llama-3.2-vision-90b", "whisper-base"


@pytest.fixture(autouse=True)
def _no_reference_mesh():
    """The JAX ``train()`` installs a device mesh; clear it around each
    test so no other test's reference runs under it."""
    dctx.clear()
    yield
    dctx.clear()


def _cfgs(arch, **kw):
    return [dataclasses.replace(s[arch], **kw) for s in (jarchs.SMOKE,
                                                          TSMOKE)]


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _params(arch, cfg, seed=0):
    """The reference's parameters; vlm's gates opened to 0.7 / -0.4."""
    p = jmdl.init_params(jax.random.PRNGKey(seed), cfg)
    if arch == VLM:
        cl = p["cross_layers"]
        p = {**p, "cross_layers": {
            **cl, "gate": jnp.full_like(cl["gate"], 0.7),
            "gate_mlp": jnp.full_like(cl["gate_mlp"], -0.4)}}
    return p


def _leaf(model, cfg, keys, grad=False):
    """The port's tensor (or its gradient) at a reference path, stacked
    like the reference's leaf (vlm's ``layers`` as (n_cross, per_group,
    ...))."""
    def one(m, keys):
        for k in keys:
            m = m[k]
        return m.grad if grad else m

    group = keys[0]
    if group not in ("layers", "cross_layers", "enc_layers"):
        return one(model, keys)
    t = torch.stack([one(m, keys[1:]) for m in model[group]])
    if group == "layers" and cfg.family == "vlm":
        n_cross, per_group = tmdl.vlm_groups(cfg)
        t = t.reshape((n_cross, per_group) + t.shape[1:])
    return t


def _paths(tree):
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield [p.key for p in path], np.asarray(a)


def _batch(cfg, seed, b=2, s=16):
    """The pipeline's batch (tokens, labels, loss_mask and the context)."""
    return JLM(cfg, b, s, seed=seed).next_batch()


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_params_from_jax_round_trips_every_leaf(arch):
    """Every reference leaf lands in the port's model (vlm's nested
    (n_cross, per_group) self layers flattened in that order); a missing
    or an unexpected leaf is refused."""
    jc, tc = _cfgs(arch)
    params = _params(arch, jc)
    model = tmdl.params_from_jax(_np_tree(params), tc, device="cpu")
    n = 0
    for keys, a in _paths(params):
        got = _leaf(model, tc, keys).detach().numpy()
        np.testing.assert_array_equal(got, a, err_msg=str(keys))
        n += got.size
    assert n == sum(p.numel() for p in model.parameters())
    if arch == VLM:
        assert len(model.layers) == 2 and len(model.cross_layers) == 2
        assert model.cross_layers[0].gate.shape == ()
    else:
        assert len(model.enc_layers) == 2 and len(model.layers) == 2
        assert not hasattr(model.layers[0].mlp, "wg")     # GELU: wi, wo
    bad = _np_tree(params)
    key = "cross_layers" if arch == VLM else "enc_ln"
    dropped = {k: v for k, v in bad.items() if k != key}
    with pytest.raises(ValueError, match="missing"):
        tmdl.params_from_jax(dropped, tc, device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        tmdl.params_from_jax({**bad, "shared_in": np.zeros((2, 2))}, tc,
                             device="cpu")


def test_gelu_mlp_matches():
    """The tanh-approximate GELU MLP (whisper's ``mlp_variant``)."""
    jc, tc = _cfgs(AUDIO)
    rng = np.random.default_rng(0)
    p = {"wi": rng.standard_normal((64, 128)).astype(np.float32) / 8,
         "wo": rng.standard_normal((128, 64)).astype(np.float32) / 8}
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    got = tl.mlp_apply({n: torch.from_numpy(a) for n, a in p.items()}, tc,
                       torch.from_numpy(x))
    want = jl.mlp_apply({n: jnp.asarray(a) for n, a in p.items()}, jc,
                        jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MM_ATOL,
                               rtol=0)


def test_audio_encoder_matches_and_is_not_causal():
    """``_run_encoder``: decoder blocks without the causal mask, then
    ``enc_ln``.  The last frame moves the first frame's output."""
    jc, tc = _cfgs(AUDIO)
    params = _params(AUDIO, jc)
    model = tmdl.params_from_jax(_np_tree(params), tc, device="cpu")
    emb = np.random.default_rng(1).standard_normal(
        (2, jc.encoder_len, 64)).astype(np.float32)
    got = tmdl._run_encoder(model, tc, torch.from_numpy(emb))
    want = jmdl._run_encoder(params, jc, jnp.asarray(emb))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=MM_ATOL, rtol=0)
    emb[:, -1] += 2.0
    moved = tmdl._run_encoder(model, tc, torch.from_numpy(emb))
    assert (moved[:, 0] - got[:, 0]).abs().max() > 0


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_forward_loss_and_grads_match(arch, remat):
    """``forward`` / ``loss_fn`` (logits, loss, nll, aux = 0) and every
    parameter's gradient — the gates', the cross layers' and the
    encoder's among them — against the reference, under each remat
    policy (the cross blocks run under the checkpoint with the context
    captured)."""
    jc, tc = _cfgs(arch, remat=remat)
    params = _params(arch, jc, seed=1)
    model = tmdl.params_from_jax(_np_tree(params), tc, device="cpu")
    batch = _batch(jc, 7)
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    jlogits, _ = jmdl.forward(params, jc, batch)
    tlogits, taux = tmdl.forward(model, tc, tb)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    assert taux.item() == 0.0
    (jl_, jparts), jg = jax.value_and_grad(
        lambda p: jmdl.loss_fn(p, jc, batch), has_aux=True)(params)
    tl_, tparts = tmdl.loss_fn(model, tc, tb)
    tl_.backward()
    np.testing.assert_allclose(tl_.item(), float(jl_), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tparts["nll"].item(), float(jparts["nll"]),
                               rtol=LOSS_RTOL)
    for keys, g in _paths(jg):
        tg = _leaf(model, tc, keys, grad=True)
        np.testing.assert_allclose(tg.numpy(), g, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=str(keys))
    if arch == VLM:
        assert model.cross_layers[0].gate.grad.abs() > 0


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_pipeline_batches_match(arch):
    """The context is drawn after the tokens from the same generator, so
    every array equals the reference's, over three steps."""
    jc, tc = _cfgs(arch)
    jp, tp = JLM(jc, 2, 16, seed=5), TLM(tc, 2, 16, seed=5)
    key = "image_embeds" if arch == VLM else "audio_embeds"
    for _ in range(3):
        want, got = jp.next_batch(), tp.next_batch()
        assert sorted(got) == sorted(want)
        assert got[key].dtype == np.float32
        assert got[key].shape == (2, jc.n_image_tokens if arch == VLM
                                  else jc.encoder_len, 64)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_train_three_steps_matches_reference(arch):
    """``train()`` of the SMOKE config from the reference's seed-0
    weights (vlm's gates closed, as initialised: the first step opens
    them): the reference's losses and grad norms."""
    jc, tc = _cfgs(arch)
    kw = dict(steps=3, batch=2, seq=16, log_every=10, seed=0)
    want = jtrain(arch, smoke=True, **kw)
    dctx.clear()
    model = tmdl.params_from_jax(
        _np_tree(jmdl.init_params(jax.random.PRNGKey(0), jc)), tc,
        device="cpu")
    got = ttrain(arch, smoke=True, model=model, device="cpu", **kw)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=TRAIN_RTOL)
    np.testing.assert_allclose(got["gnorms"], want["gnorms"],
                               rtol=TRAIN_RTOL)
    if arch == VLM:
        assert float(model.cross_layers[0].gate.detach().abs()) > 0
