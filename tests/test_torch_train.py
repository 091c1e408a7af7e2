"""Port parity: the forward and training path — full-sequence attention
through the SATA kernel route (both selection routes) and its gradients,
the optimizer, the data pipeline, checkpointing, and ``train()`` —
against the JAX reference on the same numpy inputs and weights.

A small GQA config (2 layers, d_model 64, 4 query / 2 KV heads × 16,
S = 64, block 16, q_chunk 16, top-k 8), fp32.  Tolerances: attention
outputs 1e-5 and gradients 1e-5 + 1e-4 relative (fp32 summation order);
train() losses and grad norms 1e-4 relative, final params 1e-5.

The JAX ``train()`` always installs a device mesh, which routes its
attention through ``_attend`` (its Pallas kernel has no partitioning
rule); the port's ``train()`` has no mesh and runs the kernel route.
Both compute the same function, so the comparison holds the port's
kernel route to the reference's dense top-k attention."""
import dataclasses
import functools

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
from repro.models import model as jmodel  # noqa: E402
from repro.models.config import SataKernelConfig as JK  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.train.step import make_prefill_step as jprefill  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM as TLM  # noqa: E402
from repro_torch.launch.train import train as ttrain  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.config import SataKernelConfig as TK  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.train.step import make_prefill_step as tprefill  # noqa: E402

OUT_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
TRAIN_RTOL, PARAM_ATOL = 1e-4, 1e-5
S = 64


@pytest.fixture(autouse=True)
def _no_reference_mesh():
    """A JAX ``train()`` that raised leaves its mesh installed, which
    would route the reference's attention away from its kernel."""
    dctx.clear()
    yield
    dctx.clear()


def _cfgs(use=True, impl="bisect", schedule="compact", remat="none", **kern):
    """The same small GQA config on both sides."""
    out = []
    for smoke, kc in ((jarchs.SMOKE, JK), (TSMOKE, TK)):
        base = smoke["qwen3-4b"]
        out.append(dataclasses.replace(
            base, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, q_chunk=16, topk_k=8, topk_impl=impl,
            remat=remat, dtype="float32",
            sata=dataclasses.replace(base.sata, kernel=kc(
                use=use, block=16, schedule=schedule, **kern))))
    return out


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _jax_params(cfg, seed=0):
    return jmodel.init_params(jax.random.PRNGKey(seed), cfg)


def _port_model(np_params, cfg):
    return tmodel.params_from_jax(_np_tree(np_params), cfg, device="cpu")


def _port_leaf(model, path):
    """The port's tensor for a reference leaf path, (L, ...) for layers."""
    if path[0] == "layers":
        return torch.stack([model.layers[i][path[1]][path[2]].detach()
                            for i in range(len(model.layers))])
    return model[path[0]][path[1]].detach()


def _paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(k.key for k in p), np.asarray(a)) for p, a in flat]


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@functools.cache
def _loss_and_grads(remat):
    """Loss and parameter gradients of one batch on both sides:
    ``(jax loss, port loss, [(path, jax grad, port grad)])``."""
    jc, tc = _cfgs(remat=remat)
    params = _jax_params(jc)
    model = _port_model(params, tc)
    batch = JLM(jc, 2, S, seed=0).next_batch()
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    (jl, _), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jc, batch), has_aux=True)(params)
    tl, _ = tmodel.loss_fn(model, tc, tb)
    tl.backward()
    grads = []
    for path, g in _paths(jg):
        if path[0] == "layers":
            tg = torch.stack([model.layers[i][path[1]][path[2]].grad
                              for i in range(2)])
        else:
            tg = model[path[0]][path[1]].grad
        grads.append((path, g, tg))
    return float(jl), tl.item(), grads


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_forward_and_loss_match(remat):
    jl, tl, grads = _loss_and_grads(remat)
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_RTOL)
    for path, g, tg in grads:
        np.testing.assert_allclose(tg.numpy(), g, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=str(path))


def test_remat_dots_is_queued_not_ported():
    """The ``"dots"`` policy, once queued, is ported: through the SATA
    kernel route its loss and gradients equal ``"none"``'s bitwise (the
    recompute runs the same ops at the same shapes)."""
    jl_none, tl_none, g_none = _loss_and_grads("none")
    _, tl_dots, g_dots = _loss_and_grads("dots")
    assert tl_dots == tl_none
    for (path, _, a), (_, _, b) in zip(g_none, g_dots):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("micro_steps", [1, 2])
def test_train_three_steps_matches_reference(monkeypatch, micro_steps):
    """Without gradient compression (its int8 rounding turns fp32
    summation-order differences into whole code steps: ROADMAP C2, held
    by the two tests below)."""
    jc, tc = _cfgs(remat="full")
    monkeypatch.setitem(jarchs.SMOKE, "tiny-gqa", jc)
    kw = dict(steps=3, batch=2, seq=S, micro_steps=micro_steps,
              log_every=10, seed=0)
    want = jtrain("tiny-gqa", smoke=True, **kw)
    model = _port_model(_jax_params(jc, seed=0), tc)
    got = ttrain("tiny-gqa", cfg=tc, model=model, device="cpu", **kw)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=TRAIN_RTOL)
    np.testing.assert_allclose(got["gnorms"], want["gnorms"],
                               rtol=TRAIN_RTOL)
    for path, a in _paths(want["final_state"]["params"]):
        np.testing.assert_allclose(_port_leaf(model, path).numpy(), a,
                                   atol=PARAM_ATOL, rtol=0,
                                   err_msg=str(path))


def test_moe_train_steps_and_aux_metric_match_reference(monkeypatch):
    """SMOKE qwen3-moe (4 experts, top-2, group 16; remat="dots"), batch
    2 × 16 tokens (two groups): three ``train()`` steps give the
    reference's losses and grad norms, and one ``make_train_step`` gives
    its metrics, the router's aux loss among them."""
    from repro.train.step import make_train_step as jstep
    from repro_torch.train.step import make_train_step as tstep
    jc, tc = (dataclasses.replace(s["qwen3-moe-235b-a22b"], remat="dots")
              for s in (jarchs.SMOKE, TSMOKE))
    monkeypatch.setitem(jarchs.SMOKE, "tiny-moe", jc)
    kw = dict(steps=3, batch=2, seq=16, log_every=10, seed=0)
    want = jtrain("tiny-moe", smoke=True, **kw)
    model = _port_model(_jax_params(jc, seed=0), tc)
    got = ttrain("tiny-moe", cfg=tc, model=model, device="cpu", **kw)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=TRAIN_RTOL)
    np.testing.assert_allclose(got["gnorms"], want["gnorms"],
                               rtol=TRAIN_RTOL)
    dctx.clear()
    params = _jax_params(jc, seed=1)
    batch = JLM(jc, 2, 16, seed=1).next_batch()
    opt = jadam.OptConfig(warmup_steps=2, decay_steps=3)
    _, jm = jstep(jc, opt)({"params": params,
                            "opt": jadam.init_opt_state(params)}, batch)
    model = _port_model(params, tc)
    topt = tadam.OptConfig(warmup_steps=2, decay_steps=3)
    state = {"params": model,
             "opt": tadam.init_opt_state(dict(model.named_parameters()))}
    _, tm = tstep(tc, topt)(state, {k: torch.from_numpy(a)
                                    for k, a in batch.items()})
    assert sorted(tm) == sorted(jm)
    assert float(tm["aux"]) > 0
    for k in ("loss", "nll", "aux", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=TRAIN_RTOL, err_msg=k)


def test_compressed_adamw_step_matches_on_equal_gradients():
    """int8 error-feedback compression + AdamW, one step from the same
    params, gradients, moments and error buffers on both sides."""
    rng = np.random.default_rng(11)
    names = ("a", "b")
    p = {n: rng.standard_normal((8, 6)).astype(np.float32) for n in names}
    g = {n: rng.standard_normal((8, 6)).astype(np.float32) for n in names}
    e = {n: 1e-3 * rng.standard_normal((8, 6)).astype(np.float32)
         for n in names}
    opt = dict(warmup_steps=2, decay_steps=3, compress_grads=True)
    jst = jadam.init_opt_state({n: jnp.asarray(a) for n, a in p.items()})
    jp, jst, je, jm = jadam.adamw_update(
        jadam.OptConfig(**opt), {n: jnp.asarray(a) for n, a in p.items()},
        {n: jnp.asarray(a) for n, a in g.items()}, jst,
        {n: jnp.asarray(a) for n, a in e.items()})
    tp = {n: torch.from_numpy(a.copy()) for n, a in p.items()}
    tst = tadam.init_opt_state(tp)
    tp, tst, te, tm = tadam.adamw_update(
        tadam.OptConfig(**opt), tp,
        {n: torch.from_numpy(a) for n, a in g.items()}, tst,
        {n: torch.from_numpy(a) for n, a in e.items()})
    for n in names:
        for got, want in ((tp[n], jp[n]), (te[n], je[n]),
                          (tst["m"][n], jst["m"][n]),
                          (tst["v"][n], jst["v"][n])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    assert int(tst["step"]) == int(jst["step"]) == 1


def test_compression_flips_are_single_codes_at_midpoints():
    """ROADMAP C2: the two packages' fp32 gradients differ in summation
    order only, and int8 compression turns that into whole-code
    differences for the few elements that sit on a rounding midpoint —
    which is why compressed training drifts between the packages."""
    n_flip = n_all = 0
    for path, g, tg in _loss_and_grads("none")[2]:
        z = torch.zeros_like(tg)
        dq_t = tadam.compress_int8(tg, z)[0].numpy()
        dq_j = tadam.compress_int8(torch.from_numpy(g), z)[0].numpy()
        scale = float(np.abs(g).max()) / 127.0
        codes = np.abs(np.round(dq_t / scale) - np.round(dq_j / scale))
        flips = codes > 0
        assert codes.max() <= 1, path
        frac = np.abs(g / scale) % 1.0
        assert (np.abs(frac[flips] - 0.5) < 1e-3).all(), path
        n_flip += int(flips.sum())
        n_all += g.size
    print(f"int8 codes that differ: {n_flip} of {n_all}")
    assert n_flip <= 1e-3 * n_all


def test_crash_then_resume_gives_the_uninterrupted_losses(tmp_path):
    _, tc = _cfgs(remat="full")
    kw = dict(cfg=tc, steps=5, batch=2, seq=S, log_every=10, device="cpu")
    ref = ttrain("tiny-gqa", **kw)
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        ttrain("tiny-gqa", ckpt_dir=str(tmp_path), ckpt_every=1, fail_at=3,
               **kw)
    resumed = ttrain("tiny-gqa", ckpt_dir=str(tmp_path), ckpt_every=1, **kw)
    assert resumed["losses"] == ref["losses"][3:]
    assert resumed["gnorms"] == ref["gnorms"][3:]
    for (n, a), (_, b) in zip(
            ref["final_state"]["params"].state_dict().items(),
            resumed["final_state"]["params"].state_dict().items()):
        assert torch.equal(a, b), n


def test_async_snapshot_owns_its_copy(tmp_path):
    """An in-place update right after an async save must not reach the
    checkpoint."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    w = torch.arange(1 << 16, dtype=torch.float32)
    h = torch.ones(3, dtype=torch.bfloat16)
    state = {"w": w, "sub": {"h": h}}
    mgr.save(1, state, extra={"k": 1}, blocking=False)
    w.add_(1.0)
    h.mul_(3.0)
    mgr.wait()
    fresh = {"w": torch.zeros_like(w), "sub": {"h": torch.zeros_like(h)}}
    mgr.restore(fresh)
    assert torch.equal(fresh["w"], torch.arange(1 << 16,
                                                dtype=torch.float32))
    assert torch.equal(fresh["sub"]["h"], torch.ones(3,
                                                     dtype=torch.bfloat16))
    for s in (2, 3):
        mgr.save(s, state)
    assert mgr.all_steps() == [2, 3] and mgr.manifest()["step"] == 3
    with pytest.raises(ValueError, match="leaves differ"):
        mgr.restore({"w": w})


def test_pipeline_and_optimizer_pieces_match():
    jc, tc = _cfgs()
    jp, tp = JLM(jc, 3, 16, seed=5), TLM(tc, 3, 16, seed=5)
    for _ in range(2):
        a, b = jp.next_batch(), tp.next_batch()
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    opt = jadam.OptConfig(warmup_steps=3, decay_steps=10)
    topt = tadam.OptConfig(warmup_steps=3, decay_steps=10)
    for step in (0, 1, 3, 7, 12):
        np.testing.assert_allclose(
            float(tadam.lr_at(topt, torch.tensor(step))),
            float(jadam.lr_at(opt, jnp.asarray(step))), rtol=1e-6)
    g, e = _rand(6, 40), _rand(7, 40) * 1e-3
    for got, want in zip(tadam.compress_int8(torch.from_numpy(g),
                                             torch.from_numpy(e)),
                         jadam.compress_int8(jnp.asarray(g), jnp.asarray(e))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


def test_prefill_step_schedules_agree_and_match_reference():
    """Dense selection (topk_impl="sort") through the SATA sort: the
    compacted and dense grids give the same logits bitwise, and both
    match the reference's."""
    logits = {}
    for schedule in ("compact", "dense"):
        jc, tc = _cfgs(impl="sort", schedule=schedule)
        params = _jax_params(jc)
        batch = JLM(jc, 2, S, seed=4).next_batch()
        want = jprefill(jc)(params, batch)
        got = tprefill(tc)(_port_model(params, tc),
                           {k: torch.from_numpy(a) for k, a in batch.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=0)
        logits[schedule] = got
    assert torch.equal(logits["compact"], logits["dense"])
