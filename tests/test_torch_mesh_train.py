"""Port parity for training on a ("data", "model") mesh of gloo ranks:
``train(mesh=)`` with the FSDP / tensor-parallel placements of
``distributed.sharding`` (``tests/torch_mesh_train_ranks.py``).

A world of 4 ranks trains on the (2, 2) mesh and a world of 2 on (2, 1)
and (1, 2), each started once for the module through a ``FileStore``
under the test's temp directory; the reference's ``train`` runs on the
same mesh shapes in a subprocess with 4 forced host devices and
``AxisType.Auto`` meshes; all three start together.  Cases
(``CASES``): SMOKE qwen3-4b (tensor-parallel attention and MLP on 2 of
4 heads), SMOKE qwen3-moe (tensor-parallel attention, the experts
gathered by the ``expert_shard`` rule) and qwen3-4b's SMOKE config on
the SATA kernel route (the compacted-grid kernel's plain version on the
rank's 2 of 4 query heads over 1 of 2 KV heads), 3 steps each from the
reference's weights.

Not bitwise: the data-parallel gradient sums (reduce-scatter over the
data ranks), the row-parallel out-projections' all-reduce and the
sharded sums of squares of the gradient norm add fp32 partial sums in
another order than one device.  Against the port's one-rank run and
against the reference's ``train`` on the same mesh: losses and grad
norms 1e-4 relative, final parameters 1e-5 absolute (fp32 summation
order; ``tests/test_torch_train.py``'s ``TRAIN_RTOL`` / ``PARAM_ATOL``).
The reference's mesh training routes attention through ``_attend`` (its
kernel has no SPMD rule): the kernel case holds the port's kernel route
to it, as ``test_torch_train.py`` does on one device.  Bitwise: a run
resumed on the mesh that saved it equals the uninterrupted run, and the
compressed AdamW step on the ranks' blocks equals the one-device step
(the absmax is the global one, reduced over the mesh).  bf16 qwen3-4b
on (4, 1) holds a data axis of four ranks, whose bf16 gradients are
summed in fp32, to one device in bf16 at bf16 tolerances."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402

import torch_mesh_train_ranks as R  # noqa: E402
from repro.configs import archs as jarchs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.config import SataKernelConfig as JK  # noqa: E402

TRAIN_RTOL, PARAM_ATOL = 1e-4, 1e-5
BF16_STEP0, BF16_LOSS_RTOL, BF16_GNORM_RTOL, BF16_PARAM_ATOL = \
    1e-5, 2e-3, 2e-2, 2 ** -8
WORKER = pathlib.Path(R.__file__)
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


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
    """(world 4's results, world 2's, the reference's arrays, tmp)."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    for case in {**R.CASES, **R.FAMILIES}:
        cfg = R.case_cfg(jarchs.SMOKE, case, JK)
        params = jmodel.init_params(jax.random.PRNGKey(0), cfg)
        np.savez(tmp / f"{case}.npz", **R.flat(params))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), str(WORKER.parent), os.environ.get("PYTHONPATH", "")]))
    ref = _start(["reference", tmp], dict(
        env, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    _finish([_start([r, 4, tmp], env) for r in range(4)])
    # world 2 resumes world 4's checkpoint
    _finish([_start([r, 2, tmp], env) for r in range(2)] + [ref])
    with np.load(tmp / "reference.npz") as z:
        want = {n: z[n] for n in z.files}
    return (torch.load(tmp / "world4.pt"), torch.load(tmp / "world2.pt"),
            want, tmp)


@pytest.fixture(scope="module")
def one_rank(runs):
    """Every case on one device, and the uninterrupted checkpoint run."""
    tmp = str(runs[3])
    out = {case: R.train_case(tmp, case, None) for case in R.CASES}
    for name, kw in R.VARIANTS.items():
        out[name] = R.train_case(tmp, "qwen3-4b", None, **kw)
    out["bf16"] = R.train_case(tmp, "qwen3-4b", None, dtype="bfloat16")
    return out


def _results(runs, shape):
    return runs[0] if shape == (2, 2) else runs[1]


def _close(got, want, what):
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=TRAIN_RTOL, err_msg=what)
    np.testing.assert_allclose(got["gnorms"], want["gnorms"],
                               rtol=TRAIN_RTOL, err_msg=what)
    assert set(got["params"]) == set(want["params"]), what
    for n, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), want["params"][n].numpy(),
                                   atol=PARAM_ATOL, rtol=0,
                                   err_msg=f"{what} {n}")


MESH_CASES = [(shape, case) for shapes in R.MESHES.values()
              for shape in shapes for case in R.CASES]


@pytest.mark.parametrize("shape,case", MESH_CASES,
                         ids=[f"{s[0]}x{s[1]}-{c}" for s, c in MESH_CASES])
def test_mesh_matches_one_rank(runs, one_rank, shape, case):
    """Losses, grad norms and the gathered final parameters of the mesh
    run against the port's one-device run."""
    _close(_results(runs, shape)[(shape, case)], one_rank[case],
           f"{shape} {case}")


@pytest.mark.parametrize("shape,case", MESH_CASES,
                         ids=[f"{s[0]}x{s[1]}-{c}" for s, c in MESH_CASES])
def test_mesh_matches_reference_on_the_same_mesh(runs, shape, case):
    got = _results(runs, shape)[(shape, case)]
    key = f"{shape[0]}x{shape[1]}/{case}"
    want = runs[2]
    np.testing.assert_allclose(got["losses"], want[key + "/losses"],
                               rtol=TRAIN_RTOL)
    np.testing.assert_allclose(got["gnorms"], want[key + "/gnorms"],
                               rtol=TRAIN_RTOL)
    names = {n[len(key + "/params/"):] for n in want
             if n.startswith(key + "/params/")}
    stacked = _stacked(got["params"])
    assert names == set(stacked)
    for n in names:
        np.testing.assert_allclose(stacked[n], want[f"{key}/params/{n}"],
                                   atol=PARAM_ATOL, rtol=0, err_msg=n)


def _stacked(params):
    """The port's parameters under the reference's names: ``layers.<i>.x``
    stacked into ``layers.x`` (L, ...)."""
    out, layers = {}, {}
    for n, p in params.items():
        parts = n.split(".")
        if parts[0] == "layers":
            layers.setdefault(".".join(["layers"] + parts[2:]), {})[
                int(parts[1])] = p.numpy()
        else:
            out[n] = p.numpy()
    for n, per in layers.items():
        out[n] = np.stack([per[i] for i in range(len(per))])
    return out


@pytest.mark.parametrize("case", sorted(R.FAMILIES))
def test_other_families_take_one_step_on_the_mesh(runs, case):
    """One step on (2, 2) against the port's one device: the loss and
    grad norm (before any update: summation order only) and the updated
    parameters.  One step, because SMOKE rwkv6's trajectory moves 0.56%
    under a 1e-7 weight perturbation after its first update (ROADMAP
    C7)."""
    one = R.train_case(str(runs[3]), case, None, steps=1)
    _close(runs[0][case], one, case)


def test_tensor_parallel_and_gathered_leaves(runs):
    """Under "model" = 2 the dense layers' attention and MLP projections
    stay sharded (7 a layer), qwen3-moe's attention projections (4 a
    layer) while its experts and router, the embedding and unembed are
    gathered; "model" = 1 shards nothing over it."""
    n = jarchs.SMOKE["qwen3-4b"].n_layers
    w2 = runs[1]
    assert w2[((1, 2), "qwen3-4b")]["counts"] == {
        "tensor_parallel": 7 * n, "gathered_over_model": 2}
    assert w2[((1, 2), "qwen3-moe")]["counts"] == {
        "tensor_parallel": 4 * n, "gathered_over_model": 2 + 3 * n}
    assert w2[((2, 1), "qwen3-4b")]["counts"] == {
        "tensor_parallel": 0, "gathered_over_model": 0}
    # CPU tensors go through gloo without a host copy
    assert w2[((2, 1), "staged")] == w2[((1, 2), "staged")] == 0


def test_compressed_adamw_uses_the_global_absmax(runs, one_rank):
    """The compressed step on the (2, 1) ranks' blocks equals the
    one-device step bit for bit (nothing clips, so the sharded norm's
    summation order does not reach the params); with each block's own
    absmax it would not.  ``train(compress_grads=True)`` on (2, 1)
    follows the one-device run's losses and grad norms."""
    a = runs[1]["adamw"]
    for n in ("a", "b"):
        for got, want in zip(a["got"][n], a["want"][n]):
            assert torch.equal(got, want), n
    assert any(not torch.equal(x, y) for n in ("a", "b") for x, y in zip(
        a["local_absmax"][n], (a["want"][n][0], a["want"][n][3])))
    np.testing.assert_allclose(*a["gnorm"], rtol=1e-6)
    got, want = runs[1][((2, 1), "compress")], one_rank["compress"]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=TRAIN_RTOL)
    np.testing.assert_allclose(got["gnorms"], want["gnorms"],
                               rtol=TRAIN_RTOL)


@pytest.mark.parametrize("variant", ["micro2", "batch1"])
def test_microbatches_and_a_replicated_batch(runs, one_rank, variant):
    """``micro_steps=2`` accumulates each microbatch's rows over the data
    ranks; a batch that does not divide by them replicates, each rank
    weighting its copy by 1 / 2: both against one device."""
    _close(runs[1][(R.COMPRESS_MESH, variant)], one_rank[variant], variant)


def test_bf16_gradients_summed_over_four_data_ranks(runs, one_rank):
    """bf16 SMOKE qwen3-4b on (4, 1), a row a rank, against one device
    in bf16.  Each rank's gradient of a weight is rounded to bf16 before
    the fp32 sum over the four ranks, one device's only after its fp32
    accumulation: step 0 (before any update) differs by that alone,
    within BF16_STEP0; later steps also follow parameters whose bf16
    updates rounded apart, within phase 8's bf16 limit on losses, 2e-2
    on grad norms and BF16_PARAM_ATOL (a bf16 ulp at 0.5) on the
    updated parameters."""
    got, want = runs[0]["bf16"], one_rank["bf16"]
    for key in ("losses", "gnorms"):
        np.testing.assert_allclose(got[key][0], want[key][0],
                                   rtol=BF16_STEP0, err_msg=key)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(got["gnorms"], want["gnorms"],
                               rtol=BF16_GNORM_RTOL)
    assert got["params"]["layers.0.attn.wq"].dtype == torch.bfloat16
    for n, p in got["params"].items():
        assert p.dtype == want["params"][n].dtype, n
        np.testing.assert_allclose(p.float().numpy(),
                                   want["params"][n].float().numpy(),
                                   atol=BF16_PARAM_ATOL, rtol=0, err_msg=n)


def test_elastic_restore_resumes_to_the_uninterrupted_losses(runs):
    """A checkpoint saved on (2, 2) at step 3 (by the injected failure):
    resumed on (2, 2) it gives the uninterrupted run's last two steps
    bit for bit; on one device and on (1, 2) within the tolerances."""
    w4, w2, _, tmp = runs
    assert w4["failed"] == ("RuntimeError", "injected failure at step 3")
    full = w4["uninterrupted"]
    res = w4["resumed"]
    assert res["losses"] == full["losses"][R.CKPT_FAIL:]
    assert res["gnorms"] == full["gnorms"][R.CKPT_FAIL:]
    for n, p in res["params"].items():
        assert torch.equal(p, full["params"][n]), n
    import shutil
    d = tmp / "ckpt_one"
    shutil.copytree(tmp / "ckpt_at_3", d)
    one = R.train_case(str(tmp), R.CKPT_CASE, None, ckpt_dir=str(d),
                       steps=R.CKPT_STEPS, ckpt_every=1)
    tail = {"losses": full["losses"][R.CKPT_FAIL:],
            "gnorms": full["gnorms"][R.CKPT_FAIL:],
            "params": full["params"]}
    _close(one, tail, "resumed on one device")
    _close(w2["resumed"], tail, "resumed on (1, 2)")


def test_mesh_refusals(runs):
    """A mesh whose size is not the world's, or without ("data",
    "model") axes, raises; nothing falls back to one rank."""
    for w in runs[:2]:
        kind, msg = w["refusals"]["size_mismatch"]
        assert kind == "ValueError" and "the world" in msg
        kind, msg = w["refusals"]["axes"]
        assert kind == "ValueError" and "('data', 'model')" in msg
