"""Port parity for training on a ("data", "model") mesh of gloo ranks:
``train(mesh=)`` with the FSDP / tensor-parallel placements of
``distributed.sharding`` (``tests/torch_mesh_train_ranks.py``).

A world of 4 ranks trains on the (2, 2) mesh and a world of 2 on (2, 1)
and (1, 2), each started once for the module through a ``FileStore``
under the test's temp directory; the reference's ``train`` runs on the
same mesh shapes in REF_PARTS subprocesses (each a share of the runs)
with 4 forced host devices and ``AxisType.Auto`` meshes, started with
world 4; the test process writes the weights meanwhile and runs the
port's one-device cases while world 2 and the reference run.  Cases
(``CASES``, on every mesh): SMOKE qwen3-4b (tensor-parallel attention
and MLP on 2 of 4 heads), SMOKE qwen3-moe (tensor-parallel attention,
2 of the 4 experts a rank under ``expert_shard="expert"``) and
qwen3-4b's SMOKE config on the SATA kernel route (the compacted-grid
kernel's plain version on the rank's 2 of 4 query heads over 1 of 2 KV
heads); (``MODEL_CASES``) SMOKE grok-1 (every expert on half its d_ff,
``"tensor"``) on (1, 2) and (2, 2), llama-3.2-vision (cross layers),
whisper-base (encoder, cross-attention), zamba2 (its mamba2 layers on 8
of 16 ssm heads a rank, and the shared block), rwkv6 (the time mix on 4
of 8 heads a rank, the channel mix on half its d_ff) and qwen3-4b with
a tied embedding on (1, 2).  Every case runs its embedding, unembed and
loss vocab-parallel where "model" is 2.  3 steps each from the
reference's weights.

Not bitwise: the data-parallel gradient sums (reduce-scatter over the
data ranks), the row-parallel out-projections' all-reduce and the
sharded sums of squares of the gradient norm add fp32 partial sums in
another order than one device.  Against the port's one-rank run and
against the reference's ``train`` on the same mesh: losses and grad
norms 1e-4 relative, final parameters 1e-5 absolute (fp32 summation
order; ``tests/test_torch_train.py``'s ``TRAIN_RTOL`` / ``PARAM_ATOL``),
but for one claim (ROADMAP C12, ``_first_update_accounts``): a
parameter whose clipped first gradient lies inside AdamW's eps on both
sides takes a first update ``lr · g / (|g| + eps)`` that turns the
gradients' fp32 summation order into up to ~1e-5; there the gap less
that first update's difference is held to 1e-5.  SMOKE rwkv6's
trajectory is badly conditioned (ROADMAP C7, ``test_torch_hybrid_ssm``):
its 3-step case holds its losses and step 0's grad norm to TRAIN_RTOL,
the later grad norms (measured 7.0e-4 off) and the final parameters
(above PARAM_ATOL; against the reference's mesh run one embedding entry
lies 1.2e-5 off, past C12's account) to that file's RWKV_TRAJ_RTOL.
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
from test_torch_hybrid_ssm import RWKV_TRAJ_RTOL  # noqa: E402
from repro.configs import archs as jarchs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.config import SataKernelConfig as JK  # noqa: E402
from repro_torch.optim.adamw import OptConfig, lr_at  # noqa: E402

TRAIN_RTOL, PARAM_ATOL = 1e-4, 1e-5
# ``train``'s AdamW for STEPS steps, and its learning rate at the first
# update
OPT = OptConfig(warmup_steps=max(2, R.STEPS // 10), decay_steps=R.STEPS)
LR1 = float(lr_at(OPT, torch.tensor(1)))
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


REF_PARTS = 4      # reference processes, each on a quarter of its runs


def _one_rank(tmp):
    """Every case on one device, and the uninterrupted checkpoint run."""
    out = {case: R.train_case(tmp, case, None, moments=True)
           for case in [*R.CASES, *R.MODEL_CASES]}
    for name, kw in R.VARIANTS.items():
        out[name] = R.train_case(tmp, "qwen3-4b", None, **kw)
    out["bf16"] = R.train_case(tmp, "qwen3-4b", None, dtype="bfloat16")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(world 4's results, world 2's, the reference's arrays, tmp, the
    one-device runs).  The test process writes the reference's weights
    while world 4 starts, and runs the one-device cases while world 2
    and the reference run."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), str(WORKER.parent), os.environ.get("PYTHONPATH", "")]))
    refs = [_start(["reference", tmp, i, REF_PARTS], dict(
        env, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4"))
        for i in range(REF_PARTS)]
    world4 = [_start([r, 4, tmp], env) for r in range(4)]
    try:          # the ranks wait for each case's weights as they come
        R.write_weights(str(tmp), jarchs.SMOKE, jmodel.init_params,
                        jax.random.PRNGKey(0), JK)
    except BaseException:
        for p in world4 + refs:
            p.kill()
        raise
    _finish(world4)
    # world 2 resumes world 4's checkpoint
    world2 = [_start([r, 2, tmp], env) for r in range(2)]
    try:
        one = _one_rank(str(tmp))
    finally:
        _finish(world2 + refs)
    want = {}
    for i in range(REF_PARTS):
        with np.load(tmp / f"reference{i}.npz") as z:
            want.update({n: z[n] for n in z.files})
    return (torch.load(tmp / "world4.pt"), torch.load(tmp / "world2.pt"),
            want, tmp, one)


@pytest.fixture(scope="module")
def one_rank(runs):
    return runs[4]


def _results(runs, shape):
    return runs[0] if shape == (2, 2) else runs[1]


def _first_step(m1):
    """AdamW's first normalised step from its first moment ``0.1 · g``
    (g the clipped first gradient): ``g / (|g| + eps)``."""
    g = m1.astype(np.float64) / (1 - OPT.b1)
    return g / (np.abs(g) + OPT.eps)


def _first_update_accounts(got, want, m1_got, m1_want, what):
    """Final parameters within PARAM_ATOL, but for ROADMAP C12: where
    one misses, both runs' clipped first gradients lie inside AdamW's
    eps (there ``g / (|g| + eps)`` is steep: a near-zero gradient's
    fp32 summation order moves the first update by up to lr · 0.07), and
    the gap less the two first updates' difference is within
    PARAM_ATOL.  Without first moments every element is held to
    PARAM_ATOL."""
    gap = got.astype(np.float64) - want
    off = np.abs(gap) > PARAM_ATOL
    if not off.any():
        return
    if m1_got is None:
        np.testing.assert_allclose(got, want, atol=PARAM_ATOL, rtol=0,
                                   err_msg=what)
    g_got = m1_got[off] / (1 - OPT.b1)
    g_want = m1_want[off] / (1 - OPT.b1)
    assert np.abs(g_got).max() < OPT.eps and \
        np.abs(g_want).max() < OPT.eps, (what, g_got, g_want, gap[off])
    rest = gap[off] + LR1 * (_first_step(m1_got[off])
                             - _first_step(m1_want[off]))
    assert np.abs(rest).max() <= PARAM_ATOL, (what, gap[off], rest)


def _trajectory(got_losses, got_gnorms, want_losses, want_gnorms, what,
                traj_rtol):
    """Losses within TRAIN_RTOL, grad norms past step 0 within
    ``traj_rtol`` (as ``test_torch_hybrid_ssm`` holds rwkv6's)."""
    np.testing.assert_allclose(got_losses, want_losses, rtol=TRAIN_RTOL,
                               err_msg=f"{what} losses")
    np.testing.assert_allclose(got_gnorms[0], want_gnorms[0],
                               rtol=TRAIN_RTOL, err_msg=f"{what} gnorms")
    np.testing.assert_allclose(got_gnorms, want_gnorms, rtol=traj_rtol,
                               err_msg=f"{what} gnorms")


def _params_close(got, want, m1_got, m1_want, what, traj_rtol):
    """PARAM_ATOL with ROADMAP C12's first-update rule; a trajectory
    held at ``traj_rtol`` past step 0 holds its final parameters there
    too, above PARAM_ATOL."""
    if traj_rtol != TRAIN_RTOL:
        np.testing.assert_allclose(got, want, atol=PARAM_ATOL,
                                   rtol=traj_rtol, err_msg=what)
    else:
        _first_update_accounts(got, want, m1_got, m1_want, what)


def _close(got, want, what, traj_rtol=TRAIN_RTOL):
    """Losses, grad norms and the final parameters (past step 0 within
    ``traj_rtol``)."""
    _trajectory(got["losses"], got["gnorms"], want["losses"],
                want["gnorms"], what, traj_rtol)
    assert set(got["params"]) == set(want["params"]), what
    m1 = "m1" in got and "m1" in want
    for n, p in got["params"].items():
        _params_close(
            p.float().numpy(), want["params"][n].float().numpy(),
            got["m1"][n].numpy() if m1 else None,
            want["m1"][n].numpy() if m1 else None,
            f"{what} {n}", traj_rtol)


MESH_CASES = [(shape, case) for shapes in R.MESHES.values()
              for shape in shapes for case in R.mesh_cases(shape)]


@pytest.mark.parametrize("shape,case", MESH_CASES,
                         ids=[f"{s[0]}x{s[1]}-{c}" for s, c in MESH_CASES])
def test_mesh_matches_one_rank(runs, one_rank, shape, case):
    """Losses, grad norms and the gathered final parameters of the mesh
    run against the port's one-device run."""
    _close(_results(runs, shape)[(shape, case)], one_rank[case],
           f"{shape} {case}", _traj_rtol(case))


def _traj_rtol(case):
    return RWKV_TRAJ_RTOL if R.ROWS[case][0] == "rwkv6-1.6b" else TRAIN_RTOL


@pytest.mark.parametrize("shape,case", MESH_CASES,
                         ids=[f"{s[0]}x{s[1]}-{c}" for s, c in MESH_CASES])
def test_mesh_matches_reference_on_the_same_mesh(runs, shape, case):
    got = _results(runs, shape)[(shape, case)]
    key = f"{shape[0]}x{shape[1]}/{case}"
    want = runs[2]
    _trajectory(got["losses"], got["gnorms"], want[key + "/losses"],
                want[key + "/gnorms"], key, _traj_rtol(case))
    names = {n[len(key + "/params/"):] for n in want
             if n.startswith(key + "/params/")}
    cfg = R.case_cfg(jarchs.SMOKE, case, JK)
    stacked = _stacked(got["params"], cfg)
    m1 = _stacked(got["m1"], cfg)
    assert names == set(stacked)
    for n in names:
        _params_close(stacked[n], want[f"{key}/params/{n}"], m1[n],
                      want[f"{key}/m1/{n}"], n, _traj_rtol(case))


def _stacked(params, cfg):
    """The port's parameters (tensors or arrays) under the reference's
    names: ``<group>.<i>.x`` stacked into ``<group>.x`` (L, ...) for the
    layer groups, vlm's self layers as (n_cross, per_group, ...)."""
    out, groups = {}, {}
    for n, p in params.items():
        p = p.float().numpy() if isinstance(p, torch.Tensor) else p
        parts = n.split(".")
        if parts[0] in ("layers", "cross_layers", "enc_layers"):
            groups.setdefault(".".join([parts[0]] + parts[2:]), {})[
                int(parts[1])] = p
        else:
            out[n] = p
    for n, per in groups.items():
        a = np.stack([per[i] for i in range(len(per))])
        if n.startswith("layers.") and cfg.family == "vlm":
            a = a.reshape((cfg.n_layers // cfg.cross_attn_period, -1)
                          + a.shape[1:])
        out[n] = a
    return out


@pytest.mark.parametrize("case", sorted(R.FAMILIES))
def test_other_families_take_one_step_on_the_mesh(runs, case):
    """One step on (2, 2) against the port's one device: the loss and
    grad norm (before any update: summation order only) and the updated
    parameters within PARAM_ATOL; rwkv6's under C12's rule from both
    runs' first moments (``R.FAMILY_MOMENTS``: its time and channel mix
    on the rank's heads reorder a near-zero gradient entry of ``wk``
    inside AdamW's eps).  One step, because SMOKE rwkv6's trajectory
    moves 0.56% under a 1e-7 weight perturbation after its first update
    (ROADMAP C7)."""
    one = R.train_case(str(runs[3]), case, None, steps=1,
                       moments=case in R.FAMILY_MOMENTS)
    _close(runs[0][case], one, case)


def test_tensor_parallel_and_gathered_leaves(runs):
    """Under "model" = 2 every leaf with a "model" spec of the dense,
    moe, vlm and audio families stays sharded in its region: the
    attention and MLP projections (7 a dense layer), qwen3-moe's and
    grok's attention and experts (4 + 3 a layer; the router is
    replicated), the embedding and unembed (2; the tied embedding 1);
    zamba2 keeps its mamba layers' in_proj / conv_w / out_proj (3 a
    layer), its shared block's 7 and the 2, and gathers ``shared_in``
    alone; rwkv6 keeps wr / wk / wv / wg / wo / bonus_u / ck / cv / cr
    (9 a layer) and the 2; "model" = 1 shards nothing over it."""
    n = jarchs.SMOKE["qwen3-4b"].n_layers
    w2 = runs[1]
    for case in ("qwen3-4b", "qwen3-moe", "grok"):
        assert w2[((1, 2), case)]["counts"] == {
            "tensor_parallel": 7 * n + 2, "gathered_over_model": 0}, case
    assert w2[((1, 2), "tied")]["counts"] == {
        "tensor_parallel": 7 * n + 1, "gathered_over_model": 0}
    vlm = jarchs.SMOKE["llama-3.2-vision-90b"]
    assert w2[((1, 2), "vlm")]["counts"] == {
        "tensor_parallel": 7 * vlm.n_layers + 2, "gathered_over_model": 0}
    audio = jarchs.SMOKE["whisper-base"]     # gelu MLPs: wi, wo
    assert w2[((1, 2), "audio")]["counts"] == {
        "tensor_parallel": 6 * audio.encoder_layers + 10 * audio.n_layers
        + 2, "gathered_over_model": 0}
    zamba2 = jarchs.SMOKE["zamba2-2.7b"]
    assert w2[((1, 2), "zamba2")]["counts"] == {
        "tensor_parallel": 3 * zamba2.n_layers + 7 + 2,
        "gathered_over_model": 1}
    rwkv6 = jarchs.SMOKE["rwkv6-1.6b"]
    assert w2[((1, 2), "rwkv6")]["counts"] == {
        "tensor_parallel": 9 * rwkv6.n_layers + 2, "gathered_over_model": 0}
    assert w2[((2, 1), "qwen3-4b")]["counts"] == {
        "tensor_parallel": 0, "gathered_over_model": 0}
    # CPU tensors go through gloo without a host copy
    assert w2[((2, 1), "staged")] == w2[((1, 2), "staged")] == 0


@pytest.mark.parametrize("case", R.SHAPES_CASES)
def test_a_rank_computes_its_experts_and_vocab_shard(runs, case):
    """A (1, 2) rank's forward: every expert product sees only the
    rank's shard — 2 of qwen3-moe's 4 experts (``"expert"``), all 4 of
    grok's on half of d_ff (``"tensor"``) — and the logits are the
    rank's (B, S, V / 2)."""
    cfg = jarchs.SMOKE[R.ROWS[case][0]]
    got = runs[1]["shapes"][case]
    e, d, f, m = cfg.n_experts, cfg.d_model, cfg.d_ff, 2
    wi, wo = ((e // m, d, f), (e // m, f, d)) if case == "qwen3-moe" \
        else ((e, d, f // m), (e, f // m, d))
    assert len(got["experts"]) == cfg.n_layers
    for xin, w_in, w_out in got["experts"]:
        assert (xin[0], w_in, w_out) == (wi[0], wi, wo), got["experts"]
    assert got["logits"] == (R.BATCH, R.ROWS[case][1], cfg.vocab_size // m)


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
    w4, w2, _, tmp, _ = runs
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
