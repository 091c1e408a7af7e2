"""Port parity for the context-parallel train and prefill steps: the
reference's layout under ``distributed.ctx.set_context_parallel(True)``
with the ``seq_shard`` activation specs, where a rank of a ("data",
"model") mesh computes every layer on its contiguous 1/m of the
sequence (``tests/torch_cp_train_ranks.py``).

World 2 runs every case on (1, 2), world 4 SMOKE qwen3-4b and its GQA
kernel case on (2, 2) and on (1, 4) (whose 2 KV heads do not divide
"model", so no attention region exists there without context
parallelism), with that GQA config on ``_attend`` on (1, 4) too; each
started once for the module through a ``FileStore``
under the test's temp directory, while the reference's jitted
``make_prefill_step`` and ``make_train_step`` run the same (mesh, case)
pairs under the same switch in REF_PARTS subprocesses with 4 forced
host devices, and the test process runs the port's one-device cases.
Cases: SMOKE qwen3-4b on ``_attend``; its GQA config on the SATA kernel
route (4 query over 2 KV heads, blocks of 16: the compacted-grid
kernel's plain version on the rank's query rows against every key);
SMOKE qwen3-moe (the router over the gathered sequence), zamba2 (its
mamba2 layers and shared block), rwkv6 (the time and channel mix),
llama-3.2-vision (cross layers over the whole image context) and
whisper-base (its encoder on the rank's frames, cross-attention over
the gathered context), whisper-base at 9 encoder frames (held whole on
every rank, its encoder without a region) and qwen3-moe at 3 experts
(no expert region: every rank routes the gathered sequence).  Each
trains 3 steps from the reference's weights and runs one prefill step.

Not bitwise: the sequence's reduce-scatters and the vocab-parallel
sums add fp32 partial sums in another order than one device.  Held as
``tests/test_torch_mesh_train.py`` holds the head-parallel mesh,
against the port's one device and against the reference on the same
mesh: losses and grad norms 1e-4 relative, final parameters 1e-5
absolute with ROADMAP C12's first-update rule (rwkv6 past step 0 at
RWKV_TRAJ_RTOL, ROADMAP C7); the prefill's last-position logits (B, V)
within PREFILL_ATOL absolute (fp32 logits of magnitude ~3; measured up
to 2e-6).  The reference's context-parallel attention runs ``_attend``
(its kernel has no SPMD rule): the kernel case holds the port's kernel
route to it.

But for one account (``_first_flip``, ROADMAP C15): the SATA predicate
admits a key where ``bf16(score) >= bf16(threshold)``, so a score whose
fp32 value sits at a bf16 rounding boundary that ties the threshold
flips with the last bit of its summation order.  On (1, 2) the kernel
case's rank computes its q rows through the MLP's reduce-scattered
partial sums, 4.7e-6 off one device's at layer 2 of step 1, and there
one row of the 1,024 admits another key set (its attention output 8.1e-2
off); from that step on the trajectory holds SELECTION_FLIP_RTOL
(measured 2.1e-4 on the step-2 grad norm) and the final parameters
SELECTION_FLIP_ATOL (4.5e-4).  Every case without a flip, and every
step before it, keeps the tolerances above; the prefill, on the seed's
weights, must flip nothing."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402

import torch_cp_train_ranks as C  # noqa: E402
import torch_mesh_train_ranks as R  # noqa: E402
from test_torch_mesh_train import (_close, _params_close,  # noqa: E402
                                   _stacked, _traj_rtol, _trajectory)
from repro.configs import archs as jarchs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.config import SataKernelConfig as JK  # noqa: E402

PREFILL_ATOL = 1e-5
# the account of a top-k flip (``_first_flip``): from the step whose B3
# calls admit another number of keys in some row than one device's on,
# losses and grad norms within SELECTION_FLIP_RTOL and the final
# parameters within SELECTION_FLIP_ATOL; the step's flipped rows at most
# FLIP_ROWS_MAX of each call's
SELECTION_FLIP_RTOL, SELECTION_FLIP_ATOL, FLIP_ROWS_MAX = 1e-3, 1e-3, 0.01
REF_PARTS = 4      # reference processes, the (mesh, case) pairs dealt out
WORKER = pathlib.Path(C.__file__)
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
JOBS = [(shape, case) for shape, cases in C.CASES.items() for case in cases]
IDS = [f"{s[0]}x{s[1]}-{c}" for s, c in JOBS]


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
    """({mesh shape, case}: the port's rank-0 results, the reference's
    arrays, the port's one-device results by case)."""
    tmp = tmp_path_factory.mktemp("cp_train")
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
    world2 = [_start([r, 2, tmp], env) for r in range(2)]
    try:
        one = {case: C.port_case(str(tmp), case, None) for case in
               dict.fromkeys(c for cases in C.CASES.values() for c in cases)}
    finally:
        _finish(world2 + refs)
    got = {**torch.load(tmp / "world4.pt"), **torch.load(tmp / "world2.pt")}
    want = {}
    for i in range(REF_PARTS):
        with np.load(tmp / f"reference{i}.npz") as z:
            want.update({n: z[n] for n in z.files})
    return got, want, one


def _prefill_close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want,
                               atol=PREFILL_ATOL, rtol=0,
                               err_msg=f"{what} prefill logits")


def _first_flip(got, one, case):
    """The first train step whose B3 calls admit, in some row, another
    number of keys than the port's one device's (None: no row ever
    does); its flipped rows are at most FLIP_ROWS_MAX of each call's,
    and the prefill's calls flip none."""
    n = R.case_cfg(jarchs.SMOKE, case, JK).n_layers
    flips = [int((a != b).sum()) for a, b in zip(got["admitted"],
                                                 one["admitted"])]
    train, prefill = flips[:R.STEPS * n], flips[R.STEPS * n:]
    assert len(flips) == len(one["admitted"]) and not any(prefill), flips
    first = next((i // n for i, f in enumerate(train) if f), None)
    if first is not None:
        rows = one["admitted"][0].numel()
        assert max(train[first * n:(first + 1) * n]) <= FLIP_ROWS_MAX * rows
    return first


def _held(got_l, got_g, want_l, want_g, what, case, first):
    """The trajectory before step ``first`` as ``_trajectory`` holds it,
    from it on within SELECTION_FLIP_RTOL."""
    cut = R.STEPS if first is None else first
    if cut:
        _trajectory(got_l[:cut], got_g[:cut], want_l[:cut], want_g[:cut],
                    what, _traj_rtol(case))
    for key, got, want in (("losses", got_l, want_l),
                           ("gnorms", got_g, want_g)):
        np.testing.assert_allclose(got[cut:], want[cut:],
                                   rtol=SELECTION_FLIP_RTOL,
                                   err_msg=f"{what} {key} after a flip")


@pytest.mark.parametrize("shape,case", JOBS, ids=IDS)
def test_cp_matches_one_rank(runs, shape, case):
    """Losses, grad norms, the gathered final parameters and the prefill
    logits of the context-parallel run against the port's one device
    (``_first_flip``'s account after a top-k flip); the step ran
    context-parallel."""
    got, one = runs[0][(shape, case)], runs[2][case]
    what = f"{shape} {case}"
    assert got["cp"] is True
    first = _first_flip(got, one, case)
    if first is None:
        _close(got, one, what, _traj_rtol(case))
    else:
        _held(got["losses"], got["gnorms"], one["losses"], one["gnorms"],
              what, case, first)
        for n, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), one["params"][n].numpy(),
                                       atol=SELECTION_FLIP_ATOL, rtol=0,
                                       err_msg=f"{what} {n}")
    _prefill_close(got["prefill"].numpy(), one["prefill"].numpy(), what)


@pytest.mark.parametrize("shape,case", JOBS, ids=IDS)
def test_cp_matches_reference_on_the_same_mesh(runs, shape, case):
    got, want = runs[0][(shape, case)], runs[1]
    key = f"{shape[0]}x{shape[1]}/{case}"
    first = _first_flip(got, runs[2][case], case)
    _held(got["losses"], got["gnorms"], want[key + "/losses"],
          want[key + "/gnorms"], key, case, first)
    names = {n[len(key + "/params/"):] for n in want
             if n.startswith(key + "/params/")}
    cfg = R.case_cfg(jarchs.SMOKE, case, JK)
    stacked = _stacked(got["params"], cfg)
    m1 = _stacked(got["m1"], cfg)
    assert names == set(stacked)
    for n in names:
        if first is None:
            _params_close(stacked[n], want[f"{key}/params/{n}"], m1[n],
                          want[f"{key}/m1/{n}"], n, _traj_rtol(case))
        else:
            np.testing.assert_allclose(stacked[n], want[f"{key}/params/{n}"],
                                       atol=SELECTION_FLIP_ATOL, rtol=0,
                                       err_msg=f"{key} {n}")
    _prefill_close(got["prefill"].numpy(), want[key + "/prefill"], key)


@pytest.mark.parametrize("shape", list(C.CASES))
def test_the_kernel_runs_on_the_ranks_query_rows(runs, shape):
    """Every B3 call of the GQA kernel case (train and prefill) takes the
    rank's S / m query rows against all S keys; one device's take S
    against S; ``_attend``'s case calls none."""
    s = R.ROWS["gqa-kernel"][1]
    assert runs[0][(shape, "gqa-kernel")]["b3_rows"] == [(s // shape[1], s)]
    assert runs[2]["gqa-kernel"]["b3_rows"] == [(s, s)]
    assert runs[0][(shape, "qwen3-4b")]["b3_rows"] == []


def test_the_attention_leaves_are_gathered_over_model(runs):
    """Under context parallelism the attention has no region (its
    weights gathered over "model", 4 a layer), the MLP, embedding and
    unembed keep theirs (3 a layer + 2)."""
    n = jarchs.SMOKE["qwen3-4b"].n_layers
    for shape in C.CASES:
        assert runs[0][(shape, "qwen3-4b")]["counts"] == {
            "tensor_parallel": 3 * n + 2, "gathered_over_model": 4 * n}


@pytest.mark.parametrize("arch,m", [("qwen3-4b", 16), ("phi4-mini-3.8b", 16),
                                    ("deepseek-67b", 16), ("gqa", 4)])
def test_the_mlp_region_needs_only_d_ff(arch, m):
    """Without context parallelism the MLP computes in its region
    wherever "model" divides d_ff, also where it does not divide the
    heads or the KV heads (and so the attention has no region): the
    production archs on 16 ranks, SMOKE qwen3-4b's GQA kernel case on
    4."""
    from repro_torch.configs.archs import ARCHS, SMOKE
    from repro_torch.distributed.sharding import ShardLayout
    from repro_torch.launch.mesh import ShardMesh
    from repro_torch.models.config import SataKernelConfig
    cfg = R.case_cfg(SMOKE, "gqa-kernel", SataKernelConfig) \
        if arch == "gqa" else ARCHS[arch]
    mesh = ShardMesh(("data", "model"), {"data": 1, "model": m}, None, 0,
                     torch.device("meta"))
    layout = ShardLayout(cfg, mesh)
    assert cfg.n_kv_heads % m and cfg.d_ff % m == 0
    assert layout.tp_for("layers.0.attn") is None
    assert layout.tp_for("layers.0.mlp") is not None
    assert layout.specs["layers.0.mlp.wi"][-1] == "model"

