"""Port parity: the dry run and the per-cell roofline — ``configs.archs``'
cells, ``ModelConfig.param_count``, the context-parallel specs of
``distributed.ctx``, ``kernels.ops``' meta route and work count,
``launch.dryrun.run_cell`` on a fake world, ``launch.roofline``'s
``analyse_cell`` and ``launch.report``'s tables.

Exact throughout: the cells, the parameter counts and the specs equal
the reference's; a SMOKE training step on the SATA kernel route counts
the same FLOPs, bytes and kernel calls on meta tensors as on CPU
tensors (the kernel's work comes from static shapes, and neither the
plain version's ops nor the CUDA wrapper's count); the fake world's
collective bytes on (1, 2) equal a real 2-rank gloo run's of the same
steps (``tests/torch_mesh_train_ranks.py collectives``); the moe
dispatch through the sink row is bitwise the boolean-index dispatch it
replaced.  ``analyse_cell`` is held to the reference's with both
packages' ``_measure`` stubbed to the same probe counts: the same
extrapolation, the terms over the H100's peaks where the reference
divides by a v5e's.  The reference's ``launch.dryrun`` and
``launch.roofline`` force 512 host devices through ``XLA_FLAGS`` at
import, so they run only in a subprocess; ``repro.launch.report`` is
pointed at ``tmp_path``.  The dry-run table's footnote says what the
port counts, so the tables are compared above it."""
import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import torch.distributed as dist  # noqa: E402
import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import torch_mesh_train_ranks as R  # noqa: E402
from repro.configs import archs as jarchs  # noqa: E402
from repro.distributed import ctx as jctx  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.distributed import ctx as tctx  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    ShardLayout, block, cache_leaves)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sata_attention as sa  # noqa: E402
from repro_torch.kernels import sata_decode as sd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import inputs as tinputs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import report as treport  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch.mesh import ShardMesh  # noqa: E402
from repro_torch.models import model as tmdl  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.train.step import init_train_state, \
    make_train_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
WORKER = pathlib.Path(R.__file__)


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), str(WORKER.parent), os.environ.get("PYTHONPATH", "")]))


@pytest.fixture(scope="module")
def gloo_bytes(tmp_path_factory):
    """``COLLECTIVE_CASES``' collective bytes by kind from a real 2-rank
    gloo world (started at once, read when a test needs it)."""
    tmp = tmp_path_factory.mktemp("collectives")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), "collectives", str(r), str(tmp)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]

    def get():
        try:
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        return torch.load(tmp / "collectives.pt")
    return get


@pytest.fixture(autouse=True)
def _no_world():
    yield
    assert not dist.is_initialized(), "a process group was left behind"


# ---------------------------------------------------------------------------
# cells, parameter counts, context-parallel specs
# ---------------------------------------------------------------------------

def test_cells_equal_the_reference():
    assert tarchs.SHAPES == {k: tarchs.ShapeSpec(**dataclasses.asdict(v))
                             for k, v in jarchs.SHAPES.items()}
    assert tarchs.LONG_OK == jarchs.LONG_OK
    assert tarchs.all_cells() == jarchs.all_cells()
    assert len(tarchs.all_cells()) == 32
    for a in jarchs.ARCHS:
        for s in jarchs.SHAPES:
            assert tarchs.cell_enabled(a, s) == jarchs.cell_enabled(a, s)


@pytest.mark.parametrize("table", ["ARCHS", "SMOKE"])
def test_param_counts_equal_the_reference(table):
    for arch, jc in getattr(jarchs, table).items():
        tc = getattr(tarchs, table)[arch]
        assert tc.param_count() == jc.param_count(), arch
        assert tc.active_param_count() == jc.active_param_count(), arch


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cp_specs_equal_the_reference(monkeypatch, multi_pod):
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    jmesh = AbstractMesh(sizes, axes)
    tmesh = ShardMesh(axes, dict(zip(axes, sizes)), None, 0,
                      torch.device("meta"))
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s.spec)) or x)
    cases = (("cp_q", (8, 4096, 32, 128)), ("cp_q", (8, 4100, 32, 128)),
             ("cp_kv", (8, 4096, 8, 128)),
             ("cp_scores", (8, 8, 4, 4096, 4096)),
             ("cp_scores", (8, 8, 4, 24, 4096)))
    for on in (False, True):
        jctx.set_activation_shardings({}, mesh=jmesh)
        tctx.set_activation_shardings({}, mesh=tmesh)
        jctx.set_context_parallel(on)
        tctx.set_context_parallel(on)
        try:
            assert tctx.cp_enabled() == jctx.cp_enabled() == on
            for name, shape in cases:
                seen.clear()
                getattr(jctx, f"constrain_{name}")(
                    types.SimpleNamespace(shape=shape))
                want = seen[0] if seen else None
                got = getattr(tctx, f"{name}_spec")(shape, tmesh)
                assert got == want, (on, name, shape, got, want)
        finally:
            for c in (jctx, tctx):
                c.set_context_parallel(False)
                c.clear()
    assert not tctx.cp_enabled()


# ---------------------------------------------------------------------------
# the kernels' meta route and work count
# ---------------------------------------------------------------------------

def _launches():
    return (sa.sata_block_attention_compact.launches,
            sa.sata_block_attention.launches,
            sd.sata_decode_attention_kernel.launches,
            sd.sata_decode_attention_paged_kernel.launches)


def _counted_step(cfg, device, tokens, m=1):
    """One train step of ``cfg`` under a ``WorkCounter``: on one device,
    or (``m`` > 1) as rank 0 of a fake world's (1, m) mesh with context
    parallelism on (the fake collectives move nothing: the counts read
    only shapes)."""
    with contextlib.ExitStack() as stack:
        mesh = None
        if m > 1:
            stack.enter_context(tmesh.fake_world(m))
            mesh = tmesh.make_train_mesh(1, m, device=device)
            tctx.set_activation_shardings(tctx.make_activation_shardings(
                mesh, cfg, seq_shard=True), mesh=mesh)
            tctx.set_context_parallel(True)
            stack.callback(tctx.clear)
            stack.callback(tctx.set_context_parallel, False)
        state = init_train_state(cfg, OptConfig(), device=device, seed=0,
                                 mesh=mesh)
        step = make_train_step(cfg, OptConfig(), mesh=mesh)
        assert (step.layout.seq is not None) == (m > 1)
        tok = torch.from_numpy(tokens).to(device)
        with dryrun.WorkCounter() as c:
            _, metrics = step(state, {"tokens": tok, "labels": tok})
    assert metrics["loss"].device.type == torch.device(device).type
    return c.summary()


@pytest.mark.parametrize("m", [1, 2])
def test_a_step_counts_the_same_work_on_meta_and_on_the_cpu(m):
    """m = 2: rank 0 of a (1, 2) mesh, context-parallel: its B3 calls
    take its 128 query rows against all 256 keys."""
    cfg = dataclasses.replace(dryrun.main_path_cfg(tarchs.SMOKE["qwen3-4b"]),
                              remat="full")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 256)).astype(np.int32)
    before = _launches()
    meta = _counted_step(cfg, "meta", tokens, m)
    cpu = _counted_step(cfg, "cpu", tokens, m)
    assert _launches() == before
    # 4 layers x (forward + remat recompute), each at the plan capacity
    want = ops.block_attention_work(
        torch.empty((2 * cfg.n_heads, 256 // m, cfg.hd)), None, 2,
        q_block=128, k_block=128)
    assert meta["kernels"] == {"sata_block_attention_compact": {
        "calls": 8, "flops": 8 * want[0], "bytes": 8 * want[1]}}
    for k in ("flops", "bytes", "ops", "kernels"):
        assert cpu[k] == meta[k], (k, cpu[k], meta[k])
    assert meta["flops"] > 8 * want[0] and meta["peak_bytes"] > 0


def test_kernel_routes_by_device():
    q = torch.empty((2, 256, 16), device="meta")
    idx = torch.zeros((2, 2, 2), dtype=torch.int32, device="meta")
    cnt = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    before = _launches()
    out = ops._block_attention_compact(q, q, q, idx, cnt, q_block=128,
                                       k_block=128)
    assert out.device.type == "meta" and out.shape == q.shape
    bm = torch.zeros((2, 2, 2), dtype=torch.bool, device="meta")
    assert ops._block_attention_dense(q, q, q, bm, q_block=128,
                                      k_block=128).shape == q.shape
    qd = torch.empty((3, 2, 4, 16), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((3, 64, 2, 16), dtype=torch.bfloat16, device="meta")
    didx = torch.zeros((3, 2, 4), dtype=torch.int32, device="meta")
    thr = torch.empty((3, 2, 4, 1), device="meta")
    pos = torch.zeros(3, dtype=torch.int32, device="meta")
    with dryrun.WorkCounter() as c:
        got = ops.sata_decode_attention(qd, kv, kv, didx, cnt[:1].expand(3, 2),
                                        thr, pos, k_block=16)
    assert got.shape == qd.shape and got.dtype == torch.bfloat16
    flops, nbytes = ops.decode_attention_work(qd, didx, k_block=16)
    assert flops == 4 * 4 * 16 * 16 * 3 * 2 * 4
    assert nbytes == 2 * (2 * 3 * 2 * 4 * 16 + 2 * 3 * 2 * 4 * 16 * 16)
    assert c.kernels == {"sata_decode_attention_kernel": {
        "calls": 1, "flops": flops, "bytes": nbytes}}
    assert c.ops == 0                   # the stand-in's own op is paused
    assert _launches() == before
    with pytest.raises(ValueError, match="no SATA kernel for tensors on"):
        ops._route(types.SimpleNamespace(device=torch.device("mps")), None,
                   None)


# (form, the write, bytes counted): a (6, 4, 8) fp32 destination and two
# int64 row indices (16 B); the written elements are the broadcast index
# shape's rows, never the whole destination (768 B)
_ROW_WRITE_CASES = {
    "rows": ((2, 4, 8), lambda d, i, v: d.index_put_((i,), v),
             16 + 256 + 256),
    "scalar fill": ((), lambda d, i, v: d.index_put_((i,), v),
                    16 + 4 + 256),
    "accumulate": ((2, 4, 8), lambda d, i, v: d.index_put_(
        (i,), v, accumulate=True), 16 + 256 + 2 * 256),
    "inner dim": ((6, 2, 8), lambda d, i, v: d.__setitem__(
        (slice(None), i), v), 16 + 384 + 384),
}


@pytest.mark.parametrize("form", sorted(_ROW_WRITE_CASES))
@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_row_write_counts_the_elements_it_writes(form, device):
    """An in-place ``index_put_`` counts its indices, its values and the
    elements it writes (broadcast from the values; read as well with
    ``accumulate``), the same on meta and on the CPU."""
    shape, write, want = _ROW_WRITE_CASES[form]
    dst = torch.zeros((6, 4, 8), device=device)
    idx = torch.tensor([1, 3], device=device)
    values = torch.ones(shape, device=device)
    with dryrun.WorkCounter() as c:
        write(dst, idx, values)
    assert (c.ops, c.bytes) == (1, want), (c.by_op, want)


_INDEX_PUT = torch.Tensor.index_put


def _old_dispatch(tokens, slot, keep, src, n_slots):
    """The boolean-index dispatch the sink row replaced."""
    kept = keep.reshape(-1)
    return _INDEX_PUT(tokens.new_zeros((n_slots, tokens.shape[-1])),
                      (slot[kept],), src[kept])


def test_moe_sink_dispatch_is_bitwise_the_boolean_dispatch(monkeypatch):
    cfg = dataclasses.replace(tarchs.SMOKE["qwen3-moe-235b-a22b"],
                              capacity_factor=0.5)        # drops pairs
    model = tmdl.Model(cfg, device="cpu", seed=3)
    p = model["layers"][0]["moe"]
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0), requires_grad=True)
    assert not bool(tmoe.route(p, cfg, x.reshape(2, 16, -1)).keep.all())

    def run():
        out, aux = tmoe.moe_apply(p, cfg, x)
        grads = torch.autograd.grad(out.square().sum() + aux,
                                    [x, *p.parameters()])
        return out, aux, grads
    new = run()
    calls = []

    def old_put(self, idx, src):
        # the new form: (n_slots + 1, d) zeros, the sink at n_slots
        n_slots = self.shape[0] - 1
        calls.append(n_slots)
        keep = idx[0] < n_slots
        xin = _old_dispatch(self[:n_slots], idx[0], keep, src, n_slots)
        return torch.cat([xin, self[n_slots:]])
    monkeypatch.setattr(torch.Tensor, "index_put", old_put)
    old = run()
    monkeypatch.setattr(torch.Tensor, "index_put", _INDEX_PUT)
    assert calls
    assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])
    for a, b in zip(new[2], old[2]):
        assert torch.equal(a, b)


def test_smoke_moe_loss_runs_on_meta():
    cfg = tarchs.SMOKE["qwen3-moe-235b-a22b"]
    model = tmdl.Model(cfg, device="meta")
    tok = torch.empty((2, 32), dtype=torch.int32, device="meta")
    loss, parts = tmdl.loss_fn(model, cfg, {"tokens": tok, "labels": tok})
    assert loss.device.type == "meta" and loss.shape == ()
    loss.backward()
    assert all(q.grad is not None for q in model.parameters())


# ---------------------------------------------------------------------------
# run_cell on a fake world
# ---------------------------------------------------------------------------

def _small(monkeypatch, train=(128, 32), prefill=(128, 32),
           decode=(2048, 4), long=(2048, 2)):
    """The cells' shapes at SMOKE sizes: a decode cache of 2,048 keys,
    so that a rank's share of them tiles by the decode block (128) on
    every mesh up to 16 wide over "model"."""
    monkeypatch.setitem(tarchs.SHAPES, "train_4k",
                        tarchs.ShapeSpec("train_4k", *train, "train"))
    monkeypatch.setitem(tarchs.SHAPES, "prefill_32k",
                        tarchs.ShapeSpec("prefill_32k", *prefill, "prefill"))
    monkeypatch.setitem(tarchs.SHAPES, "decode_32k",
                        tarchs.ShapeSpec("decode_32k", *decode, "decode"))
    monkeypatch.setitem(tarchs.SHAPES, "long_500k",
                        tarchs.ShapeSpec("long_500k", *long, "decode"))


def _blocks_bytes(cfg, mesh, batch_bytes, train):
    """The rank's argument bytes summed from ShardLayout's blocks."""
    layout = ShardLayout(cfg, mesh)
    total = 0
    for name, p in tmdl.Model(cfg, device="meta").named_parameters():
        b = block(p, layout.specs[name], mesh)
        total += b.numel() * (p.element_size() + (8 if train else 0))
    nd = np.prod([mesh.shape[a] for a in layout.data])
    return total + (4 if train else 0) + batch_bytes // nd


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_run_cell_argument_bytes_are_the_layout_blocks(monkeypatch,
                                                       tmp_path, shape,
                                                       multi_pod):
    _small(monkeypatch)
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    cfg = tarchs.SMOKE["qwen3-4b"]
    r = dryrun.run_cell("qwen3-4b", shape, multi_pod, cfg=cfg,
                        verbose=False)
    sizes = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    mesh = ShardMesh(tuple(sizes), sizes, None, 0, torch.device("meta"))
    train = shape == "train_4k"
    batch = 32 * 128 * 4 * (2 if train else 1)
    assert r["ok"] and r["mesh"] == sizes and r["cp"] is True
    assert r["memory"]["argument_size_in_bytes"] == _blocks_bytes(
        cfg, mesh, batch, train)
    # train: five fp32 metrics and the new step counter (the parameters
    # and moments are updated in place); prefill: the (B, V) logits
    assert r["memory"]["output_size_in_bytes"] == (
        5 * 4 + 4 if train else 32 * cfg.vocab_size * 4)
    assert r["memory"]["temp_size_in_bytes"] > 0
    assert r["cost"]["flops"] > 0 and r["cost"]["bytes accessed"] > 0
    assert set(r["collectives"]["per_kind"]) <= {
        "all-gather", "all-reduce", "reduce-scatter"}
    assert r["collectives"]["total_bytes"] == sum(
        r["collectives"]["per_kind"].values()) > 0
    assert json.loads((tmp_path / f"{r['cell']}.json").read_text()) == r


@pytest.mark.parametrize("cp", [False, True])
def test_fake_world_collective_bytes_equal_a_gloo_world(monkeypatch,
                                                        gloo_bytes, cp):
    """With and without context parallelism (the gloo world sets the
    same switch); context-parallel, every step reduce-scatters the
    sequence."""
    got = {}
    for case, (arch, kind, b, s) in R.COLLECTIVE_CASES.items():
        shape = "train_4k" if kind == "train" else "prefill_32k"
        monkeypatch.setitem(tarchs.SHAPES, shape,
                            tarchs.ShapeSpec(shape, s, b, kind))
        r = dryrun.run_cell(arch, shape, False, save=False, verbose=False,
                            cfg=R.collective_cfg(arch), mesh_shape=(1, 2),
                            cp=cp)
        assert r["cp"] is cp
        got[case] = r["collectives"]["per_kind"]
        if case == "qwen3-4b-train":       # SMOKE: no remat, one a layer
            assert r["kernels"]["sata_block_attention_compact"]["calls"] \
                == R.collective_cfg(arch).n_layers
    want = gloo_bytes()[cp]
    assert got == want
    kind = "reduce-scatter" if cp else "all-reduce"
    assert all(want[c].get(kind, 0) > 0 for c in want)


# ---------------------------------------------------------------------------
# the decode cells
# ---------------------------------------------------------------------------

DECODE_CELLS = [(a, s) for a in tarchs.SMOKE for s in ("decode_32k",
                                                       "long_500k")
                if tarchs.cell_enabled(a, s)]


def _attention_layers(cfg) -> int:
    """The self-attention layers a decode step runs (each one decode
    kernel call): hybrid's shared-block applications, vlm's self layers,
    none for ssm."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_period
    if cfg.family == "vlm":
        return len(tmdl.Model(cfg, device="meta")["layers"])
    return cfg.n_layers


def _cpu_decode_step(cfg, shape, mesh_shape, mode):
    """The decode cell's step again on CPU tensors, on a fake world of
    the same shape (its collectives move nothing either): the counts
    and the rank's argument bytes."""
    from repro_torch.launch.mesh import fake_world, make_train_mesh
    from repro_torch.models import decode as tdec
    from repro_torch.train.step import make_serve_step
    b, s = shape.global_batch, shape.seq_len
    with fake_world(int(np.prod(mesh_shape))):
        mesh = make_train_mesh(*mesh_shape, device="cpu")
        cache = ShardLayout(cfg, mesh).block_cache(
            tdec.init_cache(cfg, b, s, device="cpu"))
        model = init_train_state(cfg, OptConfig(), device="cpu", mesh=mesh,
                                 mode=mode)["params"]
        step = make_serve_step(cfg, mesh=mesh, mode=mode)
        tokens = torch.zeros((b, 1), dtype=torch.int32)
        pos = torch.zeros((), dtype=torch.int32)
        with dryrun.WorkCounter() as c:
            step(model, cache, tokens, pos)
        held = [*model.parameters(), *dryrun._tensors(cache)]
        nd = np.prod([mesh.shape[a] for a in step.layout.data])
        return c.summary(), sum(t.nbytes for t in held) + \
            tokens.nbytes // (nd if b % nd == 0 else 1)


@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_decode_cell_on_a_small_fake_world(monkeypatch, tmp_path, arch,
                                           shape):
    """A decode cell of every family on a (2, 2) fake world at SMOKE
    widths: ok, "cp" false, the weights' mode and the rank's cache bytes
    recorded; one decode kernel call per attention layer; the argument
    bytes the rank's parameter and cache blocks and its tokens; the
    counts (FLOPs, bytes, ops, kernels) those of the same step on CPU
    tensors (the peak is not: on the CPU the plain version's own
    buffers are live inside a kernel call); the logits' (B, 1, V) fp32
    the output."""
    _small(monkeypatch)
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    cfg = dryrun.main_path_cfg(tarchs.SMOKE[arch])
    r = dryrun.run_cell(arch, shape, False, cfg=cfg, verbose=False,
                        mesh_shape=(2, 2))
    spec = tarchs.SHAPES[shape]
    assert r["ok"] and r["cp"] is False and r["mesh"] == {"data": 2,
                                                          "model": 2}
    assert r["param_mode"] == "infer_tp"
    assert json.loads((tmp_path / f"{r['cell']}.json").read_text()) == r
    n_attn = _attention_layers(cfg)
    calls = r["kernels"].get("sata_decode_attention_kernel", {}).get(
        "calls", 0)
    assert calls == n_attn and set(r["kernels"]) <= {
        "sata_decode_attention_kernel"}
    cpu, args = _cpu_decode_step(cfg, spec, (2, 2), r["param_mode"])
    assert r["memory"]["argument_size_in_bytes"] == args
    cache, _, _ = tinputs.decode_specs_for(cfg, spec)
    mesh = ShardMesh(("data", "model"), {"data": 2, "model": 2}, None, 0,
                     torch.device("meta"))
    assert r["cache_bytes_rank"] == sum(
        t.nbytes for t in dryrun._tensors(
            ShardLayout(cfg, mesh).block_cache(cache)))
    assert r["memory"]["output_size_in_bytes"] == \
        spec.global_batch * cfg.vocab_size * 4
    for k in ("flops", "bytes", "ops", "kernels"):
        got = r["kernels"] if k == "kernels" else \
            r["cost"]["bytes accessed" if k == "bytes" else k]
        assert got == cpu[k], (k, got, cpu[k])
    assert r["memory"]["temp_size_in_bytes"] > 0


def test_decode_cells_run_from_the_cli(monkeypatch, tmp_path):
    """``main`` runs a decode cell like any other: no "waiting" list,
    an ok record, the full-depth weights' mode kept by a roofline
    probe (``param_mode``)."""
    _small(monkeypatch)
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    monkeypatch.setitem(tarchs.ARCHS, "qwen3-4b", tarchs.SMOKE["qwen3-4b"])
    dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k"])
    rec = json.loads((tmp_path / "qwen3-4b__decode_32k__pod1.json")
                     .read_text())
    assert rec["ok"] and rec["param_mode"] == "infer_tp"
    forced = dryrun.run_cell("qwen3-4b", "decode_32k", False, save=False,
                             verbose=False, param_mode="train")
    assert forced["param_mode"] == "train"
    assert forced["memory"]["argument_size_in_bytes"] < \
        rec["memory"]["argument_size_in_bytes"]


def _reference_cache_bytes(jc, shape) -> int:
    cache = jax.eval_shape(lambda: jdec.init_cache(jc, shape.global_batch,
                                                   shape.seq_len))
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(cache))


@pytest.mark.parametrize("arch", list(jarchs.ARCHS))
def test_decode_param_mode_is_the_references_rule(arch):
    """``decode_param_mode`` at the reference's 15e9 budget and its
    ``cache / n_dev`` gives the reference's inline decision
    (``repro.launch.dryrun``'s decode branch, at ``ARCHS``' configs and
    a ``jax.eval_shape`` of its ``init_cache``), for every cell; the
    tensor-parallel weight bytes are its ``tp_w``."""
    jc, tc = jarchs.ARCHS[arch], tarchs.ARCHS[arch]
    mesh = ShardMesh(("data", "model"), {"data": 16, "model": 16}, None, 0,
                     torch.device("meta"))
    n_model, n_dev = 16, 256
    expert = (jc.n_layers * jc.n_experts * 3 * jc.d_model * jc.d_ff
              if jc.moe else 0)
    tp_w = (jc.param_count() - expert) * 2 / n_model + expert * 2 / n_dev
    assert dryrun.tp_weight_bytes(tc, mesh) == tp_w
    for name, shape in jarchs.SHAPES.items():
        if shape.kind != "decode" or not jarchs.cell_enabled(arch, name):
            continue
        cache_b = _reference_cache_bytes(jc, shape) / n_dev
        want = "infer_tp" if tp_w + cache_b <= 15e9 else "train"
        assert dryrun.decode_param_mode(tc, mesh, cache_b, 15e9) == want, \
            (arch, name)
    assert dryrun.DECODE_HBM_BUDGET == 75e9


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a, s in tarchs.all_cells()
    if tarchs.SHAPES[s].kind == "decode"])
def test_decode_cells_split_the_keys(arch, shape):
    """The 12 decode cells' caches at full width and depth under the key
    split (``CACHE_SEQ_SHARD``, rank 0 of 16×16, meta): every leaf of
    ``kv`` / ``shared_kv`` split over "model" holds exactly its global
    bytes / 256 (/ 16 where the batch does not split over "data":
    long_500k's one slot, as the reference's ``cache_specs``), the
    plan's per-slot vectors / 16; ``cross_kv`` splits where m divides
    the context (vlm's 1,600 image tokens, not whisper's 1,500 frames);
    every cell's weights take "infer_tp", deepseek-67b's and
    llama-3.2-vision-90b's too (their rank's cache, 6.5 / 5.5 GB, with
    the TP weights now fits ``DECODE_HBM_BUDGET``)."""
    cfg = dryrun.main_path_cfg(tarchs.ARCHS[arch])
    spec = tarchs.SHAPES[shape]
    mesh = ShardMesh(("data", "model"), {"data": 16, "model": 16}, None, 0,
                     torch.device("meta"))
    layout = ShardLayout(cfg, mesh, mode="infer_tp")
    cache, _, _ = tinputs.decode_specs_for(cfg, spec)
    specs = layout.cache_specs(cache)
    local = dict(cache_leaves(layout.block_cache(cache)))
    data = 16 if spec.global_batch % 16 == 0 else 1
    groups = set()
    for path, t in cache_leaves(cache):
        if path[0] not in ("kv", "shared_kv", "cross_kv"):
            continue
        split = "model" in specs[path]
        n = data * (16 if split else 1)
        assert local[path].nbytes * n == t.nbytes, path
        if path[-1] == "k":
            groups.add((path[0], split))
    if cfg.family == "ssm":
        assert not groups
    else:
        assert ("kv" if cfg.family != "hybrid" else "shared_kv", True) \
            in groups
        if cfg.family in ("vlm", "audio"):
            assert ("cross_kv", cfg.family == "vlm") in groups
    assert dryrun.decode_param_mode(cfg, mesh, dryrun.decode_cache(
        cfg, spec, layout)[1]) == "infer_tp"


def _fill(t, salt):
    """A leaf of distinct entries (bools alternate)."""
    n = torch.arange(t.numel()).reshape(t.shape) + salt
    if t.dtype == torch.bool:
        return (n % 2).bool()
    return (n % 1000).to(t.dtype)


@pytest.mark.parametrize("m", [2, 16])
@pytest.mark.parametrize("arch", list(tarchs.ARCHS))
def test_cache_blocks_partition_the_cache(monkeypatch, arch, m):
    """Every rank's ``block_cache`` blocks of a whole serving cache
    (``ARCHS``' widths at one unit of depth, 2 slots, 128 positions;
    both layouts where the family serves them; a (2, m) mesh) put back
    in rank order (``Packed`` channels through the inverse permutation)
    cover it exactly: the round trip ``gather_cache`` makes on a world
    (run at m = 2 on gloo ranks by ``tests/test_torch_serve_mesh.py``).
    This is the head layout (``CACHE_SEQ_SHARD`` False; the key split's
    cells are ``test_decode_cells_split_the_keys``): at m = 16 the KV
    heads split only where ``ShardLayout`` builds the attention's region
    (olmo-1b and zamba2-2.7b), mamba2's ssm heads and rwkv6's heads
    always."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import Packed, entry_axes
    from repro_torch.models import decode as tdec
    from repro_torch.models.config import KVCacheConfig, SataDecodeConfig
    monkeypatch.setattr(sharding, "CACHE_SEQ_SHARD", False)
    base = tarchs.ARCHS[arch]
    unit = base.hybrid_period if base.family == "hybrid" else (
        base.cross_attn_period if base.family == "vlm" else 1)
    layouts = ("contiguous",) if base.family in ("vlm", "ssm") else (
        "contiguous", "paged")
    sizes = {"data": 2, "model": m}
    split = {}
    for layout in layouts:
        cfg = dataclasses.replace(
            base, n_layers=unit, encoder_layers=1, dtype="float32",
            sata=dataclasses.replace(base.sata, decode=SataDecodeConfig(
                mode="on", block=64)), kv=KVCacheConfig(layout=layout))
        whole = tdec.init_cache(cfg, 2, 128, device="cpu")
        leaves = dict(cache_leaves(whole))
        for i, path in enumerate(sorted(leaves)):
            leaves[path].copy_(_fill(leaves[path], i))
        meshes = [ShardMesh(("data", "model"), sizes, None, r,
                            torch.device("cpu")) for r in range(2 * m)]
        specs = ShardLayout(cfg, meshes[0]).cache_specs(whole)
        seen = {p: torch.zeros(t.shape, dtype=torch.int32)
                for p, t in leaves.items()}
        for mesh in meshes:
            blocks = dict(cache_leaves(
                ShardLayout(cfg, mesh).block_cache(whole)))
            for path, t in leaves.items():
                spec, idx = specs[path], []
                for dim, entry in enumerate(spec):
                    n = int(np.prod([sizes[a] for a in entry_axes(entry)]))
                    size = t.shape[dim] // n
                    lo = mesh.coord(entry_axes(entry)) * size if n > 1 else 0
                    ix = torch.arange(lo, lo + size)
                    if isinstance(spec, Packed) and dim == spec.dim and n > 1:
                        ix = spec.order(n)[ix]
                    idx.append(ix)
                grid = torch.meshgrid(*idx, indexing="ij")
                assert torch.equal(t[grid], blocks[path]), (path, mesh.index)
                seen[path][grid] += 1
        for path, t in leaves.items():
            # each entry lies in one block per rank that holds the leaf
            copies = int(np.prod([n for a, n in sizes.items()
                                  if a not in {x for e in specs[path]
                                               for x in entry_axes(e)}]))
            assert bool((seen[path] == copies).all()), path
            split[(layout, path)] = specs[path]
    heads = {p: s for (lay, p), s in split.items() if lay == "contiguous"}
    region = m == 2 or arch in ("olmo-1b", "zamba2-2.7b")
    group = {"hybrid": "shared_kv", "ssm": None}.get(base.family, "kv")
    if group is not None:
        assert (heads[(group, "k")][3] == "model") == region
        assert heads[(group, "plan", "kv_indices")][2] == \
            heads[(group, "k")][3]
        assert heads[(group, "plan", "step")] == (None, "data")
    if base.family == "hybrid":
        assert isinstance(heads[("mamba", "conv")], Packed)
        assert heads[("mamba", "ssm")][2] == "model"
    if base.family == "ssm":
        assert heads[("rwkv", "state")][2] == "model"
        assert heads[("rwkv", "tm_x")] == (None, "data", None)


def test_run_cell_refuses_an_initialised_group_and_leaves_none(
        monkeypatch, tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            dryrun.run_cell("qwen3-4b", "train_4k", False, save=False)
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()

    def boom(*a, **k):
        assert dist.get_backend() == "fake"
        assert dist.get_world_size() == 256
        raise ValueError("boom")
    monkeypatch.setattr(dryrun, "_trace", boom)
    with pytest.raises(ValueError, match="boom"):
        dryrun.run_cell("qwen3-4b", "train_4k", False, save=False)
    assert not dist.is_initialized() and not tctx.cp_enabled()


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k",
                                   "decode_32k"])
def test_small_fake_world_cells_run_context_parallel(monkeypatch, shape):
    """On a (2, 4) fake world a train or prefill cell runs context-
    parallel by default, as the reference's dry run (its B3 calls on the
    rank's S / 4 query rows, where head-parallel they take a quarter of
    the heads), and ``cp=False`` turns it off; a decode
    cell never is.  The switch is off again after every cell."""
    _small(monkeypatch, train=(512, 8), prefill=(512, 8))
    cfg = dryrun.main_path_cfg(tarchs.SMOKE["qwen3-4b"])
    for cp in (True, False):
        r = dryrun.run_cell("qwen3-4b", shape, False, save=False,
                            verbose=False, cfg=cfg, mesh_shape=(2, 4), cp=cp)
        assert not tctx.cp_enabled()
        ran = cp and shape != "decode_32k"
        assert r["ok"] and r["cp"] is ran and ("notes" in r) is ran
        if shape == "decode_32k":
            continue
        b, s = tarchs.SHAPES[shape].global_batch, tarchs.SHAPES[shape].seq_len
        # context-parallel: every head on the rank's S / 4 query rows;
        # else the rank's 1 of SMOKE's 4 heads on all S
        h, sq = (cfg.n_heads, s // 4) if cp else (cfg.n_heads // 4, s)
        q = torch.empty((b // 2 * h, sq, cfg.hd))
        assert r["kernels"]["sata_block_attention_compact"]["flops"] == \
            r["kernels"]["sata_block_attention_compact"]["calls"] * \
            ops.block_attention_work(q, None, s // 128, q_block=128,
                                     k_block=128)[0]


# ---------------------------------------------------------------------------
# analyse_cell and the report against the reference's
# ---------------------------------------------------------------------------

PROBES = [(3.0e13, 5.0e11, 2.0e9), (5.5e13, 9.0e11, 2.5e9)]
CELLS = [("qwen3-4b", "train_4k"), ("qwen3-moe-235b-a22b", "prefill_32k"),
         ("zamba2-2.7b", "train_4k"), ("llama-3.2-vision-90b", "prefill_32k"),
         ("whisper-base", "train_4k"), ("rwkv6-1.6b", "train_4k"),
         ("rwkv6-1.6b", "prefill_32k")]
REFERENCE = r"""
import json, pathlib, sys
from repro.launch import roofline as R
cells, probes, tmp = json.loads(sys.argv[1]), json.loads(sys.argv[2]), \
    sys.argv[3]
R.RESULTS = pathlib.Path(tmp)
out = {}
for arch, shape in cells:
    calls = []
    def measure(arch, shape_name, cfg, cp=True):
        f, b, c = probes[len(calls)]
        calls.append(cfg.n_layers)
        return f, b, c, {}
    R._measure = measure
    out[arch + "/" + shape] = [R.analyse_cell(arch, shape, verbose=False),
                               calls]
print("JSON" + json.dumps(out))
"""


def _stub_measure(monkeypatch, calls):
    def measure(arch, shape_name, cfg, param_mode=None, cp=True):
        f, b, c = PROBES[len(calls)]
        calls.append(cfg.n_layers)
        return f, b, c, {"memory": {"argument_size_in_bytes": 0,
                                    "temp_size_in_bytes": 0},
                         "cost": {"flops": f, "bytes accessed": b},
                         "collectives": {"per_kind": {"all-reduce": c}}}
    monkeypatch.setattr(troof, "_measure", measure)


def test_analyse_cell_equals_the_reference_with_h100_peaks(monkeypatch,
                                                           tmp_path):
    ref = subprocess.run(
        [sys.executable, "-c", REFERENCE, json.dumps(CELLS),
         json.dumps(PROBES), str(tmp_path / "ref")], env=_env(),
        capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-4000:]
    want = json.loads(ref.stdout.split("JSON", 1)[1])
    assert (tmp_path / "ref" / "qwen3-4b__train_4k__pod1.json").exists()
    monkeypatch.setattr(troof, "OUT_DIR", tmp_path / "port")
    for arch, shape in CELLS:
        calls = []
        _stub_measure(monkeypatch, calls)
        got = troof.analyse_cell(arch, shape, verbose=False)
        w, wcalls = want[f"{arch}/{shape}"]
        assert calls == wcalls, (arch, calls, wcalls)
        for k in ("cell", "arch", "shape", "model_flops"):
            assert got[k] == w[k], k
        for k in ("unit_layers", "n_units", "f1", "f2", "c1", "c2", "b1",
                  "b2"):
            assert got["probe"][k] == w["probe"][k], k
        scan = got["per_device"]["rwkv_scan_flops"]
        if arch.startswith("rwkv6"):
            # the reference's 5 hd² MACs of all 32 heads; the port adds 4
            # of them (the counter sees r·S) for a rank's 2 heads
            wscan = w["per_device"]["hlo_flops"] - (
                max(w["probe"]["f1"] - (w["probe"]["f2"] - w["probe"]["f1"]),
                    0) + w["probe"]["n_units"] * (w["probe"]["f2"]
                                                  - w["probe"]["f1"]))
            assert scan == pytest.approx(wscan * 4 / 5 * 2 / 32, rel=1e-12)
        else:
            assert scan == 0
        assert got["per_device"]["hlo_flops"] == pytest.approx(
            w["per_device"]["hlo_flops"] - (wscan if scan else 0) + scan,
            rel=1e-12)
        for k in ("hlo_bytes", "collective_bytes"):
            assert got["per_device"][k] == w["per_device"][k], k
        flops = got["per_device"]["hlo_flops"]
        terms = {"compute_s": flops / 989e12,
                 "memory_s": w["per_device"]["hlo_bytes"] / 3.35e12,
                 "collective_s": w["per_device"]["collective_bytes"] / 450e9}
        assert got["terms_s"] == terms
        if not scan:
            # the same counts over the other card's peaks
            assert terms["compute_s"] * 989e12 == pytest.approx(
                w["terms_s"]["compute_s"] * 197e12, rel=1e-12)
            assert got["useful_ratio"] == w["useful_ratio"]
            assert got["hlo_flops_global"] == w["hlo_flops_global"]
        assert got["dominant"] == max(terms, key=terms.get)[:-2]
        assert got["roofline_fraction"] == terms["compute_s"] / max(
            terms.values())
        assert got["peaks"] == {"bf16_flops_per_s": 989e12,
                                "hbm_bytes_per_s": 3.35e12,
                                "nvlink_bytes_per_s": 450e9}
        path = tmp_path / "port" / f"{got['cell']}.json"
        assert json.loads(path.read_text()) == got


def test_report_tables_equal_the_reference(monkeypatch, tmp_path):
    _small(monkeypatch)
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path / "dryrun")
    monkeypatch.setattr(troof, "OUT_DIR", tmp_path / "roofline")
    dryrun.run_cell("olmo-1b", "train_4k", False, verbose=False,
                    cfg=tarchs.SMOKE["olmo-1b"])
    dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k"])
    _stub_measure(monkeypatch, [])
    troof.analyse_cell("qwen3-4b", "train_4k", verbose=False)
    monkeypatch.setattr(jreport, "ROOT", tmp_path)
    monkeypatch.setattr(treport, "ROOT", tmp_path)
    assert treport.roofline_table() == jreport.roofline_table()
    got, want = treport.dryrun_table(), jreport.dryrun_table()
    assert got.split("\n\n")[0] == want.split("\n\n")[0]
    assert len(got.splitlines()) == 6          # header, rule, 2 cells, note
