"""Port parity for the scale-out wrappers (``repro_torch.launch.mesh``).

Two gloo ranks on the CPU (``tests/torch_mesh_ranks.py``), started once
for the module through a ``FileStore`` under the test's temp directory
(no TCP port, so parallel test workers cannot collide), run every
sharded case; each test compares their gathered results with the port's
single-device run and holds that against JAX's, at
``tests/test_mesh_serving.py``'s sizes.  One start per module: each
rank imports torch and the port, which costs more than every case
together.

Inside the port, sharded == one device is bitwise (the parity rule for
a TP shard).  Against JAX: block maps, plan rows and counts exactly;
thresholds at 1e-6 of their scale (``tests/test_torch_plan.py``: the
score einsum sums in another order); the sequence-sharded output at
1e-5 max abs (measured 3.6e-7); the decode output at 1e-6 max abs
(``tests/test_torch_kernels.py``'s fp32 limit; measured 2.4e-7)."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
from repro.launch import mesh as JM  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

WORLD = 2
THR_RTOL = 1e-6
SEQ_ATOL = 1e-5
DEC_ATOL = 1e-6
WORKER = pathlib.Path(R.__file__)
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, from one 2-rank gloo world."""
    tmp = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(WORLD),
         str(tmp / "store"), str(tmp / f"rank{r}.pt")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


@pytest.fixture(scope="module")
def local():
    """The same cases on the one-rank mesh."""
    return R.run_cases(M.make_local_mesh(device="cpu"))


def _equal(a, b, what=""):
    """Bitwise equality of tensors, or of dicts / tuples / lists of
    them."""
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a, b), what
    else:
        assert a == b, what


def _thr_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=THR_RTOL * float(np.abs(want).max()))


def test_ranks_agree_and_stage_nothing_on_the_cpu(ranks):
    """Both ranks return the same global results; CPU tensors go
    through gloo without a host copy."""
    r0, r1 = ranks
    _equal({k: v for k, v in r0.items() if k != "refusals"},
           {k: v for k, v in r1.items() if k != "refusals"})
    assert r0["host_staged_bytes"] == 0


@pytest.mark.parametrize("seed", R.SEQ_SEEDS)
def test_sequence_sharded_selection_parity(ranks, local, seed):
    """Sharded == the port's single-device run bitwise; the port's
    ``sequence_local_attention`` against JAX's."""
    out, stats = ranks[0][f"seq{seed}"]
    q, k, v = R.qkv(seed)
    ref, rstats = M.sequence_local_attention(
        *R._t(q, k, v), k_sel=R.K_SEL, q_block=8, k_block=8)
    for name in ("thresholds", "block_map", "kv_counts"):
        _equal(stats[name], rstats[name], name)
    _equal(out, ref, "out")
    lout, lstats = local[f"seq{seed}"]
    _equal(lout, ref, "one-rank mesh")
    assert int(lstats["fetched_tiles_per_shard"]) == \
        int(rstats["fetched_tiles"])
    jref, jstats = JM.sequence_local_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), k_sel=R.K_SEL,
        q_block=8, k_block=8)
    for name in ("block_map", "kv_counts"):
        np.testing.assert_array_equal(rstats[name].numpy(),
                                      np.asarray(jstats[name]), name)
    assert int(rstats["fetched_tiles"]) == int(jstats["fetched_tiles"])
    _thr_close(rstats["thresholds"], jstats["thresholds"])
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=0,
                               atol=SEQ_ATOL)


def test_sequence_sharded_fetch_is_plan_proportional(ranks):
    """The shards' compact fetches partition the single-device plan."""
    _, stats = ranks[0]["seq1"]
    _, rstats = M.sequence_local_attention(
        *R._t(*R.qkv(1)), k_sel=R.K_SEL, q_block=8, k_block=8)
    per_shard = stats["fetched_tiles_per_shard"]
    assert per_shard.shape == (WORLD,)
    assert int(per_shard.sum()) == int(rstats["fetched_tiles"])
    assert (per_shard > 0).all()


def _plain_step(qg, k, v, kn, pos, plan, table):
    """The port's single-device step: summaries, plan, decode (on a
    copy of ``plan``: the port updates it in place)."""
    from repro_torch.core.decode_plan import (decode_plan_update,
                                              update_block_summaries)
    from repro_torch.kernels.ops import sata_decode_attention
    plan = {n: t.clone() for n, t in plan.items()}
    plan = update_block_summaries(plan, kn, pos, k_block=R.KB)
    plan, thr = decode_plan_update(plan, qg, k, pos, topk_k=R.TOPK,
                                   k_block=R.KB, replan_interval=1,
                                   page_table=table)
    out = sata_decode_attention(qg, k, v, plan["kv_indices"],
                                plan["kv_counts"], thr, pos, k_block=R.KB,
                                page_table=table)
    return out, plan


def _jax_step(qg, k, v, kn, pos, plan, table):
    """``tests/test_mesh_serving.py``'s ``_reference_step``, with the
    page table passed through in the paged layout."""
    from repro.core.decode_plan import (decode_plan_update,
                                        update_block_summaries)
    from repro.kernels.ops import sata_decode_attention
    plan = update_block_summaries(plan, kn, pos, k_block=R.KB)
    plan, thr = decode_plan_update(plan, qg, k, pos, topk_k=R.TOPK,
                                   k_block=R.KB, replan_interval=1,
                                   page_table=table)
    out = sata_decode_attention(qg, k, v, plan["kv_indices"],
                                plan["kv_counts"], thr, pos, k_block=R.KB,
                                page_table=table)
    return out, plan


def _jax_steps(layout, carry):
    from repro.core.decode_plan import init_decode_plan
    plan = init_decode_plan(R.B, R.KV, R.SMAX, R.D, R.KB)

    def step(qg, k, v, kn, pos, _, table):
        nonlocal plan
        jt = None if table is None else jnp.asarray(table.numpy())
        out, plan = _jax_step(*(jnp.asarray(a.numpy())
                                for a in (qg, k, v, kn, pos)), plan, jt)
        return out, plan

    return R.decode_steps(step, layout, carry)


@pytest.mark.parametrize("carry", [False, True], ids=["one_step", "carry3"])
@pytest.mark.parametrize("layout", R.LAYOUTS)
def test_tensor_parallel_decode_parity(ranks, local, layout, carry):
    """Two ranks == the one-rank mesh == the plain single-device step,
    bitwise, over one step or a 3-step carry (the sharded plan fed
    straight back); the plain step against JAX's."""
    name = f"tp_{layout}_{'carry' if carry else 'one'}"
    sharded = ranks[0][name]
    _equal(sharded, local[name], "one-rank mesh")
    plain = R.decode_steps(_plain_step, layout, carry)
    _equal(sharded, plain, "plain step")
    for i, ((out, plan), (jout, jplan)) in enumerate(
            zip(plain, _jax_steps(layout, carry))):
        assert set(plan) == set(jplan)
        for leaf, val in plan.items():
            np.testing.assert_array_equal(val.numpy(), np.asarray(jplan[leaf]),
                                          f"step {i} {leaf}")
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                                   atol=DEC_ATOL, err_msg=f"step {i}")


def test_paged_equals_contiguous_bitwise(ranks):
    """The layouts' outputs and plans agree bit for bit, sharded."""
    for carry in ("one", "carry"):
        _equal(ranks[0][f"tp_paged_{carry}"],
               ranks[0][f"tp_contiguous_{carry}"], carry)


@pytest.mark.parametrize("summary", ["fp32", "int8"])
def test_plan_pspecs_match_the_reference(summary):
    from repro.core.decode_plan import init_decode_plan as jinit
    from repro_torch.core.decode_plan import init_decode_plan as tinit
    jspecs = JM.plan_pspecs(jinit(2, 4, 32, 8, 8, summary=summary, qos=True,
                                  retire=True), "kv")
    tspecs = M.plan_pspecs(tinit(2, 4, 32, 8, 8, summary=summary, qos=True,
                                 retire=True, device="cpu"), "kv")
    assert tspecs == {n: tuple(s) for n, s in jspecs.items()}


def test_refusals_mirror_the_reference(ranks):
    """``make_shard_mesh`` past the world raises ValueError, as the
    reference's past its devices does; KV heads or Sq that do not tile
    by the shard count fail the reference's asserts; ``train`` refuses a
    mesh without the ("data", "model") axes its placements read (the
    1-D shard mesh; ``tests/test_torch_mesh_train.py`` trains on
    ("data", "model") meshes)."""
    got = ranks[0]["refusals"]
    assert got == ranks[1]["refusals"]
    kind, msg = got["make_shard_mesh(4)"]
    assert kind == "ValueError" and msg.startswith("need 4 ranks, have 2")
    n = len(jax.devices()) + 1
    with pytest.raises(ValueError, match=f"need {n} devices"):
        JM.make_shard_mesh(n)
    assert got["kv_not_tiling"] == ("AssertionError", "(3, 2)")
    assert got["sq_not_tiling"] == ("AssertionError", "(24, 2, 8)")
    kind, msg = got["train_on_two_ranks"]
    assert kind == "ValueError" and "('data', 'model')" in msg
    # a one-shard mesh in the 2-rank world: each rank alone, no group
    for r in ranks:
        assert r["one_rank_mesh"] == ({"shard": 1}, None, 0)


def test_mesh_makers_without_a_process_group():
    """The one-rank local mesh needs no process group; the production
    mesh and a 2-shard mesh refuse a world of one; ``activate_mesh``
    installs nothing; ``data_axes`` as the reference's."""
    mesh = M.make_local_mesh(device="cpu")
    jmesh = JM.make_local_mesh()
    assert mesh.axis_names == tuple(jmesh.axis_names)
    assert mesh.shape == dict(jmesh.shape) and mesh.size == 1
    assert M.data_axes(mesh) == JM.data_axes(jmesh) == ("data",)
    assert M.make_shard_mesh(1, device="cpu").shape == {"shard": 1}
    with M.activate_mesh(mesh) as m:
        assert m is mesh
    for make in (lambda: M.make_shard_mesh(2, device="cpu"),
                 lambda: M.make_production_mesh(device="cpu"),
                 lambda: M.make_production_mesh(multi_pod=True,
                                                device="cpu")):
        with pytest.raises(ValueError, match="ranks, have 1"):
            make()


def test_serve_and_train_take_the_local_mesh():
    """``serve(mesh=)`` binds the mesh and serves as without it (the
    reference only binds it too); ``train(mesh=make_local_mesh())`` is
    ``train()``."""
    from repro_torch.launch.serve import ServeOptions, serve
    from repro_torch.launch.train import train
    opts = ServeOptions(n_requests=3, batch_slots=2, gen_len=4, max_len=32)
    mesh = M.make_local_mesh(device="cpu")
    want = serve("qwen3-4b", options=opts, device="cpu")
    got = serve("qwen3-4b", options=opts, device="cpu", mesh=mesh)
    assert got["outputs"] == want["outputs"] and got["steps"] == want["steps"]
    kw = dict(steps=2, batch=1, seq=16, device="cpu")
    want = train("qwen3-4b", **kw)
    got = train("qwen3-4b", mesh=mesh, **kw)
    assert got["losses"] == want["losses"] and got["gnorms"] == want["gnorms"]
