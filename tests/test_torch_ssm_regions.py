"""mamba2's and rwkv6's "model" regions (``distributed.sharding``,
``models.mamba2`` / ``models.rwkv6``) on two gloo ranks, (1, 2).

``tests/torch_mesh_train_ranks.py regions`` runs one layer of SMOKE
zamba2 and SMOKE rwkv6 (fp32) on each rank's heads and the whole layer
on one device, from the same weights: layer 0's heads read inputs whose
scales span 10^-2 .. 10^2 (mamba2's x columns of ``in_proj``, rwkv6's
``wk`` columns), so a gated RMS norm taken over one rank's heads misses
by orders of magnitude, and a channel mix whose gathered output summed
its gradient over the ranks would double every gradient below it.  The
output, the input's gradient and every leaf's gradient (the rank's
blocks gathered) are held to REGION_TOL of their largest entry: fp32
summation order (the row-parallel and B|C sums; measured up to 2.7e-6,
``a_log``).  Bitwise: ``gather_params`` of ``shard_``, and a checkpoint
saved on the mesh (its files hold the global parameters and moments)
and restored into the ranks' blocks.  The placement of mamba2's packed
``in_proj`` [z | x | B|C | dt] and ``conv_w`` [x | B|C] is checked on
the blocks a rank takes."""
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

import torch_mesh_train_ranks as R  # noqa: E402
from repro_torch.configs.archs import SMOKE  # noqa: E402
from repro_torch.distributed.sharding import param_specs  # noqa: E402
from repro_torch.launch.mesh import ShardMesh  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

REGION_TOL = 1e-5
WORKER = pathlib.Path(R.__file__)
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' ``region_case`` results, by case."""
    tmp = tmp_path_factory.mktemp("ssm_regions")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), str(WORKER.parent), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), "regions", str(r), str(tmp)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return torch.load(tmp / "regions.pt")


def _near(got, want, what):
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    assert err <= REGION_TOL * top, (what, err, top)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("case", sorted(R.REGION_ARCHS))
def test_region_matches_one_device(ranks, case, rank):
    """The layer's output and every gradient on the rank's heads against
    the whole layer on one device: among them mamba2's ``norm_scale``,
    ``a_log``, ``dt_bias`` and ``in_proj`` (its B|C columns included),
    rwkv6's ``wb``, ``w0``, ``cr`` and ``ck``."""
    res = ranks[rank][case]
    out, gx, grads = res["region"]
    out1, gx1, grads1 = res["one"]
    _near(out, out1, "output")
    _near(gx, gx1, "input gradient")
    assert set(grads) == set(grads1)
    for n in grads1:
        assert grads[n].shape == grads1[n].shape, n
        _near(grads[n], grads1[n], n)


@pytest.mark.parametrize("case", sorted(R.REGION_ARCHS))
def test_placement_round_trips_bitwise(ranks, case):
    """``gather_params(shard_(model))``, and a mesh checkpoint of the
    parameters and AdamW-shaped moments, give back the global leaves
    bit for bit (the files hold them; restore puts back each block)."""
    for rank in range(2):
        res = ranks[rank][case]
        assert res["gathered"] and all(res["gathered"].values()), rank
        assert res["saved"] and all(res["saved"].values()), \
            (rank, [n for n, ok in res["saved"].items() if not ok])
        assert any(n.startswith("opt.m.") for n in res["saved"])
        assert res["restored"] and all(res["restored"].values()), rank


def test_a_rank_holds_its_heads_columns(ranks):
    """Rank r's ``in_proj`` block is [its heads' z | their x | its 1/2
    of B|C | its heads' dt] and its ``conv_w`` block [its heads' x | its
    1/2 of B|C]; the two leaves carry ``Packed`` specs equal to the
    reference's tuples, and the other families' specs stay plain."""
    cfg = SMOKE[R.REGION_ARCHS["zamba2"]]
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    plain = param_specs(Model(cfg, device="meta"), cfg, ShardMesh(
        ("data", "model"), dict(zip(("data", "model"), R.REGION_MESH)),
        None, 0, torch.device("cpu")))
    w_in = torch.arange(2 * di + 2 * n + h, dtype=torch.float32)
    w_conv = torch.arange(di + 2 * n, dtype=torch.float32)
    for r in range(2):
        res = ranks[r]["zamba2"]
        heads = slice(r * di // 2, (r + 1) * di // 2)
        bc = slice(2 * di + r * n, 2 * di + (r + 1) * n)
        dt = slice(2 * di + 2 * n + r * h // 2,
                   2 * di + 2 * n + (r + 1) * h // 2)
        want_in = torch.cat([w_in[heads], w_in[di:][heads], w_in[bc],
                             w_in[dt]])
        want_conv = torch.cat([w_conv[heads], w_conv[di + r * n:
                                                     di + (r + 1) * n]])
        assert torch.equal(res["cols"]["in_proj"], want_in), r
        assert torch.equal(res["cols"]["conv_w"], want_conv), r
        specs = res["specs"]
        for leaf, kind in (("in_proj", "Packed"), ("conv_w", "Packed"),
                           ("out_proj", "tuple")):
            spec, got = specs["layers.0.mixer." + leaf]
            assert spec == plain["layers.0.mixer." + leaf] and \
                got == kind, (leaf, spec, got)
    assert all(kind == "tuple" for _, kind in
               ranks[0]["rwkv6"]["specs"].values())
