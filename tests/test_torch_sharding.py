"""Port parity for the sharding rules (``repro_torch.distributed.sharding``
and ``.ctx``) against the reference's, exactly.

For every arch of ``ARCHS`` (published widths) and ``SMOKE``, on the
single-pod (16, 16) and multi-pod (2, 16, 16) production mesh shapes:
``param_specs`` in both modes on a meta-device ``Model`` equal the
reference's on ``jax.eval_shape(init_params)``, the reference's stack
dims stripped (the port's layers are ``ModuleList``s); ``batch_specs``
and ``cache_specs`` equal the reference's on the same shapes (the
port's vlm self-attention cache is one flat layer stack, the
reference's (n_cross, per_group): its trailing dims are compared, and
the extra lead entry must be None); ``make_activation_shardings``,
``scores_spec`` and ``heads_spec`` equal the specs of the reference's
``NamedSharding``s and ``constrain_scores`` / ``constrain_heads``.  The
reference's rules read only ``mesh.axis_names`` and ``mesh.shape``:
the meshes are ``jax.sharding.AbstractMesh``es, no devices, and the
port's a stand-in with the same two fields.  ``block`` / ``gather`` /
``counted_once`` are checked on a one-process mesh stand-in."""
import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.distributed import ctx as jctx  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.config import KVCacheConfig as JKV  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.distributed import ctx as tctx  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models.config import KVCacheConfig as TKV  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCH_CASES = [(table, arch) for table in ("ARCHS", "SMOKE")
              for arch in sorted(tarchs.ARCHS)]
IDS = [f"{t}-{a}" for t, a in ARCH_CASES]


def _meshes(name):
    """(the reference's abstract mesh, the port's stand-in)."""
    sizes, axes = MESHES[name]
    return (AbstractMesh(sizes, axes),
            types.SimpleNamespace(axis_names=axes,
                                  shape=dict(zip(axes, sizes))))


def _cfgs(table, arch):
    return getattr(jarchs, table)[arch], getattr(tarchs, table)[arch]


@functools.cache
def _jax_param_shapes(table, arch):
    cfg = getattr(jarchs, table)[arch]
    return jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                     cfg))


def _names(path):
    return tuple(str(getattr(p, "key", getattr(p, "name", p)))
                 for p in path)


def _ref_specs(tree):
    """{path tuple: spec tuple} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_names(p): tuple(s) for p, s in flat}


def _stack_dims(path, cfg):
    if path[0] not in ("layers", "cross_layers", "enc_layers"):
        return 0
    return 2 if path[0] == "layers" and cfg.family == "vlm" else 1


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("table,arch", ARCH_CASES, ids=IDS)
def test_param_specs_match(table, arch, mesh_name):
    jc, tc = _cfgs(table, arch)
    jmesh, tmesh = _meshes(mesh_name)
    model = Model(tc, device="meta")
    shapes = _jax_param_shapes(table, arch)
    for mode in ("train", "infer_tp"):
        want = _ref_specs(jsh.param_specs(shapes, jc, jmesh, mode=mode))
        got = tsh.param_specs(model, tc, tmesh, mode=mode)
        seen = set()
        for name, spec in got.items():
            path = tuple(p for p in name.split(".") if not p.isdigit())
            ref = want[path]
            lead = _stack_dims(path, tc)
            assert ref[:lead] == (None,) * lead, (mode, name, ref)
            assert spec == ref[lead:], (mode, name, spec, ref)
            seen.add(path)
        assert seen == set(want), (mode, set(want) ^ seen)
        assert any(s for s in got.values() if any(e is not None for e in s))


def _batch_shapes(cfg, b, s=64):
    shapes = {"tokens": (b, s), "labels": (b, s), "loss_mask": (b, s)}
    if cfg.family == "vlm":
        shapes["image_embeds"] = (b, cfg.n_image_tokens, cfg.d_model)
    if cfg.family == "audio":
        shapes["audio_embeds"] = (b, cfg.encoder_len, cfg.d_model)
    return shapes


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("table,arch", ARCH_CASES, ids=IDS)
def test_batch_and_cache_specs_match(table, arch, mesh_name):
    jc, tc = _cfgs(table, arch)
    jmesh, tmesh = _meshes(mesh_name)
    for b in (1, 8, 16, 32):
        shapes = _batch_shapes(tc, b)
        want = _ref_specs(jsh.batch_specs(
            {n: jax.ShapeDtypeStruct(s, np.float32)
             for n, s in shapes.items()}, jmesh))
        got = tsh.batch_specs(shapes, tmesh)
        assert {(n,): s for n, s in got.items()} == want, b
    jcache = jax.eval_shape(lambda: jdec.init_cache(jc, 16, 256))
    want = _ref_specs(jsh.cache_specs(jcache, jc, jmesh))
    got = tsh.cache_specs(tdec.init_cache(tc, 16, 256, device="meta"), tc,
                          tmesh)
    assert set(got) == set(want), set(got) ^ set(want)
    for path, spec in got.items():
        ref = want[path]
        lead = len(ref) - len(spec)
        assert ref[:lead] == (None,) * lead and spec == ref[lead:], \
            (path, spec, ref)
    if tc.family in ("dense", "moe"):
        # the paged layout's (L, B, pages) page table has no (B, S, KV,
        # hd) tail: the reference's rule fails on it, and the port's too
        jcl = dataclasses.replace(jc, kv=JKV(layout="paged"))
        tcl = dataclasses.replace(tc, kv=TKV(layout="paged"))
        with pytest.raises(IndexError):
            jsh.cache_specs(jax.eval_shape(
                lambda: jdec.init_cache(jcl, 16, 256)), jcl, jmesh)
        with pytest.raises(IndexError):
            tsh.cache_specs(tdec.init_cache(tcl, 16, 256, device="meta"),
                            tcl, tmesh)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("table,arch", ARCH_CASES, ids=IDS)
def test_activation_specs_match(table, arch, mesh_name, monkeypatch):
    jc, tc = _cfgs(table, arch)
    jmesh, tmesh = _meshes(mesh_name)
    for seq_shard in (False, True):
        want = jctx.make_activation_shardings(jmesh, jc, seq_shard=seq_shard)
        got = tctx.make_activation_shardings(tmesh, tc, seq_shard=seq_shard)
        assert got == {k: tuple(v.spec) for k, v in want.items()}
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s.spec)))
    jctx.set_activation_shardings({}, mesh=jmesh)
    try:
        g = tc.n_heads // tc.n_kv_heads
        for kv, gg, s in ((tc.n_kv_heads, g, 4096), (3, 5, 4096),
                          (3, 16, 7), (3, 5, 7)):
            shape = (16, kv, gg, 128, s)
            jctx.constrain_scores(jax.ShapeDtypeStruct(shape, np.float32))
            assert tctx.scores_spec(shape, tmesh) == seen[-1], shape
        for h, hd in ((tc.n_heads, tc.hd), (3, 128), (3, 5)):
            shape = (16, 128, h, hd)
            jctx.constrain_heads(jax.ShapeDtypeStruct(shape, np.float32))
            assert tctx.heads_spec(shape, tmesh) == seen[-1], shape
    finally:
        jctx.clear()


def test_ctx_keeps_specs_and_constrains_nothing():
    """``set_activation_shardings`` keeps the tuples, ``constrain``
    returns its argument, ``clear`` forgets them."""
    _, tmesh = _meshes("16x16")
    cfg = tarchs.SMOKE["qwen3-4b"]
    tctx.set_activation_shardings(tctx.make_activation_shardings(tmesh, cfg),
                                  mesh=tmesh)
    try:
        assert tctx.activation_spec("act") == ("data", None, None)
        x = torch.ones(2, 3)
        assert tctx.constrain(x, "act") is x
    finally:
        tctx.clear()
    assert tctx.activation_spec("act") is None


class _Rank:
    """A mesh stand-in for one rank of a (2, 2) mesh: ``coord`` only
    (``block`` reads no collective)."""

    def __init__(self, index, shape=(("data", 2), ("model", 2))):
        self.axis_names = tuple(a for a, _ in shape)
        self.shape = dict(shape)
        self.index = index
        from repro_torch.launch.mesh import ShardMesh
        self._m = ShardMesh(self.axis_names, self.shape, None, index,
                            torch.device("cpu"))

    def coord(self, axis):
        return self._m.coord(axis)


def test_blocks_tile_the_global_tensor():
    """The four ranks' blocks of a (data, model)-sharded leaf tile it
    in row-major rank order; ``counted_once`` picks one rank per block
    of a leaf replicated over an axis; the data axes of a multi-pod
    mesh read as one axis, pod-major."""
    full = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    spec = ("data", "model")
    blocks = [tsh.block(full, spec, _Rank(r)) for r in range(4)]
    top = torch.cat(blocks[:2], dim=1)
    assert torch.equal(torch.cat([top, torch.cat(blocks[2:], dim=1)]), full)
    assert [tsh.counted_once(("data", None), _Rank(r)) for r in range(4)] \
        == [True, False, True, False]
    assert [tsh.counted_once((None, None), _Rank(r)) for r in range(4)] \
        == [True, False, False, False]
    pod = (("pod", 2), ("data", 2), ("model", 2))
    rows = [tsh.block(full, (("pod", "data"), None), _Rank(r, pod))
            for r in range(8)]
    assert torch.equal(torch.cat(rows[::2]), full)      # model coord 0
    assert torch.equal(rows[0], rows[1])


def test_param_specs_refuse_an_unknown_mode():
    _, tmesh = _meshes("16x16")
    cfg = tarchs.SMOKE["qwen3-4b"]
    with pytest.raises(ValueError, match="infer_tp"):
        tsh.param_specs(Model(cfg, device="meta"), cfg, tmesh, mode="serve")
