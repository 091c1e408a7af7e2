"""Mesh builders and the SATA scale-out wrappers on ``torch.distributed``
— port of ``repro.launch.mesh``.

The reference's meshes are JAX device meshes and its wrappers run under
``shard_map``.  Here a mesh is a :class:`ShardMesh`: the axis names and
sizes, the ``torch.distributed`` process group whose ranks it spans,
this rank's index in it and the device the rank computes on.  The
wrappers are SPMD functions: every rank of the group calls them with
the same global arguments, takes its own shard, and returns the global
results gathered along the shard axis, as ``shard_map``'s ``out_specs``
do.  The caller starts the process group (``dist.init_process_group``);
nothing here starts one.

* **Sequence-sharded selection** (``sequence_sharded_attention``):
  queries shard along Sq; every selection reduction in
  ``select_thresholds_chunked`` is row-local, so each shard's
  thresholds and occupancy are bitwise the corresponding rows of the
  single-device run.  Each shard builds its own ``compact_kv_plan`` and
  gathers only the K/V tiles that plan selects.  The transport is an
  all-gather standing in for the tile-granular RDMA a real interconnect
  issues; what the epilogue touches is only the planned tiles.
* **Tensor-parallel decode** (``tensor_parallel_decode_step``): the
  decode plan state, the KV cache and the decode kernel are independent
  per (slot, KV head), so sharding over KV heads needs no collective
  but the final gather: ``plan_pspecs`` names each plan leaf's KV axis
  and the kernel runs unchanged on the rank's heads.

Bitwise parity with one device needs every floating-point product to
run at the same call shape in both (the BLAS picks its summation order
by shape): the selection's score products and the epilogue run one
q-block at a time on contiguous copies, so a shard's calls are the
single-device run's calls.  The decode planner's products keep their
per-(slot, head) shape on a rank's heads; only their batch count
changes.

A mesh may have several axes (``make_train_mesh``'s ("data",
"model"), the production meshes): ``coord`` reads a rank's coordinate
on an axis row-major, as a JAX mesh's device array is laid out, and
the collectives (``_all_gather``, ``_all_reduce``, ``_reduce_scatter``)
run over one axis, or a tuple of axes read as one, through the process
group of the ranks that share the other coordinates (``_axis_groups``,
created collectively when the mesh is built).

Every collective counts its logical bytes by kind on the mesh
(``ShardMesh.collective_bytes``, the reference dry run's convention:
the result operand's bytes, an all-reduce twice), whatever the backend.

The production mesh (``make_production_mesh``) spans 256 ranks (512
multi-pod).  ``fake_world`` starts such a world on torch's ``"fake"``
process-group backend, whose collectives move nothing: with
``device="meta"`` one rank of the production mesh traces its step on
meta tensors (``launch.dryrun``).

The wrappers install no global device context (the reference's
``mesh_installed()`` route-off exists for ``pallas_call``'s missing
SPMD rule, which has no counterpart here): ``activate_mesh`` is a
context manager that installs nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core.blockmap import bisect_select, compact_kv_plan
from repro_torch.core.decode_plan import (decode_plan_update,
                                          update_block_summaries)
from repro_torch.core.selection import NEG_INF, select_thresholds_chunked
from repro_torch.kernels.ops import sata_decode_attention


@dataclasses.dataclass(eq=False)
class ShardMesh:
    """A mesh of ``torch.distributed`` ranks, one device each.

    ``shape`` maps each axis name to its size, as a JAX mesh's does;
    ``group`` is the process group the mesh spans (the whole world, or
    ``None`` for a one-rank mesh, which needs none); ``index`` is this
    rank's index on the mesh; ``device`` is the device this rank
    computes on.  ``host_staged_bytes`` counts the bytes the
    collectives copied between the device and the host (gloo on CUDA
    tensors); ``collective_bytes`` the logical bytes of each kind of
    collective ("all-gather", "all-reduce", "reduce-scatter"), as
    ``_count_collective`` says."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    group: Optional[object]
    index: int
    device: torch.device
    host_staged_bytes: int = 0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # the process group over each proper subset of the axes whose ranks
    # this rank shares (``_axis_groups``), keyed by the axes in mesh order
    groups: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coord(self, axis) -> int:
        """This rank's index along ``axis`` (a name, or a tuple of names
        read as one axis, major to minor, as a ``PartitionSpec`` entry
        is): the mesh index is row-major over ``axis_names``, as a JAX
        mesh's device array is."""
        idx = 0
        for a in _axes(self, axis):
            stride = math.prod(self.shape[b] for b in
                               self.axis_names[self.axis_names.index(a) + 1:])
            idx = idx * self.shape[a] + (self.index // stride) % self.shape[a]
        return idx

    def axis_size(self, axis) -> int:
        """The number of ranks along ``axis`` (a name or a tuple)."""
        return math.prod(self.shape[a] for a in _axes(self, axis))

    def group_of(self, axis):
        """The process group of the ranks that share this rank's
        coordinates off ``axis``: the mesh's own group when ``axis``
        spans the mesh, None on a one-rank axis."""
        axes = _axes(self, axis)
        n = self.axis_size(axes)
        if n == 1:
            return None
        if n == self.size:
            return self.group
        return self.groups[tuple(a for a in self.axis_names if a in axes)]


def _axes(mesh, axis) -> Tuple[str, ...]:
    """``axis`` as a tuple of names: None is the mesh's first axis."""
    if axis is None:
        return (mesh.axis_names[0],)
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _world() -> Tuple[int, int]:
    """(world size, rank) of the initialised default group; (1, 0)
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device,
               what: str) -> ShardMesh:
    dev = resolve_device(device)
    n = math.prod(shape)
    world, rank = _world()
    if n == 1:                    # every rank alone, no collective
        return ShardMesh(tuple(axes), dict(zip(axes, shape)), None, 0, dev)
    if world != n:
        raise ValueError(
            f"need {n} ranks, have {world} — start {what} with "
            f"torch.distributed.init_process_group(world_size={n}), one "
            f"process per rank, before building the mesh (a mesh of more "
            f"than one rank spans the whole world)")
    return ShardMesh(tuple(axes), dict(zip(axes, shape)), dist.group.WORLD,
                     rank, dev, groups=_axis_groups(shape, axes, rank))


def _axis_groups(shape: Tuple[int, ...], axes: Tuple[str, ...], rank: int
                 ) -> Dict[Tuple[str, ...], object]:
    """The process groups over every proper subset of the axes that
    spans more than one rank and less than the mesh: one group for each
    coordinate of the other axes, its ranks in row-major order of the
    subset's coordinates.  ``dist.new_group`` is collective: every rank
    creates every group, in the same order, and keeps the ones it is
    in."""
    coords = list(itertools.product(*(range(n) for n in shape)))
    groups = {}
    for r in range(1, len(axes)):
        for sub in itertools.combinations(range(len(axes)), r):
            n = math.prod(shape[i] for i in sub)
            if n in (1, len(coords)):
                continue
            rest = [i for i in range(len(axes)) if i not in sub]
            for fixed in itertools.product(*(range(shape[i]) for i in rest)):
                ranks = [j for j, c in enumerate(coords)
                         if all(c[i] == f for i, f in zip(rest, fixed))]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[tuple(axes[i] for i in sub)] = g
    return groups


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """A world of ``size`` ranks on torch's ``"fake"`` backend, this
    process its rank ``rank``, destroyed on exit: its collectives return
    at once and move nothing, so one rank of a large mesh can trace its
    step on meta tensors.  Raises when a process group is already
    initialised."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: the "
                           "fake world would replace it")
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=rank, world_size=size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False, device="cuda"
                         ) -> ShardMesh:
    """The reference's production mesh shape: 16×16 (256 ranks)
    single-pod, or 2×16×16 (512) multi-pod, over the initialised world
    (``fake_world(256)`` for a dry run on ``device="meta"``).  Raises
    when the world is another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device, "the production world")


def make_train_mesh(data: int, model: int, *, device="cuda") -> ShardMesh:
    """A ("data", "model") mesh of ``data × model`` ranks over the
    initialised world (``train(mesh=)``'s layout: FSDP and batch rows
    over "data", tensor parallelism over "model"); ``data × model`` must
    be the world size, or 1."""
    return _make_mesh((data, model), ("data", "model"), device, "the world")


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes over which the batch (and FSDP weight dims) shard."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def make_local_mesh(*, device="cuda") -> ShardMesh:
    """One-rank ("data", "model") mesh of shape (1, 1): needs no process
    group."""
    return ShardMesh(("data", "model"), {"data": 1, "model": 1}, None, 0,
                     resolve_device(device))


def activate_mesh(mesh):
    """A context manager that installs nothing: the port keeps no global
    mesh state (the wrappers take the mesh as an argument)."""
    return contextlib.nullcontext(mesh)


def make_shard_mesh(n_shards: int, axis: str = "shard", *, device="cuda"
                    ) -> ShardMesh:
    """1-D mesh over the ranks of the initialised world — the unit the
    scale-out wrappers run on.  ``n_shards`` must be the world size
    (or 1: a one-rank mesh on each rank, with no collective)."""
    return _make_mesh((n_shards,), (axis,), device, "the world")


# ---------------------------------------------------------------------------
# the collective transport
# ---------------------------------------------------------------------------

def _backend(mesh: ShardMesh, group) -> str:
    """The group's backend: "nccl" and "fake" run on the device, "gloo"
    on the host."""
    backend = dist.get_backend(group)
    if backend not in ("nccl", "gloo", "fake"):
        raise ValueError(f"no collectives for the {backend!r} backend "
                         f"(nccl, gloo or fake)")
    return backend


def _count_collective(mesh: ShardMesh, kind: str, result: int,
                      factor: float = 1.0) -> None:
    """Add a collective's logical bytes to ``mesh.collective_bytes``:
    its result's bytes (an all-gather's whole gathered tensor, a
    reduce-scatter's block), twice for an all-reduce (a ring moves each
    byte out and back), as the reference's dry run counts them."""
    mesh.collective_bytes[kind] = (mesh.collective_bytes.get(kind, 0.0)
                                   + result * factor)


def _all_gather(x: torch.Tensor, mesh: ShardMesh, dim: int,
                axis=None) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``: the
    shards of every rank on the axis (a name or a tuple of names),
    concatenated along ``dim`` in rank order.  NCCL (one GPU per rank)
    gathers in place on the device; gloo takes host tensors, so a CUDA
    tensor is staged through the host explicitly and the bytes are
    counted on the mesh."""
    n = mesh.axis_size(_axes(mesh, axis))
    if n == 1:
        return x
    group = mesh.group_of(_axes(mesh, axis))
    src = x.movedim(dim, 0).contiguous()
    _count_collective(mesh, "all-gather", n * src.nbytes)
    if _backend(mesh, group) != "gloo":
        out = src.new_empty((n * src.shape[0],) + src.shape[1:])
        dist.all_gather_into_tensor(out, src, group=group)
    else:
        host = src.cpu()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        out = torch.cat(parts).to(src.device)
        if src.device.type != "cpu":
            mesh.host_staged_bytes += host.nbytes * (1 + n)
    return out.movedim(0, dim).contiguous()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _all_reduce(x: torch.Tensor, mesh: ShardMesh, axis=None,
                op: str = "sum") -> torch.Tensor:
    """``jax.lax.psum`` / ``pmax`` / ``pmin`` over the axis (a name or a
    tuple): a new tensor holding the reduction, the same on every rank of
    the axis (``x`` itself on a one-rank axis).  gloo stages a CUDA tensor
    through the host and counts the bytes, as ``_all_gather``."""
    group = mesh.group_of(_axes(mesh, axis))
    if group is None:
        return x
    _count_collective(mesh, "all-reduce", x.nbytes, 2.0)
    if _backend(mesh, group) != "gloo":
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=_OPS[op], group=group)
        return out
    host = x.detach().to("cpu", copy=True).contiguous()
    dist.all_reduce(host, op=_OPS[op], group=group)
    if x.device.type != "cpu":
        mesh.host_staged_bytes += 2 * host.nbytes
    return host.to(x.device)


def _reduce_scatter(x: torch.Tensor, mesh: ShardMesh, dim: int,
                    axis=None) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim,
    tiled=True)``: the sum over the axis's ranks of ``x``, of which
    each rank keeps its block along ``dim`` (``x`` itself on a one-rank
    axis).  gloo stages through the host and counts the bytes."""
    n = mesh.axis_size(_axes(mesh, axis))
    if n == 1:
        return x
    group = mesh.group_of(_axes(mesh, axis))
    src = x.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce-scatter of {src.shape[0]} rows over {n} "
                         f"ranks")
    _count_collective(mesh, "reduce-scatter", src.nbytes // n)
    if _backend(mesh, group) != "gloo":
        out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
        dist.reduce_scatter_tensor(out, src, group=group)
    else:
        host = src.cpu()
        part = host.new_empty((src.shape[0] // n,) + src.shape[1:])
        dist.reduce_scatter_tensor(part, host, group=group)
        out = part.to(src.device)
        if src.device.type != "cpu":
            mesh.host_staged_bytes += host.nbytes + part.nbytes
    return out.movedim(0, dim).contiguous()


def _shard(x: torch.Tensor, mesh: ShardMesh, ax: str, dim: int, *,
           copy: bool = False) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``, contiguous (the kernel
    takes contiguous tensors): always a copy with ``copy=True``, else
    only where the block is not contiguous already (``x`` itself on a
    one-rank axis)."""
    size = x.shape[dim] // mesh.shape[ax]
    part = x.narrow(dim, mesh.coord(ax) * size, size)
    return part.clone(memory_format=torch.contiguous_format) if copy \
        else part.contiguous()


# ---------------------------------------------------------------------------
# sequence-sharded selection
# ---------------------------------------------------------------------------

def _selection_plan_local(q, k, q_pos, *, k_sel: int, q_block: int,
                          k_block: int, sm_scale, causal: bool):
    """One shard's selection + plan: row-local thresholds/occupancy
    (bitwise the global rows) and the full-width compact schedule.
    ``pad_to`` stays ``None`` (P = nkb) so the sharded and single-device
    tile buffers have the same padded layout.  The selection runs one
    q-block at a time on a contiguous copy, so its score product has
    one call shape whatever the shard's length."""
    thr, bm = [], []
    for j in range(q.shape[1] // q_block):
        rows = slice(j * q_block, (j + 1) * q_block)
        t, m = select_thresholds_chunked(
            q[:, rows].contiguous(), k, k_sel, q_pos=q_pos[rows],
            causal=causal, sm_scale=sm_scale, q_block=q_block,
            k_block=k_block)
        thr.append(t)
        bm.append(m)
    thr, bm = torch.cat(thr, dim=1), torch.cat(bm, dim=1)
    kv_indices, kv_counts = compact_kv_plan(bm)
    return thr, bm, kv_indices, kv_counts


def _gather_plan_tiles(x, kv_indices, *, k_block: int):
    """Fetch only the planned tiles: x (BH, Sk, D) + indices
    (BH, nqb, P) → compact (BH, nqb, P·k_block, D) buffers plus the
    gathered token positions (BH, nqb, P·k_block) int32."""
    bh, sk, d = x.shape
    _, nqb, p = kv_indices.shape
    xt = x.reshape(bh, sk // k_block, k_block, d)
    bi = torch.arange(bh, device=x.device)[:, None, None]
    tiles = xt[bi, kv_indices.long()]                     # (BH,nqb,P,kb,D)
    tok = (kv_indices[..., None] * k_block
           + torch.arange(k_block, dtype=torch.int32, device=x.device))
    return (tiles.reshape(bh, nqb, p * k_block, d),
            tok.reshape(bh, nqb, p * k_block))


@torch.no_grad()
def planned_tile_attention(q, k_tiles, v_tiles, tok, thr, kv_counts, *,
                           q_block: int, k_block: int, q_pos,
                           sm_scale=None) -> torch.Tensor:
    """Threshold-mode attention over the compact planned-tile buffers —
    the one epilogue BOTH the sharded path and the single-device
    reference run, so identical plans give bitwise-identical outputs.
    Plain fp32 PyTorch, as the reference computes it outside any Pallas
    kernel.

    q: (BH, Sq, D); k_tiles/v_tiles: (BH, nqb, P·kb, D); tok:
    (BH, nqb, P·kb) gathered token positions; thr: (BH, Sq, 1);
    kv_counts: (BH, nqb); q_pos: (Sq,) global query positions.

    A token participates iff its slot is live (padding slots repeat
    real tiles — without the count mask they would double-count), it is
    causally admissible, and it passes the bisect-consistent selection
    predicate against its row's threshold.  All reductions are
    row-local, and each q-block runs on contiguous copies, so a block's
    products have the same call shape in a shard and on one device."""
    bh, s, d = q.shape
    nqb = s // q_block
    t = k_tiles.shape[2]
    scale = float(sm_scale if sm_scale is not None else 1.0 / np.sqrt(d))
    slot = torch.arange(t, device=q.device) // k_block          # (P·kb,)
    live = slot[None, None, :] < kv_counts[..., None]           # (BH,nqb,P·kb)
    posr = q_pos.to(torch.int32).reshape(nqb, q_block)
    out = torch.empty((bh, nqb, q_block, d), dtype=torch.float32,
                      device=q.device)
    for j in range(nqb):
        rows = slice(j * q_block, (j + 1) * q_block)
        sc = torch.einsum("bqd,btd->bqt", q[:, rows].float().contiguous(),
                          k_tiles[:, j].float().contiguous()) * scale
        adm = live[:, j, None, :] & (tok[:, j, None, :]
                                     <= posr[j][None, :, None])
        sel = bisect_select(sc, thr[:, rows]) & adm
        sc = torch.where(sel, sc, NEG_INF)
        m = sc.amax(dim=-1, keepdim=True)
        w = torch.where(sel, torch.exp(sc - m), 0.0)
        o = torch.einsum("bqt,btd->bqd", w,
                         v_tiles[:, j].float().contiguous())
        out[:, j] = o / torch.clamp(w.sum(-1, keepdim=True), min=1e-30)
    return out.reshape(bh, s, d)


def sequence_local_attention(q, k, v, *, k_sel: int, q_block: int = 128,
                             k_block: int = 128, causal: bool = True,
                             sm_scale=None):
    """Single-device reference for ``sequence_sharded_attention``: the
    same selection → plan → tile-gather → epilogue pipeline with no
    mesh.  Returns (out, stats)."""
    s = q.shape[1]
    q_pos = torch.arange(s, dtype=torch.int32, device=q.device)
    thr, bm, idx, cnt = _selection_plan_local(
        q, k, q_pos, k_sel=k_sel, q_block=q_block, k_block=k_block,
        sm_scale=sm_scale, causal=causal)
    k_tiles, tok = _gather_plan_tiles(k, idx, k_block=k_block)
    v_tiles, _ = _gather_plan_tiles(v, idx, k_block=k_block)
    out = planned_tile_attention(q, k_tiles, v_tiles, tok, thr, cnt,
                                 q_block=q_block, k_block=k_block,
                                 q_pos=q_pos, sm_scale=sm_scale)
    return out, {"thresholds": thr, "block_map": bm, "kv_counts": cnt,
                 "fetched_tiles": cnt.sum()}


def sequence_sharded_attention(mesh: ShardMesh, q, k, v, *, k_sel: int,
                               q_block: int = 128, k_block: int = 128,
                               causal: bool = True, sm_scale=None,
                               axis: Optional[str] = None):
    """Sequence-parallel selective attention on ``mesh`` (SPMD: every
    rank passes the same global q, k, v): q shards along Sq, K/V along
    Sk; each shard all-gathers K for its selection pass (row-local ⇒
    bitwise the global rows), builds its own compact plan, all-gathers
    V, keeps only the planned K/V tiles in compact buffers, and runs the
    shared epilogue.  Output is bitwise equal to
    ``sequence_local_attention`` on one device.

    q: (BH, Sq, D); k/v: (BH, Sk, D).  Sq must tile by
    ``n_shards·q_block`` and Sk by ``n_shards·k_block``.  Returns
    ``(out, stats)``, each gathered along the shard axis, with
    ``stats["fetched_tiles_per_shard"]`` (n_shards,) the
    plan-proportional per-shard fetch.
    """
    ax = axis or mesh.axis_names[0]
    n = mesh.shape[ax]
    s = q.shape[1]
    sk = k.shape[1]
    assert s % (n * q_block) == 0, (s, n, q_block)
    assert sk % (n * k_block) == 0, (sk, n, k_block)
    q_l = _shard(q, mesh, ax, 1)
    pos_l = _shard(torch.arange(s, dtype=torch.int32, device=q.device),
                   mesh, ax, 0)
    # score-pass stream: selection is exact over ALL keys, so each shard
    # streams the full K once (the single-device pass's score traffic,
    # split across n query shards)
    k_full = _all_gather(_shard(k, mesh, ax, 1), mesh, 1, ax)
    thr, bm, idx, cnt = _selection_plan_local(
        q_l, k_full, pos_l, k_sel=k_sel, q_block=q_block, k_block=k_block,
        sm_scale=sm_scale, causal=causal)
    # halo exchange: the all-gather is the simulated interconnect; the
    # compact buffers (and the accounting) keep only the planned tiles
    v_full = _all_gather(_shard(v, mesh, ax, 1), mesh, 1, ax)
    k_tiles, tok = _gather_plan_tiles(k_full, idx, k_block=k_block)
    v_tiles, _ = _gather_plan_tiles(v_full, idx, k_block=k_block)
    out = planned_tile_attention(q_l, k_tiles, v_tiles, tok, thr, cnt,
                                 q_block=q_block, k_block=k_block,
                                 q_pos=pos_l, sm_scale=sm_scale)
    fetched = cnt.sum().reshape(1)
    return _all_gather(out, mesh, 1, ax), {
        "thresholds": _all_gather(thr, mesh, 1, ax),
        "block_map": _all_gather(bm, mesh, 1, ax),
        "kv_counts": _all_gather(cnt, mesh, 1, ax),
        "fetched_tiles_per_shard": _all_gather(fetched, mesh, 0, ax)}


# ---------------------------------------------------------------------------
# tensor-parallel decode
# ---------------------------------------------------------------------------

# every plan leaf keyed to where its KV-head axis sits (None = no KV
# axis → replicated).  ``live_blk`` (B, nkb) and the (B,) QoS/trigger
# vectors are slot state shared by all heads.
_PLAN_KV_AXIS: Dict[str, Optional[int]] = {
    "k_min": 1, "k_max": 1, "k_scale": 1, "k_zero": 1,
    "kv_indices": 1, "kv_counts": 1, "imp": 1,
    "live_blk": None, "step": None, "churn": None, "replans": None,
    "active": None, "budget": None, "interval": None, "quant": None,
    "sketch": None,
}


def plan_pspecs(plan: Dict, axis: str) -> Dict[str, Tuple]:
    """Partition spec per decode-plan leaf for KV-head tensor
    parallelism, as a tuple with one entry per dim (``PartitionSpec``'s
    entries): summary bounds, plan rows and importance shard on their KV
    axis (dim 1); per-slot vectors replicate."""
    specs = {}
    for name, val in plan.items():
        spec = [None] * val.dim()
        kv_dim = _PLAN_KV_AXIS[name]
        if kv_dim is not None:
            spec[kv_dim] = axis
        specs[name] = tuple(spec)
    return specs


def tensor_parallel_decode_step(mesh: ShardMesh, qg, k, v, k_new, pos,
                                plan, *, topk_k: int, k_block: int,
                                replan_interval: int = 1,
                                page_table=None,
                                replan_mode: str = "exact",
                                sketch_factor: int = 4,
                                axis: Optional[str] = None):
    """One SATA decode step (summary absorb → plan update → decode
    kernel) with the plan state, KV cache and kernel sharded over KV
    heads (SPMD: every rank passes the same global arguments).
    Per-(slot, KV-head) independence means no collective but the final
    gather: each rank maintains its heads' summaries, re-plans its
    heads' rows and runs ``kernels.ops.sata_decode_attention`` once on
    its KV / n heads — the hand-written kernel on CUDA tensors, its
    plain version on the CPU.  Output and plan are bitwise the
    single-device step (``replan_interval=1`` fp32 = exact top-k).

    qg: (B, KV, G, D) grouped queries; k/v: (B, S, KV, D) contiguous
    cache or the (n_pages, page, KV, D) pool with ``page_table``
    (B, max_pages) given; k_new: (B, 1, KV, D); pos: (B,).  KV must
    tile by the mesh axis size.  The churn-adaptive trigger
    (``replan="auto"``) is per-slot-mean over *local* heads and would
    diverge across shards — integer intervals only.

    Returns ``(out (B, KV, G, D), plan')``: ``plan'`` is a new global
    plan (pass it straight back next step); ``plan`` is not modified.
    """
    ax = axis or mesh.axis_names[0]
    n = mesh.shape[ax]
    kv = qg.shape[1]
    assert kv % n == 0, (kv, n)
    kv_dims = {name: spec.index(ax) if ax in spec else None
               for name, spec in plan_pspecs(plan, ax).items()}
    # the rank's heads: qg dim 1, the cache and k_new dim 2 (both
    # layouts), each plan leaf on its KV dim.  With n > 1 each rank
    # copies its KV / n heads of the cache every step (the arguments are
    # global); the plan leaves are always copies, since the step updates
    # them in place and the caller's plan stays as it was
    qg_l = _shard(qg, mesh, ax, 1)
    k_l, v_l, kn_l = (_shard(t, mesh, ax, 2) for t in (k, v, k_new))
    plan_l = {name: val.clone() if kv_dims[name] is None
              else _shard(val, mesh, ax, kv_dims[name], copy=True)
              for name, val in plan.items()}
    plan_l = update_block_summaries(plan_l, kn_l, pos, k_block=k_block)
    plan_l, thr = decode_plan_update(
        plan_l, qg_l, k_l, pos, topk_k=topk_k, k_block=k_block,
        replan_interval=replan_interval, page_table=page_table,
        replan_mode=replan_mode, sketch_factor=sketch_factor)
    out = sata_decode_attention(qg_l, k_l, v_l, plan_l["kv_indices"],
                                plan_l["kv_counts"], thr, pos,
                                k_block=k_block, page_table=page_table)
    return _all_gather(out, mesh, 1, ax), {
        name: val if kv_dims[name] is None
        else _all_gather(val, mesh, kv_dims[name], ax)
        for name, val in plan_l.items()}
