"""Dry run: trace one rank of the production mesh through every (arch ×
shape) cell on meta tensors — port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell against ``ShapeDtypeStruct``
inputs on a 16×16 (2×16×16 multi-pod) device mesh and reads XLA's
analyses.  The port's counterparts: meta tensors (``launch.inputs``)
for the abstract arrays, and a world of torch's ``"fake"``
process-group backend (``launch.mesh.fake_world``) of 256 (512) ranks
for the mesh.  This process is rank 0: it builds its shard of the train
state (``init_train_state(mesh=)``) and runs the port's own step on it
(``make_train_step(mesh=)``, ``make_prefill_step(mesh=)``,
``make_serve_step(mesh=)`` on its blocks of the serving cache), every
collective going through the fake group, every kernel through its
meta stand-in (``kernels.ops``), under a ``WorkCounter``.  What it
counts is what the port would run on 256 H100s, not GSPMD's plan of the
reference's step.  A train or prefill cell runs, as the reference's dry
run does, under the ``seq_shard`` activation specs and
``set_context_parallel(cp)`` (``cp`` on by default): rank 0 computes
its layers on its contiguous 1/16 of the sequence, the SATA kernel on
its query rows against every key (``ShardLayout(cp=True)``).  A decode
cell keeps ``cp`` off and runs the reference's context-parallel decode
instead (``CACHE_SEQ_SHARD``): rank 0 holds its 1/16 of every slot's
keys, plans and attends over them (the SATA decode kernel's partial
mode on its blocks), and the ranks' partials combine.  Nothing is
allocated and nothing runs on a device: the whole run is on the CPU, by
design.

The cells run the port's main route (``main_path_cfg``): chunked
selection into the compacted-grid kernel, 128-blocks, as the card
trains.  The decode and ``long_500k`` cells take the same config: its
``topk_impl="bisect"`` turns ``sata.decode.mode="auto"`` on, and on the
contiguous cache with ``replan=1`` the plan takes its exact branch,
with no host sync.  A decode cell first picks the weights' specs
(``decode_param_mode``, the reference's rule): "infer_tp" (weights whole
over the data axes) where the tensor-parallel weights and the rank's
cache blocks (``ShardLayout.cache_specs``: the reference's sequence
split) fit ``DECODE_HBM_BUDGET``, "train" (FSDP) where they do not.

Each cell writes ``build/dryrun/<cell>.json`` (never ``results/``,
which holds the reference's files) with the reference's schema, each
field read in the port as follows:

* ``lower_s``: seconds to start the fake world and build the rank's
  state, batch and step; ``compile_s``: seconds of the traced step;
* ``memory.argument_size_in_bytes``: the rank's blocks of the
  parameters, the fp32 moments and step (train), its blocks of the
  serving cache (decode), and its rows of the batch or tokens;
* ``memory.output_size_in_bytes``: what the step returns that is not
  an argument (the train step updates its state in place, so its
  metrics; the prefill step its global last-position logits; the
  decode step, which updates the cache in place, its global (B, 1, V)
  logits);
* ``memory.temp_size_in_bytes``: the peak of live bytes the step
  allocated above its arguments (``WorkCounter``: every storage an op
  returned fresh, until it is freed);
* ``cost.flops``: the matrix products' FLOPs (torch's
  ``flop_counter`` registry) plus each kernel call's counted work;
  ``cost["bytes accessed"]``: the inputs plus outputs of every op that
  moves data (views and allocations move none) plus each kernel call's
  counted bytes;
* ``collectives.per_kind`` / ``total_bytes``: the mesh's logical bytes
  of each kind (``ShardMesh.collective_bytes``: the result's bytes, an
  all-reduce twice);
* ``kernels``: each kernel's calls, FLOPs and bytes, ``cost_by_op``
  the eight ops that moved the most bytes (port only), and ``cp``,
  whether the step ran context-parallel (``step.layout.seq``), with
  ``notes`` saying which rows rank 0 holds;
* decode cells add ``param_mode`` and ``cache_bytes_rank`` (the rank's
  cache blocks; the reference's rule divides the whole cache by the
  256 devices).

``generated_code_size_in_bytes`` and ``hlo_bytes`` have no counterpart
and are left out.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import sys
import time
import traceback
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.archs import ARCHS, SHAPES, all_cells, cell_enabled
from repro_torch.distributed import ctx as dctx
from repro_torch.distributed.sharding import block
from repro_torch.kernels import ops
from repro_torch.launch.inputs import batch_specs_for, decode_specs_for
from repro_torch.launch.mesh import (data_axes, fake_world,
                                     make_production_mesh, make_train_mesh)
from repro_torch.models.config import SataKernelConfig
from repro_torch.models.model import Model
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.step import (init_train_state, make_prefill_step,
                                    make_serve_step, make_train_step)

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

# a decode cell's budget for the tensor-parallel weights and the rank's
# cache: the reference's 15e9 bytes of a 16 GiB chip (87.3%) applied to
# the H100's 80 GiB
DECODE_HBM_BUDGET = 75e9
CP_NOTE = ("context-parallel: rank 0 holds the first 1/m of the sequence, "
           "the causally lightest query rows; the counts come from static "
           "shapes (the kernel's counted work is its planned tiles' "
           "bound, the same for every rank), so they do not depend on "
           "which rows a rank holds")

# allocations write nothing; the c10d and profiler namespaces are the
# collectives (counted by the mesh) and the profiler's own records
_NO_DATA = {torch.ops.aten.empty.memory_format,
            torch.ops.aten.empty_strided.default,
            torch.ops.aten.empty_like.default,
            torch.ops.aten.new_empty.default,
            torch.ops.aten.new_empty_strided.default,
            torch.ops.aten._unsafe_view.default,
            torch.ops.aten.lift_fresh.default}
_SKIP_NAMESPACES = ("c10d", "_c10d_functional", "profiler")
_ROW_WRITES = {torch.ops.aten.index_put_.default}


def _row_write_bytes(args, kwargs) -> int:
    """``index_put_(dst, indices, values, accumulate)`` (the decode
    step's K/V row, the plan's rows): its indices and values read and
    the indexed elements of ``dst`` written (the values broadcast to
    them; read too with ``accumulate``), never the whole destination.
    A bool mask selects as many elements as the data says, so there the
    values' own count stands in."""
    dst, idx, vals = args[:3]
    acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
    taken = [i for i in idx if i is not None]
    if any(i.dtype == torch.bool for i in taken):
        n = vals.numel()
    else:
        rest = [size for d, size in enumerate(dst.shape)
                if d >= len(idx) or idx[d] is None]
        n = math.prod(torch.broadcast_shapes(*(i.shape for i in taken))) \
            * math.prod(rest)
    return sum(t.nbytes for t in taken) + vals.nbytes + \
        n * dst.element_size() * (2 if acc else 1)


def _tensors(tree, out=None):
    """The tensors in nested tuples, lists and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _meta_key(tree):
    """A hashable key of an op's arguments that determines a meta
    kernel's result: each tensor's shape, strides, offset and dtype, and
    every other argument itself."""
    if isinstance(tree, torch.Tensor):
        return (torch.Tensor, tuple(tree.shape), tree.stride(),
                tree.storage_offset(), tree.dtype)
    if isinstance(tree, (tuple, list)):
        return tuple(_meta_key(x) for x in tree)
    if isinstance(tree, dict):
        return _meta_key(tuple(tree.items()))
    try:
        hash(tree)
    except TypeError:
        return repr(tree)
    return tree


class WorkCounter(TorchDispatchMode):
    """Counts a region's work op by op, the same on every device:

    * ``flops``: the FLOPs of every op in torch's ``flop_counter``
      registry (the matrix products), plus each kernel call's;
    * ``bytes``: the input and output bytes of every op that moves data
      (views, allocations and collectives excluded; an in-place
      ``index_put_`` its indices and values and the elements it writes,
      ``_row_write_bytes``),
      plus each kernel call's;
    * ``kernels``: per kernel, its calls, FLOPs and bytes, which
      ``kernels.ops`` adds through ``kernel()`` while the counter is
      installed; inside a kernel call the op count is paused, so
      neither a plain version's nor a CUDA wrapper's own ops count;
    * ``by_op``: per counted op, its calls, FLOPs and bytes;
    * ``peak_bytes``: the peak of live bytes of the storages ops
      returned fresh inside the region (what the region allocated above
      what existed before it), kept with a weak reference on each.

    Use as a context manager around the region."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.by_op: Dict[str, list] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._paused = 0
        self._prev = None
        self._fresh: Dict[object, bool] = {}
        self._memo: Dict[object, Tuple] = {}

    def __enter__(self):
        self._prev, ops._WORK = ops._WORK, self
        return super().__enter__()

    def __exit__(self, *exc):
        ops._WORK = self._prev
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def kernel(self, name: str, flops: int, nbytes: int):
        """Count one call of kernel ``name`` and pause the op count
        inside it."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)
        self.flops += int(flops)
        self.bytes += int(nbytes)
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def _returns_fresh(self, func) -> bool:
        """Whether ``func``'s results are new storage (no result aliases
        an input: not a view, not in place, no ``out=``)."""
        fresh = self._fresh.get(func)
        if fresh is None:
            fresh = self._fresh[func] = all(
                r.alias_info is None for r in func._schema.returns)
        return fresh

    def _free(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            nbytes = st.nbytes()
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, nbytes)

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``.  On meta tensors a fresh result
        depends on the arguments' shapes, strides and dtypes alone, so
        it is made again from the first call's (``empty_strided``): the
        same result, without running torch's meta kernel (many are
        Python, ~0.3 ms an elementwise op) every time."""
        if func.namespace in _SKIP_NAMESPACES or \
                not self._returns_fresh(func):
            return func(*args, **kwargs)
        ts = _tensors((args, kwargs))
        if not ts or any(t.device.type != "meta" for t in ts):
            return func(*args, **kwargs)
        key = (func, _meta_key((args, kwargs)))
        spec = self._memo.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            if not (isinstance(out, torch.Tensor) or (
                    isinstance(out, (tuple, list)) and all(
                        isinstance(t, torch.Tensor) for t in out))) or \
                    any(t.device.type != "meta" for t in _tensors(out)):
                return out
            # the first call's result is made again too, so that every
            # call's storage holds just its tensor (a Python meta kernel
            # may return a view of a larger buffer)
            spec = self._memo[key] = (
                isinstance(out, torch.Tensor),
                [(tuple(t.shape), t.stride(), t.dtype)
                 for t in _tensors(out)])
        single, shapes = spec
        made = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                for sh, st, dt in shapes]
        return made[0] if single else tuple(made)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        if func.namespace in _SKIP_NAMESPACES:
            return out
        if self._returns_fresh(func):
            self._track(out)
        if self._paused or func.is_view or func in _NO_DATA:
            return out
        if func in _ROW_WRITES:
            nbytes = _row_write_bytes(args, kwargs)
        else:
            nbytes = sum(t.nbytes for t in _tensors((args, kwargs))) + \
                sum(t.nbytes for t in _tensors(out))
        count = flop_registry.get(func._overloadpacket)
        flops = 0 if count is None else int(
            count(*args, **kwargs, out_val=out))
        self.ops += 1
        self.bytes += nbytes
        self.flops += flops
        row = self.by_op.setdefault(str(func), [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        return out

    def summary(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes, "ops": self.ops,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "peak_bytes": self.peak_bytes}

    def top_ops(self, n: int = 8) -> Dict[str, Dict[str, int]]:
        """The ``n`` ops that moved the most bytes."""
        rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][2])[:n]
        return {k: {"calls": c, "flops": f, "bytes": b}
                for k, (c, f, b) in rows}


def main_path_cfg(cfg):
    """The port's training and prefill route for ``cfg``: chunked
    selection into the compacted-grid kernel at 128-blocks
    (``sata.kernel``), as the card trains; a family without top-k
    attention is unchanged."""
    if cfg.attention_variant != "topk":
        return cfg
    return dataclasses.replace(
        cfg, topk_impl="bisect", sata=dataclasses.replace(
            cfg.sata, kernel=SataKernelConfig(use=True, block=128)))


def _nbytes(tensors) -> int:
    return sum(t.nbytes for t in tensors)


def _not_args(out, args) -> int:
    """Bytes of the tensors in ``out`` whose storage is not an
    argument's."""
    held = {id(t.untyped_storage()) for t in args}
    return sum(t.nbytes for t in _tensors(out)
               if id(t.untyped_storage()) not in held)


def tp_weight_bytes(cfg, mesh) -> float:
    """The reference's per-device weight bytes under "infer_tp": bf16
    dense weights split over "model", the experts over every device."""
    n_dev = math.prod(mesh.shape.values())
    expert = (cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
              if cfg.moe else 0)
    dense = cfg.param_count() - expert
    return dense * 2 / mesh.shape["model"] + expert * 2 / n_dev


def decode_param_mode(cfg, mesh, cache_bytes_rank: float,
                      budget: float = DECODE_HBM_BUDGET) -> str:
    """The weights' mode of a decode cell, the reference's rule
    (``repro.launch.dryrun``'s decode branch): "infer_tp" where the
    tensor-parallel weights (``tp_weight_bytes``) and the rank's cache
    bytes fit ``budget`` (FSDP's weight all-gathers would dominate a
    decode step), else "train"."""
    return "infer_tp" if tp_weight_bytes(cfg, mesh) + cache_bytes_rank \
        <= budget else "train"


def decode_cache(cfg, shape, layout) -> Tuple[Dict, int]:
    """A decode cell's serving cache as the rank's blocks under
    ``layout.cache_specs`` (meta), and their bytes.  The cache specs
    read only the regions, which both weight modes share, so any
    layout of ``cfg`` on the mesh will do."""
    cache, _, _ = decode_specs_for(cfg, shape)
    local = layout.block_cache(cache)
    return local, _nbytes(_tensors(local))


def _cell_mesh(multi_pod: bool, mesh_shape: Optional[Tuple[int, int]]):
    if mesh_shape is not None:
        return make_train_mesh(*mesh_shape, device="meta")
    return make_production_mesh(multi_pod=multi_pod, device="meta")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save: bool = True, verbose: bool = True, cfg=None,
             tag_suffix: str = "", cp: bool = True,
             mesh_shape: Optional[Tuple[int, int]] = None,
             param_mode: Optional[str] = None) -> Dict:
    """Trace rank 0 of the production mesh through one cell's step on
    meta tensors and return (and with ``save``, write) its record.
    ``cfg`` replaces ``main_path_cfg(ARCHS[arch])``; ``mesh_shape``
    (data, model) replaces the production mesh by a ("data", "model")
    mesh of that many fake ranks (the tests' small worlds);
    ``param_mode`` replaces a decode cell's ``decode_param_mode`` (the
    roofline's shallow probes take the full-depth cell's).  A train or
    prefill cell runs under the ``seq_shard`` activation specs and
    ``set_context_parallel(cp)``, as the reference's dry run; a decode
    cell never under that switch (its context parallelism is the
    serving cache's key split, ``CACHE_SEQ_SHARD``).  Starts the fake world and destroys it
    on every exit; raises if a process group is already initialised."""
    cfg = main_path_cfg(ARCHS[arch]) if cfg is None else cfg
    shape = SHAPES[shape_name]
    tag = (f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
           f"{tag_suffix}")
    dims = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    seq_shard = shape.kind in ("train", "prefill")
    t0 = time.time()
    with fake_world(math.prod(dims)):
        mesh = _cell_mesh(multi_pod, mesh_shape)
        dctx.set_activation_shardings(
            dctx.make_activation_shardings(mesh, cfg, seq_shard=seq_shard),
            mesh=mesh)
        dctx.set_context_parallel(cp and seq_shard)
        try:
            result = _trace(cfg, shape, mesh, t0, param_mode)
        finally:
            dctx.set_context_parallel(False)
            dctx.clear()
    ran_cp = result.pop("cp")
    result = {"cell": tag, "arch": arch, "shape": shape_name,
              "multi_pod": multi_pod, "ok": True, "cp": ran_cp,
              **({"notes": CP_NOTE} if ran_cp else {}),
              "mesh": dict(mesh.shape), **result}
    if verbose:
        mem = result["memory"]
        mode = f" {result['param_mode']}" if "param_mode" in result else ""
        print(f"[dryrun] {tag}: OK{mode} lower={result['lower_s']:.0f}s "
              f"compile={result['compile_s']:.0f}s "
              f"args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB/dev "
              f"temp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB/dev "
              f"flops={result['cost']['flops']:.3g} "
              f"coll={result['collectives']['total_bytes']:.3g}B",
              flush=True)
    if save:
        RESULTS.mkdir(parents=True, exist_ok=True)
        (RESULTS / f"{tag}.json").write_text(json.dumps(result, indent=1))
    return result


def _trace(cfg, shape, mesh, t0: float,
           param_mode: Optional[str] = None) -> Dict:
    """Build rank 0's state, batch and step on ``mesh`` and run the step
    once under a ``WorkCounter``."""
    if shape.kind == "decode":
        return _trace_decode(cfg, shape, mesh, t0, param_mode)
    batch = batch_specs_for(cfg, shape)
    if shape.kind == "train":
        dp = math.prod(mesh.shape[a] for a in data_axes(mesh))
        micro = max(1, min(cfg.micro_steps, shape.global_batch // dp))
        state = init_train_state(cfg, OptConfig(), device="meta", mesh=mesh)
        step = make_train_step(cfg, OptConfig(), micro_steps=micro,
                               mesh=mesh)
        args = (state, batch)
        held = [*state["params"].parameters(), state["opt"]["step"],
                *state["opt"]["m"].values(), *state["opt"]["v"].values()]
    else:
        micro = 1
        step = make_prefill_step(cfg, mesh=mesh)
        model = init_train_state(cfg, OptConfig(), device="meta",
                                 mesh=mesh)["params"]
        args = (model, batch)
        held = list(model.parameters())
    layout = step.layout
    rows = next(iter(batch.values())).shape[0]
    nd = math.prod(mesh.shape[a] for a in layout.data)
    local = [block(t, (layout.data,), mesh) if rows % nd == 0 else t
             for t in batch.values()]
    return {"micro_steps": micro, "cp": layout.seq is not None, **_counted(
        step, args, held, local, list(batch.values()), mesh, t0)}


def _trace_decode(cfg, shape, mesh, t0: float,
                  param_mode: Optional[str] = None) -> Dict:
    """A decode cell: the rank's blocks of the serving cache and of the
    tokens, the weights' mode (``decode_param_mode`` of the cache's
    bytes, or ``param_mode``) and the model sharded under it, and one
    ``make_serve_step(mesh=)`` step on the blocks: one layout for the
    cache and the step, a second only where the mode comes out
    "train"."""
    _, tokens, pos = decode_specs_for(cfg, shape)
    step = make_serve_step(cfg, mesh=mesh, mode=param_mode or "infer_tp")
    local_cache, cache_rank = decode_cache(cfg, shape, step.layout)
    mode = param_mode or decode_param_mode(cfg, mesh, cache_rank)
    if mode != step.layout.mode:
        step = make_serve_step(cfg, mesh=mesh, mode=mode)
    model = step.layout.shard_(Model(cfg, device="meta"))
    held = [*model.parameters(), *_tensors(local_cache)]
    nd = math.prod(mesh.shape[a] for a in step.layout.data)
    local = [block(tokens, (step.layout.data,), mesh)
             if tokens.shape[0] % nd == 0 else tokens]
    return {"param_mode": mode, "cp": False, "cache_bytes_rank": cache_rank,
            "tp_weight_bytes": tp_weight_bytes(cfg, mesh),
            "decode_budget_bytes": DECODE_HBM_BUDGET,
            **_counted(step, (model, local_cache, tokens, pos), held, local,
                       [tokens], mesh, t0)}


def _counted(step, args, held, local, inputs, mesh, t0: float) -> Dict:
    """``step(*args)`` once under a ``WorkCounter``: the record's timing,
    memory, cost, kernel and collective fields."""
    t_lower = time.time() - t0
    counter = WorkCounter()
    with counter:
        out = step(*args)
    t_compile = time.time() - t0 - t_lower
    per_kind = dict(mesh.collective_bytes)
    w = counter.summary()
    return {
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory": {
            "argument_size_in_bytes": _nbytes(held) + _nbytes(local),
            "output_size_in_bytes": _not_args(out, held + inputs),
            "temp_size_in_bytes": w["peak_bytes"]},
        "cost": {"flops": float(w["flops"]),
                 "bytes accessed": float(w["bytes"]),
                 "ops": float(w["ops"])},
        "kernels": w["kernels"],
        "cost_by_op": counter.top_ops(),
        "collectives": {"per_kind": per_kind,
                        "total_bytes": float(sum(per_kind.values()))},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells()
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        if not cell_enabled(args.arch, args.shape):
            print(f"[dryrun] {args.arch}×{args.shape}: skipped "
                  f"(long_500k needs sub-quadratic attention)")
            return
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
            if args.skip_done and (RESULTS / f"{tag}.json").exists():
                prev = json.loads((RESULTS / f"{tag}.json").read_text())
                if prev.get("ok"):
                    print(f"[dryrun] {tag}: cached OK", flush=True)
                    continue
            try:
                run_cell(arch, shape, mp)
            except Exception as e:
                failures.append(tag)
                RESULTS.mkdir(parents=True, exist_ok=True)
                (RESULTS / f"{tag}.json").write_text(json.dumps(
                    {"cell": tag, "ok": False, "error": str(e),
                     "traceback": traceback.format_exc()[-4000:]}, indent=1))
                print(f"[dryrun] {tag}: FAIL {e}", flush=True)
    if failures:
        print(f"[dryrun] {len(failures)} failures: {failures}", flush=True)
        sys.exit(1)
    print("[dryrun] every cell OK", flush=True)


if __name__ == "__main__":
    main()
