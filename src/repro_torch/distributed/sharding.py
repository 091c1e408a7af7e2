"""Logical sharding rules and the rank's view of a sharded model — port
of ``repro.distributed.sharding``.

Scheme (single pod: mesh (data=16, model=16); multi-pod adds "pod"),
the reference's:
  * FSDP: the d_model-sized dim of every weight shards over the data
    axes (ZeRO-3-style: weights are all-gathered around their use and
    gradients reduce-scattered);
  * TP: heads / d_ff / vocab shard over "model";
  * MoE: experts over "model" (``expert_shard="expert"``) or d_ff over
    "model" with experts replicated (``"tensor"``);
  * optimizer moments shard exactly like their parameters.

A spec is a tuple with one entry per dim, as a ``PartitionSpec``'s
entries: None, an axis name, or a tuple of names (the data axes of a
multi-pod mesh).  The port's layers are ``ModuleList``s, not stacked
arrays, so ``layers.3.attn.wq`` takes the reference's
``("layers", "attn", "wq")`` spec without its leading (unsharded) stack
dims.  The rules read only ``mesh.axis_names`` and ``mesh.shape``, so a
``ShardMesh`` or any object with those two does.

There is no GSPMD here to place tensors from specs: a rank holds its
block of every parameter (``block``), and ``ShardedParams`` reads a
sharded ``Model`` by key as the layer functions read a ``ParamModule``,
all-gathering each leaf around its use through an autograd function
whose backward reduce-scatters the gradient over the data axes.  Where
the specs shard a module over "model", it keeps its "model" shard and
computes on it (``ShardLayout.tp_for``): the attention and MLP of every
family that has them run tensor-parallel (``TensorParallel``:
column-parallel in-projections, row-parallel out-projections summed by
an all-reduce), so do mamba2 and rwkv6 on the rank's heads (mamba2's
packed in-projection through a ``Packed`` spec), the MoE experts expert-
or d_ff-parallel
(``ExpertParallel``), the embedding, unembed and loss vocab-parallel
(``VocabParallel``).

Under context parallelism (``ShardLayout(cp=True)``, the train and
prefill steps' layout under ``distributed.ctx.set_context_parallel``) a
rank's residual stream holds its contiguous 1/m of the sequence over
"model" (``SeqShard``): every region enters through an all-gather of
the sequence and leaves through a reduce-scatter of its partial sums,
and the attention runs on the rank's query rows against every key.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.launch.mesh import (_PLAN_KV_AXIS, _all_gather,
                                     _all_reduce, _reduce_scatter, data_axes)

Spec = Tuple[Any, ...]

# the module groups whose leaves the reference stacks over layers
_STACKED = ("layers", "cross_layers", "enc_layers")


def _base_spec(path: Tuple[str, ...], ndim_tail: int, cfg, dp,
               dp_orig=None) -> Tuple:
    """Spec for the logical (unstacked) trailing dims of a leaf.
    ``dp`` is None in infer_tp mode (weights not FSDP-sharded);
    ``dp_orig`` keeps the data axes for the MoE expert exception."""
    name = path[-1]
    in_moe = "moe" in path

    # MoE experts keep their train sharding in every mode (E or d_ff over
    # model, d_model over data)
    eff_dp = dp if dp is not None else dp_orig
    if in_moe and name in ("wi", "wg"):          # (E, D, F)
        return ((("model",), (eff_dp,), (None,))
                if cfg.expert_shard == "expert"
                else ((None,), (eff_dp,), ("model",)))
    if in_moe and name == "wo":                  # (E, F, D)
        return ((("model",), (None,), (eff_dp,))
                if cfg.expert_shard == "expert"
                else ((None,), ("model",), (eff_dp,)))
    if in_moe and name == "router":              # (D, E)
        return ((dp,), (None,))

    table = {
        # in-projections (D, X): FSDP on D, TP on X
        "wq": "in", "wk": "in", "wv": "in", "wi": "in", "wg": "in",
        "wr": "in", "ck": "in", "cr": "in", "in_proj": "in",
        "shared_in": "in", "wa": "in_rep",
        # out-projections (X, D): TP on X, FSDP on D
        "wo": "out", "cv": "out", "out_proj": "out", "wb": "out_rep",
    }
    kind = table.get(name)
    if kind == "in":
        return ((dp,), ("model",))
    if kind == "out":
        return (("model",), (dp,))
    if kind == "in_rep":
        return ((dp,), (None,))
    if kind == "out_rep":
        return ((None,), (dp,))
    if name == "embedding":
        return (("model",), (dp,))
    if name == "unembed":
        return ((dp,), ("model",))
    if name == "conv_w":                         # (K, C)
        return ((None,), ("model",))
    if name == "bonus_u" and ndim_tail == 2:     # (H, hd)
        return (("model",), (None,))
    return tuple((None,) for _ in range(ndim_tail))


def _flatten(spec) -> Tuple:
    return tuple(s[0] if isinstance(s, tuple) else s for s in spec)


def _dp(mesh):
    axes = data_axes(mesh)
    return axes if len(axes) > 1 else axes[0]


def entry_axes(entry) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names (() for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _n_shards(mesh, entry) -> int:
    return math.prod(mesh.shape[a] for a in entry_axes(entry))


def _fit(shape, spec, mesh) -> Spec:
    """Drop the shardings that do not divide their dim (tiny shapes)."""
    return tuple(None if ax is None or size % _n_shards(mesh, ax) else ax
                 for size, ax in zip(shape, spec))


def _named_shapes(model_or_named_shapes) -> Dict[str, Tuple[int, ...]]:
    if isinstance(model_or_named_shapes, nn.Module):
        return {n: tuple(p.shape) for n, p in
                model_or_named_shapes.named_parameters()}
    return {n: tuple(getattr(s, "shape", s))
            for n, s in model_or_named_shapes.items()}


def _stack_dims(name: str, cfg) -> int:
    """How many leading stack dims the reference gives this leaf: one
    for a layer group, two for vlm's (n_cross, per_group) self layers."""
    parts = name.split(".")
    if parts[0] not in _STACKED or len(parts) < 2 or not parts[1].isdigit():
        return 0
    return 2 if parts[0] == "layers" and cfg.family == "vlm" else 1


def param_specs(model_or_named_shapes, cfg, mesh, mode: str = "train"
                ) -> Dict[str, Spec]:
    """Spec per parameter name of a ``Model`` (the meta device will do)
    or of a {name: shape} mapping.

    mode="train": FSDP(+TP) — d_model dims shard over the data axes.
    mode="infer_tp": TP only — weights replicated over data, sharded
    over "model" only (MoE experts keep their train sharding).

    The reference resolves a stacked leaf's spec from its stacked rank
    (``tail`` below); the port's leaf has the stack dims stripped, so
    the rank is counted with them and the (None) stack entries are
    dropped at the end."""
    if mode not in ("train", "infer_tp"):
        raise ValueError(f"mode={mode!r}: 'train' or 'infer_tp'")
    dp_orig = _dp(mesh)
    dp = None if mode == "infer_tp" else dp_orig
    specs = {}
    for name, shape in _named_shapes(model_or_named_shapes).items():
        path = tuple(p for p in name.split(".") if not p.isdigit())
        lead_n = _stack_dims(name, cfg)
        ndim = len(shape) + lead_n                   # the reference's rank
        if ndim == 0:
            specs[name] = ()
            continue
        leaf = path[-1]
        moe3 = "moe" in path and leaf in ("wi", "wg", "wo")
        tail = min(3 if moe3 else (2 if ndim >= 2 else 1), ndim)
        base = _flatten(_base_spec(path, tail, cfg, dp,
                                   dp_orig=dp_orig))[:tail]
        if ndim == 1:
            base = (None,)
        spec = (None,) * (ndim - len(base)) + tuple(base)
        if any(s is not None for s in spec[:lead_n]):
            raise ValueError(f"{name}: a stack dim would shard ({spec})")
        specs[name] = _fit(shape, spec[lead_n:], mesh)
    return specs


def batch_specs(batch_shapes: Mapping, mesh) -> Dict[str, Spec]:
    """Inputs: batch dim over the data axes, everything else replicated.
    Batches smaller than the data axes replicate."""
    dp = _dp(mesh)
    specs = {}
    for name, s in batch_shapes.items():
        shape = tuple(getattr(s, "shape", s))
        if not shape:
            specs[name] = ()
            continue
        lead = dp if shape[0] % _n_shards(mesh, dp) == 0 else None
        specs[name] = (lead,) + (None,) * (len(shape) - 1)
    return specs


CACHE_SEQ_SHARD = True     # KV caches shard the sequence dim over "model"
                           # (context-parallel decode); False = the legacy
                           # kv-head / head-dim sharding (``ShardLayout``
                           # reads it when built: False there lays the
                           # cache out by the regions that read it)


def cache_leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    """(path, leaf) for every leaf of a nested cache tree."""
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from cache_leaves(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def _cache_shapes(tree: Mapping):
    """(path, shape) for every leaf: a tensor's or a shape tuple."""
    for path, leaf in cache_leaves(tree):
        yield path, tuple(getattr(leaf, "shape", leaf))


def cache_specs(cache_shapes: Mapping, cfg, mesh) -> Dict[Tuple[str, ...],
                                                          Spec]:
    """Spec per leaf path of a serving cache (``models.decode.init_cache``:
    layer-stacked, (L, ...)).  "kv" / "cross_kv" / "shared_kv"
    (..., B, S, KV, hd): batch over data and the SEQUENCE dim over
    "model" (or kv heads, or head dim, when it does not divide);
    "mamba" (L, B, H, ...) and "rwkv" (L, B, H, ...): batch over data,
    dim 2 over "model"; "x0": batch over data."""
    dp = _dp(mesh)
    m = mesh.shape["model"]
    specs = {}
    for path, shape in _cache_shapes(cache_shapes):
        ndim = len(shape)
        if ndim == 0:
            specs[path] = ()
            continue
        name = path[0]
        spec = [None] * ndim
        if name in ("kv", "cross_kv", "shared_kv"):
            spec[-4] = dp
            if CACHE_SEQ_SHARD and shape[-3] % m == 0:
                spec[-3] = "model"
            elif shape[-2] % m == 0:
                spec[-2] = "model"
            elif shape[-1] % m == 0:
                spec[-1] = "model"
        elif name == "mamba":
            spec[1] = dp
            if shape[2] % m == 0:
                spec[2] = "model"
            elif shape[-1] % m == 0:
                spec[-1] = "model"
        elif name == "rwkv":
            spec[1] = dp
            if ndim >= 3 and shape[2] % m == 0:
                spec[2] = "model"
        elif name == "x0":
            spec[0] = dp
        specs[path] = _fit(shape, spec, mesh)
    return specs


def leaf_specs(names, pspecs: Mapping[str, Spec]) -> Dict[str, Spec]:
    """Spec per leaf of a train state (``checkpoint.manager``'s dotted
    names): ``params.<p>``, ``opt.m.<p>``, ``opt.v.<p>`` and ``err.<p>``
    take parameter ``p``'s spec; the step counter replicates."""
    out = {}
    for name in names:
        for prefix in ("params.", "opt.m.", "opt.v.", "err."):
            if name.startswith(prefix) and name[len(prefix):] in pspecs:
                out[name] = pspecs[name[len(prefix):]]
                break
        else:
            out[name] = ()
    return out


# ---------------------------------------------------------------------------
# a rank's block, and back
# ---------------------------------------------------------------------------

class Packed(tuple):
    """A spec (equal to the plain tuple) of a leaf whose ``dim`` packs
    ``segments`` side by side (mamba2's ``in_proj`` columns [z | x |
    B|C | dt]): a rank's block along ``dim`` is its 1/n of every
    segment, in segment order, rather than a contiguous 1/n of the dim.
    ``block`` permutes the dim to that order before it takes the block,
    ``gather`` permutes back, so the global leaf (and a checkpoint) is
    the reference's."""

    def __new__(cls, spec, dim: int, segments: Tuple[int, ...]):
        out = super().__new__(cls, spec)
        out.dim, out.segments = dim, tuple(segments)
        return out

    def order(self, n: int, device=None) -> torch.Tensor:
        """The dim's indices, rank-major: rank 0's share of each segment,
        then rank 1's, ..."""
        starts = [0]
        for size in self.segments[:-1]:
            starts.append(starts[-1] + size)
        idx = [torch.arange(o + r * (size // n), o + (r + 1) * (size // n))
               for r in range(n) for o, size in zip(starts, self.segments)]
        return torch.cat(idx).to(device)


def block(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view; a copy for
    a ``Packed`` spec)."""
    out = full
    for dim, entry in enumerate(spec):
        n = _n_shards(mesh, entry)
        if n > 1:
            if isinstance(spec, Packed) and dim == spec.dim:
                out = out.index_select(dim, spec.order(n, full.device))
            size = full.shape[dim] // n
            out = out.narrow(dim, mesh.coord(entry_axes(entry)) * size, size)
    return out


@torch.no_grad()
def gather(shard: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The global tensor from every rank's block (collective: every rank
    calls it with its own block)."""
    out = shard
    for dim, entry in enumerate(spec):
        n = _n_shards(mesh, entry)
        if n > 1:
            out = _all_gather(out, mesh, dim, entry_axes(entry))
            if isinstance(spec, Packed) and dim == spec.dim:
                inv = torch.argsort(spec.order(n, out.device))
                out = out.index_select(dim, inv)
    return out


def counted_once(spec: Spec, mesh) -> bool:
    """Whether this rank's block of a leaf is the one that counts in a
    sum over the whole mesh: the leaf is replicated over every axis its
    spec does not shard, and only the ranks at coordinate 0 of those
    axes count it."""
    sharded = {a for e in spec for a in entry_axes(e)}
    return all(mesh.coord(a) == 0 for a in mesh.axis_names
               if a not in sharded and mesh.shape[a] > 1)


# ---------------------------------------------------------------------------
# collectives under autograd
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    """Forward: all-gather along ``dim`` over ``axes``.  Backward: the
    gradient's own block, summed over the axes' ranks (``reduce``: a
    reduce-scatter, for axes whose ranks saw different batch rows) or
    taken as it is (the axes' ranks computed the same gradient).

    The sum runs in fp32 and is cast to the gradient's dtype once, as
    one device's bf16 gradient accumulates in fp32 and rounds once."""

    @staticmethod
    def forward(ctx, x, mesh, dim, axes, reduce):
        ctx.mesh, ctx.dim, ctx.axes, ctx.reduce = mesh, dim, axes, reduce
        return _all_gather(x, mesh, dim, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, dim, axes = ctx.mesh, ctx.dim, ctx.axes
        if ctx.reduce:
            out = _reduce_scatter(g.float(), mesh, dim, axes).to(g.dtype)
        else:
            n = mesh.axis_size(axes)
            size = g.shape[dim] // n
            out = g.narrow(dim, mesh.coord(axes) * size, size).contiguous()
        return out, None, None, None, None


class _ReduceOut(torch.autograd.Function):
    """Forward: the sum over ``axes`` (the row-parallel out-projection's
    partial products); backward: identity."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyIn(torch.autograd.Function):
    """Forward: identity; backward: the sum over ``axes`` (in fp32,
    cast once, as ``_Gather``'s) — the conjugate of
    ``_ReduceOut`` on what enters a tensor-parallel region replicated
    (its input, and its replicated parameters), whose gradient each rank
    holds only its heads' share of."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.float(), ctx.mesh, ctx.axes).to(g.dtype), \
            None, None


class _ScatterSum(torch.autograd.Function):
    """Forward: the sum over ``axes``, of which the rank keeps its block
    along ``dim`` (a reduce-scatter); backward: the all-gather of the
    blocks' gradients (every rank's partial fed every block)."""

    @staticmethod
    def forward(ctx, x, mesh, dim, axes):
        ctx.mesh, ctx.dim, ctx.axes = mesh, dim, axes
        return _reduce_scatter(x, mesh, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.dim, ctx.axes), None, None, None


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """Context parallelism over ``axis``: the residual stream (B, S, D)
    holds the rank's contiguous 1/m of the sequence (dim 1), rank r the
    rows ``r·S/m ..``.  Every rank's gradient of its own rows is then
    the whole gradient of those rows, and its gradient of a weight read
    on them is its rows' share, summed over the axis after the backward
    (``ShardLayout.grad_sum_axes``, or the reduce-scatter of a leaf
    gathered over the axis)."""
    mesh: Any
    axis: str = "model"

    @property
    def n(self) -> int:
        return self.mesh.axis_size((self.axis,))

    def positions(self, s: int, device) -> torch.Tensor:
        """The global positions of the rank's ``s`` rows."""
        lo = self.mesh.coord((self.axis,)) * s
        return torch.arange(lo, lo + s, device=device)

    def take(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The rank's rows of a sequence every rank holds whole (a
        slice: the backward puts the rows' gradient in place, zeros
        elsewhere)."""
        if x.shape[dim] % self.n:
            raise ValueError(
                f"context parallelism: a sequence of {x.shape[dim]} does "
                f"not split over {self.n} ranks")
        size = x.shape[dim] // self.n
        return x.narrow(dim, self.mesh.coord((self.axis,)) * size, size)

    def gather(self, x: torch.Tensor, dim: int = 1,
               shares: bool = True) -> torch.Tensor:
        """The whole sequence from the ranks' rows.  ``shares``: each
        rank's gradient of the whole is its share, reduce-scattered
        back; otherwise every rank's is the same whole gradient, of
        which it keeps its rows."""
        return _Gather.apply(x, self.mesh, dim, (self.axis,), shares)

    def scatter_sum(self, part: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The rank's rows of the ranks' partial sums ``part`` (the
        whole sequence each): a reduce-scatter, whose backward
        all-gathers the rows' gradients."""
        return _ScatterSum.apply(part, self.mesh, dim, (self.axis,))


@dataclasses.dataclass(frozen=True)
class KeySplit:
    """Context-parallel decode over ``axis`` (the reference's
    ``CACHE_SEQ_SHARD``): a serving cache's sequence dim is split over
    the axis, rank r holding keys ``r·S/m ..`` of every slot, and a
    decode step reads it row-parallel over the keys.  The rank scores
    its keys, the row's reductions (the top-k bisection's min, max and
    counts, the softmax's max and sum) run over the axis through
    ``all_reduce``, and the ranks' partial outputs are combined in rank
    order (``sum_ranks``, ``combine``), so every rank holds the same
    bits."""
    mesh: Any
    axis: str = "model"

    @property
    def n(self) -> int:
        return self.mesh.axis_size((self.axis,))

    @property
    def rank(self) -> int:
        return self.mesh.coord((self.axis,))

    def offset(self, s_local: int) -> int:
        """The global position of the rank's first key."""
        return self.rank * s_local

    def local_pos(self, pos: torch.Tensor, s_local: int) -> torch.Tensor:
        """Global positions (B,) as the rank's key indices: below 0 where
        a slot's position lies before the rank's keys, at or past
        ``s_local`` where after them (every key there is valid)."""
        return pos - self.offset(s_local)

    def owned(self, pos: torch.Tensor, s_local: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(whether the rank holds each slot's row ``pos`` — clamped to
        the last row, as the write clamps it — and that row's local
        index, clamped into the rank's keys)."""
        row = pos.long().clamp(max=self.n * s_local - 1) - \
            self.offset(s_local)
        return (row >= 0) & (row < s_local), row.clamp(0, s_local - 1)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return _all_reduce(x, self.mesh, (self.axis,), op=op)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _all_gather(x, self.mesh, dim, (self.axis,))

    def sum_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` summed in rank order (an all-gather, then the
        sum on every rank alike)."""
        parts = self.gather(x[None], 0)
        out = parts[0]
        for r in range(1, parts.shape[0]):
            out = out + parts[r]
        return out

    def combine(self, out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        """The whole row's attention output from the ranks' partial ones:
        ``out`` (..., D) fp32, each rank's softmax over its keys, and
        ``lse`` (..., 1) fp32, its log-sum-exp (−inf where the rank
        admitted no key).  Σ_r exp(lse_r − M)·out_r / Σ_r exp(lse_r − M)
        with M the largest lse, summed in rank order; 0 where no rank
        admitted a key.  One partial alone comes back as it is."""
        outs, lses = self.gather(out[None], 0), self.gather(lse[None], 0)
        top = lses.amax(dim=0)
        top = torch.where(torch.isfinite(top), top, 0.0)
        num = den = None
        for r in range(outs.shape[0]):
            w = torch.exp(lses[r] - top)
            num = w * outs[r] if num is None else num + w * outs[r]
            den = w if den is None else den + w
        return torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                           0.0)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A tensor-parallel region over ``axis``: the layer function runs
    with ``cfg`` (the rank's ``n_heads / m`` and ``n_kv_heads / m``
    heads, head dim kept), ``enter``s its input and leaves through
    ``row_parallel``, the sum of the ranks' partial out-projections.

    With ``seq`` (context parallelism) the input is the rank's rows:
    ``enter`` all-gathers the sequence (the backward reduce-scatters),
    and the partial sums are reduce-scattered to the rank's rows (the
    backward all-gathers), Megatron's sequence parallelism."""
    mesh: Any
    cfg: Any
    axis: str = "model"
    seq: Optional[SeqShard] = None

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        if self.seq is not None:
            return self.seq.gather(x)
        return _CopyIn.apply(x, self.mesh, (self.axis,))

    def leaf(self, x: torch.Tensor) -> torch.Tensor:
        """A leaf replicated over the axis (the q/k-norm scales): each
        rank's gradient of it is its heads' share, so its backward sums
        them."""
        return _CopyIn.apply(x, self.mesh, (self.axis,))

    def _leave(self, part: torch.Tensor) -> torch.Tensor:
        if self.seq is not None:
            return self.seq.scatter_sum(part)
        return _ReduceOut.apply(part, self.mesh, (self.axis,))

    def row_parallel(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``h @ w`` summed over the region's ranks, ``h`` and ``w``
        the rank's blocks of the contracted dim (the rank's rows of the
        sum under ``seq``).  The partial products stay fp32 until the
        sum (a bf16 model's single-device product accumulates in fp32
        and rounds once, too)."""
        part = torch.matmul(h.float(), w.float())
        return self._leave(part).to(h.dtype)

    # mamba2's and rwkv6's regions (``ShardLayout``: the model's cfg,
    # the rank's heads sliced by ``share``)

    @property
    def size(self) -> int:
        """The region's ranks, m."""
        return self.mesh.axis_size((self.axis,))

    def share(self, n: int) -> slice:
        """The rank's contiguous 1/m of ``n`` (its heads, or their
        channels)."""
        size = n // self.size
        lo = self.mesh.coord((self.axis,)) * size
        return slice(lo, lo + size)

    def sum_shares(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of a statistic of their heads (the
        gated norm's sum of squares over d_inner), read by every rank for
        its own heads only: the backward sums the ranks' gradients too."""
        return _ReduceOut.apply(self.leaf(x), self.mesh, (self.axis,))

    def gather_shared(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks of an activation every rank's heads read
        whole (mamba2's B|C): all-gathered, the gradient summed back."""
        return _Gather.apply(x, self.mesh, dim, (self.axis,), True)

    def scatter_sum(self, part: torch.Tensor, dim: int) -> torch.Tensor:
        """The rank's block along ``dim`` of the ranks' partial products
        summed (fp32 in, the caller casts once)."""
        return _ScatterSum.apply(part, self.mesh, dim, (self.axis,))

    def gather_out(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The region's output from the ranks' blocks along ``dim``:
        every rank then reads it whole with the same gradient, so the
        backward takes the rank's block and sums nothing.  Under
        ``seq`` the rank keeps its rows of it, whose gradient differs
        from rank to rank: the backward sums the blocks' gradients."""
        if self.seq is None:
            return _Gather.apply(x, self.mesh, dim, (self.axis,), False)
        return self.seq.take(_Gather.apply(x, self.mesh, dim, (self.axis,),
                                           True))


@dataclasses.dataclass(frozen=True)
class ExpertParallel:
    """The MoE FFN over ``axis`` (``models.moe.moe_apply``).  Every rank
    routes the same tokens (the router and the routing are replicated);
    under ``mode="expert"`` a rank keeps ``n_experts / m`` whole experts
    and runs only the slots routed to them, under ``"tensor"`` every
    expert with its ``d_ff / m`` block (column-parallel ``wi``/``wg``,
    row-parallel ``wo``).  Either way a rank's combine is a partial sum
    in fp32, summed over the ranks once (``reduce``).  With ``seq``
    the router sees the whole sequence (``tokens`` all-gathers the
    rank's rows), so the groups and capacity stay one device's, and
    ``reduce`` reduce-scatters the sum to the rank's rows."""
    mesh: Any
    mode: str
    axis: str = "model"
    seq: Optional[SeqShard] = None

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The (B, S, D) tokens the rank routes: under ``seq`` gathered
        from the ranks' rows.  Every rank routes them alike and the
        experts' gradients are summed where they ``enter``, so each
        rank's gradient of the whole is the same: it keeps its rows."""
        if self.seq is None:
            return x
        return self.seq.gather(x, shares=False)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self.mesh, (self.axis,))

    def leaf(self, x: torch.Tensor) -> torch.Tensor:
        """The router: its gradient comes whole on every rank (the gates
        enter the region, not the router), so it does not enter."""
        return x

    def experts(self, n_experts: int) -> Tuple[int, int]:
        """(first expert, count) this rank runs."""
        if self.mode == "tensor":
            return 0, n_experts
        n = n_experts // self.mesh.axis_size((self.axis,))
        return self.mesh.coord((self.axis,)) * n, n

    def reduce(self, part: torch.Tensor) -> torch.Tensor:
        """The ranks' fp32 partial combines (B, S, D) summed (the rank's
        rows of the sum under ``seq``)."""
        if self.seq is not None:
            return self.seq.scatter_sum(part)
        return _ReduceOut.apply(part, self.mesh, (self.axis,))


@dataclasses.dataclass(frozen=True)
class VocabParallel:
    """The embedding, unembed and loss over ``axis``: a rank holds
    ``vocab / m`` rows of the embedding and columns of the unembed (the
    embedding's rows, transposed, when tied), looks up the tokens of
    its range, computes its ``(B, S, V / m)`` logits and takes the
    cross-entropy through a logsumexp and a gold logit summed over the
    ranks.  With ``seq`` the lookup's sum is reduce-scattered to the
    rank's rows, and the head gathers the whole sequence first, as the
    reference's ``logits`` spec (dp, None, "model") lays it out."""
    mesh: Any
    vocab: int
    axis: str = "model"
    seq: Optional[SeqShard] = None

    @property
    def rows(self) -> Tuple[int, int]:
        """(first vocab row, count) of this rank."""
        n = self.vocab // self.mesh.axis_size((self.axis,))
        return self.mesh.coord((self.axis,)) * n, n

    def _local(self, ids: torch.Tensor):
        lo, n = self.rows
        local = ids.long() - lo
        inside = (local >= 0) & (local < n)
        return local.clamp(0, n - 1), inside

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(x, self.mesh, (self.axis,))

    def embed(self, w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The rows of ``tokens`` from the rank's block ``w`` (V / m, D),
        zeros outside its range, summed over the ranks: one rank adds
        the row, the others 0, so the sum is the row exactly (taken in
        fp32: gloo need not reduce bf16).  Under ``seq`` the rank keeps
        its rows of the sum."""
        local, inside = self._local(tokens)
        rows = torch.where(inside[..., None], w[local], 0.0).float()
        if self.seq is not None:
            return self.seq.scatter_sum(rows).to(w.dtype)
        return self._sum(rows).to(w.dtype)

    def logits(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The rank's fp32 logits (B, S, V / m); ``x`` enters, so its
        gradient sums every rank's vocab share (under ``seq`` the
        gather of the rank's rows does: its backward reduce-scatters)."""
        x = self.seq.gather(x) if self.seq is not None else \
            _CopyIn.apply(x, self.mesh, (self.axis,))
        return torch.matmul(x.float(), w.float())

    def nll(self, logits: torch.Tensor, labels: torch.Tensor
            ) -> torch.Tensor:
        """logsumexp - gold over the whole vocabulary from the rank's
        logits: the row max all-reduced by max (no gradient: the shift
        cancels), the sum of exp and the gold logit (from the rank that
        owns the label) summed over the ranks."""
        with torch.no_grad():
            mx = _all_reduce(logits.amax(dim=-1), self.mesh, (self.axis,),
                             op="max")
        se = self._sum(torch.exp(logits - mx[..., None]).sum(dim=-1))
        local, inside = self._local(labels)
        gold = torch.gather(logits, -1, local[..., None])[..., 0]
        gold = self._sum(torch.where(inside, gold, 0.0))
        return mx + torch.log(se) - gold


@dataclasses.dataclass(frozen=True)
class DataRows:
    """The activations hold the rank's rows of a batch split over the
    data axes ``axes`` (the serving step's): ``gather`` concatenates
    every data rank's rows in rank order, ``take`` keeps this rank's
    rows of a whole batch.  ``models.moe.moe_apply`` reads it to route
    the whole batch where the rank's tokens do not fill whole groups of
    it.  No gradient: the decode step runs without one."""
    mesh: Any
    axes: Tuple[str, ...]

    @property
    def n(self) -> int:
        return self.mesh.axis_size(self.axes)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _all_gather(x, self.mesh, 0, self.axes)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        return block(x, (self.axes,), self.mesh)


def map_cache(tree: Mapping, fn, prefix: Tuple[str, ...] = ()) -> Dict:
    """The cache tree with ``fn(path, leaf)`` at every leaf."""
    return {name: (map_cache(sub, fn, prefix + (name,))
                   if isinstance(sub, Mapping) else fn(prefix + (name,), sub))
            for name, sub in tree.items()}


# the serving cache's groups (``models.decode.init_cache``) and the module
# whose region reads each; cross_kv's reader depends on the family
_CACHE_READERS = {"kv": "layers.0.attn", "shared_kv": "shared_attn.attn",
                  "mamba": "layers.0.mixer", "rwkv": "layers.0.tmix"}
# the paged pool's leaves: (dim of the KV heads or None), no batch dim
_POOL_LEAVES = {"k_pages": 3, "v_pages": 3, "page_k_min": 2,
                "page_k_max": 2, "page_k_scale": 2, "page_k_zero": 2,
                "page_ref": None}
# the other leaves' KV- or ssm-head dim, after the stack and batch dims
_HEAD_DIM = {"k": 3, "v": 3, "ssm": 2, "state": 2, "conv": 3}
# under the key split: each leaf's sequence dim (k / v, cross_kv's
# ``valid``) or key-block dim (the plan's), after the stack dim
_KEY_DIM = {"k": 2, "v": 2, "valid": 2, "k_min": 3, "k_max": 3,
            "k_scale": 3, "k_zero": 3, "imp": 3, "live_blk": 2,
            "kv_indices": 3}

# mamba2's ("mixer") and rwkv6's ("tmix", time and channel mix) regions:
# (the leaves split by columns over "model", those split by rows)
_SSM_REGIONS = {"mixer": (("in_proj", "conv_w"), ("out_proj",)),
                "tmix": (("wr", "wk", "wv", "wg", "ck", "cr"),
                         ("wo", "bonus_u", "cv"))}


class ShardLayout:
    """Where every parameter of ``cfg``'s model lives on ``mesh`` (train
    specs) and which modules compute on their "model" shard.

    * ``TensorParallel``: every attention (``attn``; audio's
      ``attn_cross``, on the context's K/V of the rank's KV heads) of
      the decoder, vlm's cross layers, audio's encoder and zamba2's
      shared block, where the heads and the KV heads divide by the
      "model" size, and every MLP (``mlp``) where d_ff divides, each
      where the spec shards the in-projections' columns and the
      out-projection's rows over it;
    * the same region over mamba2 (``mixer``: the rank's ssm heads,
      where m divides them and 2·ssm_state) and rwkv6 (``tmix``: the
      time mix on the rank's heads, the channel mix on its d_ff / m);
      ``in_proj`` and ``conv_w`` take ``Packed`` specs, so that a rank's
      block holds its heads' z / x / dt columns and its 1/m of B|C;
    * ``ExpertParallel``: each layer's ``moe``, where the spec shards
      the experts (or their d_ff) over "model";
    * ``VocabParallel``: ``embed``, where the specs shard the vocabulary
      (a dim the "model" size does not divide stays whole: ``_fit``).

    Everything else is gathered over "model" around its use and computed
    whole on every "model" rank: zamba2's ``shared_in``, whose "model"
    split is of the shared block's d_model columns, which the block's
    norm and residual need whole (kept, it would cost an all-gather of
    the activation at every application for a (2·d_model, d_model)
    leaf), and a region's leaves wherever m does not divide its heads
    (or d_ff).

    ``cp`` (context parallelism, the train and prefill steps under
    ``distributed.ctx.set_context_parallel``): a rank's residual stream
    holds its contiguous 1/m of the sequence (``seq``, a ``SeqShard``),
    and every region above but the attention enters through an
    all-gather of the sequence and leaves through a reduce-scatter.
    The attention has no region: it runs every head on the rank's query
    rows against the whole sequence's K/V (``attention_apply``), its
    weights gathered over "model", so the work over "model" splits
    whatever the head count.  A leaf read outside a region then has a
    gradient that is the rank's rows' share: the gather over "model"
    reduce-scatters it, and a leaf replicated over "model" is summed
    over it after the backward (``grad_sum_axes``).  Audio's encoder
    sequence (``encoder_len``) stays whole on every rank where m does
    not divide it, and its layers then take no region (a region's
    backward needs the same gradient on every rank, and there each
    rank's is its decoder rows' share).

    ``mode`` picks the parameter specs (``param_specs``): "train"
    (FSDP over the data axes and TP over "model") or "infer_tp" (TP
    only: weights whole over the data axes, MoE experts keeping their
    data split).  The regions read only the "model" entries, which the
    two modes share, so both build the same regions and the same
    serving-cache layout (``cache_specs``).

    ``key_split`` (a ``KeySplit``, under ``CACHE_SEQ_SHARD`` as it stands
    when the layout is built, on m > 1): the serving cache's self-attention
    keys split over "model" by sequence, and so the context's where m
    divides its length (``key_split_for``); the decode step reads them
    row-parallel over the keys (``models.attention.attention_decode``).
    Without it the cache is laid out by the regions that read it."""

    def __init__(self, cfg, mesh, specs: Optional[Dict[str, Spec]] = None,
                 mode: str = "train", cp: bool = False):
        from repro_torch.models.model import Model
        self.cfg, self.mesh, self.mode = cfg, mesh, mode
        self.specs = dict(specs if specs is not None else param_specs(
            Model(cfg, device="meta"), cfg, mesh, mode=mode))
        self.data = tuple(a for a in data_axes(mesh) if mesh.shape[a] > 1)
        m = self.m = mesh.shape.get("model", 1)
        self._attn = self._mlp = self._moe = self._vocab = self._ssm = None
        self.seq = SeqShard(mesh) if cp and m > 1 else None
        # the serving cache's key split (context-parallel decode), read
        # from CACHE_SEQ_SHARD when the layout is built
        self.key_split = KeySplit(mesh) if CACHE_SEQ_SHARD and m > 1 \
            else None
        # audio's encoder frames split over "model" too, where they divide
        self._enc_split = cfg.family == "audio" and cfg.encoder_len % m == 0
        if m == 1:
            return
        seq = self.seq
        if seq is None and cfg.n_heads % m == 0 and \
                cfg.n_kv_heads % m == 0:
            self._attn = TensorParallel(mesh, dataclasses.replace(
                cfg, n_heads=cfg.n_heads // m,
                n_kv_heads=cfg.n_kv_heads // m, head_dim=cfg.hd))
        if cfg.d_ff % m == 0:
            self._mlp = TensorParallel(mesh, cfg, seq=seq)
        if cfg.moe:
            self._moe = ExpertParallel(mesh, cfg.expert_shard, seq=seq)
        emb = self.specs.get("embed.embedding", (None,))
        unemb = self.specs.get("embed.unembed", (None, "model"))
        if emb[0] == "model" and unemb[-1] == "model":
            self._vocab = VocabParallel(mesh, cfg.vocab_size, seq=seq)
        if cfg.family == "hybrid":
            ssm_ok = cfg.ssm_heads % m == 0 and 2 * cfg.ssm_state % m == 0
        else:
            ssm_ok = cfg.family == "ssm" and cfg.d_ff % m == 0 and \
                (cfg.d_model // cfg.rwkv_head_dim) % m == 0
        if not ssm_ok:
            return
        self._ssm = TensorParallel(mesh, cfg, seq=seq)
        if cfg.family == "hybrid":
            di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            packed = {"in_proj": (di, di, 2 * n, h), "conv_w": (di, 2 * n)}
            for name, spec in self.specs.items():
                path, _, leaf = name.rpartition(".")
                if path.endswith(".mixer") and leaf in packed and \
                        self.tp_for(path) is not None:
                    self.specs[name] = Packed(spec, len(spec) - 1,
                                              packed[leaf])

    def _layout_ok(self, prefix: str, cols, rows) -> bool:
        return all(self.specs.get(prefix + n, (None,))[-1] == "model"
                   for n in cols) and \
            all(self.specs.get(prefix + n, (None,))[0] == "model"
                for n in rows)

    def _whole_encoder(self, path: str) -> bool:
        """Whether module ``path`` is audio's encoder held whole on
        every rank under context parallelism."""
        return self.seq is not None and not self._enc_split and \
            path.startswith(("enc_layers", "enc_ln"))

    def seq_for(self, path: str) -> Optional[SeqShard]:
        """The sequence split module ``path``'s input holds (None: the
        whole sequence)."""
        return None if self._whole_encoder(path) else self.seq

    def tp_for(self, path: str):
        """The region of module ``path`` (``TensorParallel``,
        ``ExpertParallel`` or ``VocabParallel``), or None."""
        kind = path.rsplit(".", 1)[-1]
        prefix = path + "."
        if path == "embed":
            return self._vocab
        if self._whole_encoder(path):
            return None
        if kind == "moe" and self._moe is not None:
            if self._moe.mode == "expert":        # (E, ., .) over model
                ok = self._layout_ok(prefix, (), ("wi", "wg", "wo"))
            else:                                 # d_ff over model
                ok = self._layout_ok(prefix, ("wi", "wg"), ()) and \
                    self.specs.get(prefix + "wo", (None,) * 3)[1] == "model"
            return self._moe if ok else None
        if kind in _SSM_REGIONS and self._ssm is not None:
            return self._ssm if self._layout_ok(prefix, *_SSM_REGIONS[kind]) \
                else None
        if kind == "mlp" and self._mlp is not None:
            cols = ("wi", "wg") if self.cfg.mlp_variant == "swiglu" \
                else ("wi",)
            return self._mlp if self._layout_ok(prefix, cols, ("wo",)) \
                else None
        if kind in ("attn", "attn_cross") and self._attn is not None:
            return self._attn if self._layout_ok(
                prefix, ("wq", "wk", "wv"), ("wo",)) else None
        return None

    def counts(self) -> Dict[str, int]:
        """Leaves kept sharded over "model" in a region, and leaves
        gathered over "model" around their use."""
        tp = gathered = 0
        for name, spec in self.specs.items():
            if "model" not in {a for e in spec for a in entry_axes(e)} \
                    or self.m == 1:
                continue
            if self.tp_for(name.rsplit(".", 1)[0]) is not None:
                tp += 1
            else:
                gathered += 1
        return {"tensor_parallel": tp, "gathered_over_model": gathered}

    def use(self, name: str, shard: torch.Tensor, tp) -> torch.Tensor:
        """Leaf ``name`` as the layer function reads it: gathered over
        the data axes (the gradient reduce-scattered back), and over
        "model" unless it runs in the region ``tp`` (the gradient's
        block taken as it is, or reduce-scattered under context
        parallelism, where each rank's is its rows' share); a
        replicated leaf inside ``tp`` goes through the region's
        ``leaf``."""
        spec = self.specs[name]
        x = shard
        for model in (False, True):           # data axes first, then model
            for dim, entry in enumerate(spec):
                axes = entry_axes(entry)
                if not axes or (("model" in axes) != model):
                    continue
                if model and tp is not None:
                    continue                   # the region keeps its shard
                if self.mesh.axis_size(axes) > 1:
                    x = _Gather.apply(x, self.mesh, dim, axes,
                                      not model or self.seq is not None)
        if tp is not None and all("model" not in entry_axes(e)
                                  for e in spec):
            x = tp.leaf(x)
        return x

    def grad_sum_axes(self, name: str) -> Tuple[str, ...]:
        """The axes leaf ``name``'s gradient must be summed over after
        the backward: the data axes it is replicated over, and under
        context parallelism "model" where it is replicated over "model"
        and read outside a region (each rank's gradient is its rows'
        share)."""
        sharded = {a for e in self.specs[name] for a in entry_axes(e)}
        axes = tuple(a for a in self.data if a not in sharded)
        if self.seq is not None and "model" not in sharded and \
                self.tp_for(name.rsplit(".", 1)[0]) is None:
            axes += ("model",)
        return axes

    def view(self, model: nn.Module, rows: Optional[DataRows] = None
             ) -> "ShardedParams":
        """``model`` read by key through the layout; ``rows``: the
        activations hold the rank's rows of a batch split over the data
        axes (every submodule's view carries it)."""
        return ShardedParams(model, "", self, None, rows, self.seq)

    @torch.no_grad()
    def shard_(self, model: nn.Module) -> nn.Module:
        """Replace every parameter of the (global) ``model`` by this
        rank's block, in place (a parameter the mesh does not split
        stays as it is)."""
        for name, p in model.named_parameters():
            part = block(p.data, self.specs[name], self.mesh)
            if part.shape != p.shape:
                p.data = part.clone()
        return model

    @torch.no_grad()
    def gather_params(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """Every global parameter of the sharded ``model`` (collective)."""
        return {n: gather(p.detach(), self.specs[n], self.mesh)
                for n, p in model.named_parameters()}

    # the serving cache

    def _cache_split(self, group: str) -> bool:
        """Whether the module that reads cache group ``group`` computes
        on the rank's heads (its region exists)."""
        reader = _CACHE_READERS.get(group)
        if group == "cross_kv":
            reader = "cross_layers.0.attn" if self.cfg.family == "vlm" \
                else "layers.0.attn_cross"
        return reader is not None and self.tp_for(reader) is not None

    def _keys_split(self, group: str) -> bool:
        """Whether cache group ``group`` splits its sequence over "model"
        (``key_split``): the self-attention groups always, the context
        (``cross_kv``) where m divides its length, as the reference's
        rule; the recurrent states never."""
        if self.key_split is None or group not in ("kv", "shared_kv",
                                                   "cross_kv"):
            return False
        if group != "cross_kv":
            return True
        cfg = self.cfg
        n = cfg.n_image_tokens if cfg.family == "vlm" else cfg.encoder_len
        return n % self.m == 0

    def key_split_for(self, path: str) -> Optional[KeySplit]:
        """The key split of the cache module ``path``'s decode reads
        (None: its cache is laid out by heads, or whole)."""
        kind = path.rsplit(".", 1)[-1]
        if path.startswith("cross_layers") or kind == "attn_cross":
            group = "cross_kv"
        elif kind == "attn" and not path.startswith("enc_layers"):
            group = "kv"
        else:
            return None
        return self.key_split if self._keys_split(group) else None

    def _key_spec(self, path: Tuple[str, ...], shape,
                  nkb: Optional[int]) -> list:
        """A leaf's spec under the key split: batch rows over the data
        axes, the sequence (or the plan's key-block) dim over "model";
        the plan's per-slot vectors and ``kv_counts`` (per rank: the
        count of its own blocks) whole over "model"."""
        leaf, m = path[-1], self.m
        if leaf in _POOL_LEAVES or leaf == "page_table":
            raise ValueError(
                f"context-parallel decode (CACHE_SEQ_SHARD) has no paged "
                f"layout: the pool's pages hold every slot's keys and no "
                f"sequence dim splits (the reference's cache_specs fails "
                f"on a paged cache too) — use kv.layout='contiguous'")
        spec = [None] * len(shape)
        if len(shape) >= 2:
            spec[1] = _dp(self.mesh)
        dim = _KEY_DIM.get(leaf)
        if dim is None:
            return spec
        if leaf == "kv_indices" and shape[dim] != nkb:
            raise ValueError(
                f"context-parallel decode plans every key block: a plan "
                f"width of {shape[dim]} below the {nkb} blocks keeps the "
                f"first blocks of the whole row (sata.decode.blocks=None)")
        if shape[dim] % m:
            what = "key blocks" if "plan" in path else "positions"
            raise ValueError(
                f"context-parallel decode: {path[0]}'s {shape[dim]} {what} "
                f"do not split over {m} ranks (a rank's keys must tile by "
                f"the decode block)")
        spec[dim] = "model"
        return spec

    def cache_specs(self, cache: Mapping) -> Dict[Tuple[str, ...], Spec]:
        """Spec per leaf path of the layer-stacked serving cache
        (``models.decode.init_cache``; the stack dim never shards).

        Under ``key_split`` (``CACHE_SEQ_SHARD``), the reference's
        context-parallel layout: ``kv`` / ``shared_kv`` hold their batch
        rows over the data axes and their SEQUENCE over "model", rank r
        the keys ``r·S/m ..``; so do the plan's leaves along their
        key-block dim (the summaries, the importance, ``live_blk``, and
        ``kv_indices``, whose rows the first decode step re-plans in the
        rank's local block ids), and ``cross_kv`` (with its ``valid``)
        where m divides the context's length (``_keys_split``).  A paged
        cache, a plan narrower than its key blocks, or a sequence that
        does not split, raises.  Every other group as below.

        Otherwise laid out as a head-parallel decode step reads it:

        * batch rows over the data axes wherever they divide; the paged
          pool and its per-page arrays have no batch dim (every slot's
          pages live in the one pool), so they stay whole there and a
          data rank writes and reads only its own slots' pages;
        * over "model", where the module that reads the group computes
          in its region (``tp_for``): the KV heads of ``kv`` /
          ``shared_kv`` / ``cross_kv`` and of the pool, the plan's
          summaries, rows and importance (their KV axis,
          ``launch.mesh._PLAN_KV_AXIS``, one dim on for the stack),
          mamba2's ssm heads and its conv channels (``Packed`` as
          ``conv_w``: the rank's heads' x columns, then its 1/m of B|C),
          rwkv6's heads of the time-mix state;
        * everything else whole on every "model" rank: the token-shift
          rows ``tm_x`` / ``cm_x``, ``valid``, the page table,
          ``page_ref`` and the plan's per-slot vectors."""
        dp = _dp(self.mesh)
        nkb = {g: tuple(getattr(t["plan"]["k_min"], "shape",
                                t["plan"]["k_min"]))[3]
               for g, t in cache.items() if isinstance(t, Mapping)
               and isinstance(t.get("plan"), Mapping)}
        specs = {}
        for path, shape in _cache_shapes(cache):
            leaf = path[-1]
            if self._keys_split(path[0]):
                specs[path] = _fit(shape, self._key_spec(
                    path, shape, nkb.get(path[0])), self.mesh)
                continue
            spec = [None] * len(shape)
            heads = _HEAD_DIM.get(leaf)
            if "plan" in path:
                kv = _PLAN_KV_AXIS[leaf]
                heads = None if kv is None else kv + 1
            if leaf in _POOL_LEAVES:
                heads = _POOL_LEAVES[leaf]
            elif len(shape) >= 2:
                spec[1] = dp
            if heads is not None and self.m > 1 and \
                    self._cache_split(path[0]):
                spec[heads] = "model"
            spec = _fit(shape, spec, self.mesh)
            if leaf == "conv" and spec[3] == "model":
                cfg = self.cfg
                spec = Packed(spec, 3, (cfg.d_inner, 2 * cfg.ssm_state))
            specs[path] = spec
        return specs

    def block_cache(self, cache: Mapping) -> Dict:
        """This rank's blocks of a whole serving cache, each its own
        contiguous tensor (the decode step updates them in place)."""
        specs = self.cache_specs(cache)
        return map_cache(cache, lambda path, t: block(
            t, specs[path], self.mesh).clone(
                memory_format=torch.contiguous_format))

    @torch.no_grad()
    def gather_cache(self, cache: Mapping, whole: Mapping) -> Dict:
        """The whole serving cache from every rank's blocks ``cache``
        (collective); ``whole`` is a whole cache (the meta device will
        do) that gives the specs.  A leaf whole over the data axes comes
        back as this rank's copy: the paged pool under a data split
        holds only its slots' rows as the step wrote them."""
        specs = self.cache_specs(whole)
        return map_cache(cache, lambda path, t: gather(t, specs[path],
                                                        self.mesh))


class ShardedParams:
    """A sharded ``Model`` (or one of its modules) read by key, as the
    layer functions read a ``ParamModule``: a parameter comes back
    through ``ShardLayout.use``, a submodule as another view, a
    ``ModuleList`` as a list of views.  ``tp`` is the module's region
    (``ShardLayout.tp_for``), which ``attention_apply``, ``mlp_apply``,
    ``moe_apply`` and the embedding functions read; ``rows`` is the
    step's ``DataRows`` or None, which ``moe_apply`` reads; ``seq`` is
    the ``SeqShard`` of the module's input under context parallelism
    (``ShardLayout.seq_for``) or None, which ``models.model.forward``,
    ``attention_apply`` and the modules without a region read;
    ``key_split`` is the ``KeySplit`` of the serving cache the module's
    decode reads (``ShardLayout.key_split_for``) or None, which
    ``attention_decode`` and ``cross_attention_decode`` read."""

    def __init__(self, module: nn.Module, prefix: str, layout: ShardLayout,
                 tp: Optional[TensorParallel],
                 rows: Optional[DataRows] = None,
                 seq: Optional[SeqShard] = None,
                 key_split: Optional[KeySplit] = None):
        self._module, self._prefix = module, prefix
        self._layout, self.tp, self.rows, self.seq = layout, tp, rows, seq
        self.key_split = key_split

    def _sub(self, module: nn.Module, path: str) -> "ShardedParams":
        return ShardedParams(module, path + ".", self._layout,
                             self._layout.tp_for(path), self.rows,
                             self._layout.seq_for(path),
                             self._layout.key_split_for(path))

    def __getitem__(self, name: str):
        try:
            obj = getattr(self._module, name)
        except AttributeError:
            raise KeyError(name) from None
        path = self._prefix + name
        if isinstance(obj, nn.ModuleList):
            return [self._sub(m, f"{path}.{i}") for i, m in enumerate(obj)]
        if isinstance(obj, nn.Module):
            return self._sub(obj, path)
        if isinstance(obj, torch.Tensor):
            return self._layout.use(path, obj, self.tp)
        raise KeyError(name)

    def get(self, name: str, default=None):
        try:
            return self[name]
        except KeyError:
            return default
