"""The ranks of ``tests/test_torch_cp_decode.py``, the reference's
context-parallel decode, and the cases all three run.

    python tests/torch_cp_decode_ranks.py RANK WORLD TMP

joins a gloo world of WORLD ranks through the ``FileStore`` at
TMP/store<WORLD>, runs every (mesh, case) of :data:`MESHES` through
``make_serve_step(cfg, mesh=, mode="infer_tp")`` under the key split
(``CACHE_SEQ_SHARD``, the default) and has rank 0 write every rank's
results to TMP/world<WORLD>.pt.  World 2 runs (1, 2), world 4 (2, 2)
and (1, 4).

    python tests/torch_cp_decode_ranks.py reference TMP PART PARTS

runs part PART of PARTS of the cases on every mesh through the
reference's ``jax.jit(make_serve_step(cfg))`` on a forced-device mesh
with ``AxisType.Auto`` axes, ``in_shardings`` from its ``param_specs``
("infer_tp"), ``cache_specs`` (``CACHE_SEQ_SHARD``: the sequence over
"model") and ``batch_specs``, under ``set_activation_shardings(
make_activation_shardings(mesh, cfg, seq_shard=False))``, and writes
TMP/reference<PART>.npz.  Its mesh decode has no SATA plan (its
``sata_decode_on`` is False under a mesh): it attends densely with the
bisection's mask.  ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
must be set before jax starts.

Every case fills one whole contiguous cache (``torch_serve_mesh_ranks.
fill_cache``, every slot at its own position of the case's start), from
the reference's ``init_params`` weights (TMP/<name>.npz, written by the
reference's processes, rwkv6's by the test), and runs :data:`STEPS`
steps fed :func:`feed`'s seeded tokens.
"""
import dataclasses
import os
import sys

import numpy as np

import torch_mesh_train_ranks as T
import torch_serve_mesh_ranks as R

B, MAX_LEN, STEPS, PAGE = R.B, R.MAX_LEN, R.STEPS, R.PAGE
# each slot's position at step 0, written at each step: slot 0 holds no
# key past the first rank's (on every mesh), slot 1's writes cross the
# boundary of (1, 2)'s and (1, 4)'s ranks (31 → 32), slot 2's that of
# (1, 4)'s third (47 → 48), slot 3 reaches the cache's end, and its last
# write clamps to the last row (64 → 63), which the last rank holds
START = (5, 31, 47, 62)
# moe prompts are at most a group (16) or a multiple of one
MOE_START = (5, 16, 32, 48)
# case: (family, route, config overrides).  route "kernel": SATA decode
# on (the exact re-plan + the decode kernel's partial mode, its plain
# version on the CPU); "dense": decode off (``_attend_split``, the
# reference's own path); None: no attention (ssm)
CASES = {
    "qwen3-4b": ("dense", "kernel", {}),
    "qwen3-4b-dense": ("dense", "dense", {}),
    "gqa": ("dense", "kernel", {"n_kv_heads": 2}),
    "gqa-dense": ("dense", "dense", {"n_kv_heads": 2}),
    "moe": ("moe", "kernel", {}),
    "vlm": ("vlm", "kernel", {}),
    "audio": ("audio", "kernel", {}),
    "audio9": ("audio", "kernel", {"encoder_len": 9}),
    "hybrid": ("hybrid", "kernel", {}),
    "ssm": ("ssm", None, {}),
}
# the port's cases the reference does not run: ssm (no attention, its
# cache the head layout's) and vlm with context lengths (the reference's
# cache_specs has no rule for the context's 3-D ``valid``)
PORT_ONLY = {"ssm": {}, "vlm-len": {"lengths": (8, 5, 3, 6)}}
MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
SEED = 30


def family(case):
    return CASES["vlm" if case == "vlm-len" else case][0]


def start(case):
    return MOE_START if family(case) == "moe" else START


def case_cfg(smoke, dec_cls, kv_cls, case):
    """The case's config from a package's SMOKE and config classes: the
    serve tests' decode (bisect, 8-token blocks, an exact re-plan every
    step), SATA decode on for the kernel route, off for the dense one,
    contiguous."""
    fam, route, over = CASES["vlm" if case == "vlm-len" else case]
    base = smoke[R.FAMILIES[fam]]
    sata = dataclasses.replace(base.sata, decode=dec_cls(
        mode="on" if route == "kernel" else "off", block=PAGE, replan=1))
    return dataclasses.replace(base, topk_impl="bisect", sata=sata,
                               kv=kv_cls(layout="contiguous"), **over)


def feed(cfg):
    """Every step's tokens (B, 1), seeded: the three sides are fed the
    same."""
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
            for _ in range(STEPS)]


def weights_name(case):
    """The npz a case's weights come from: a config's two routes and
    vlm with or without context lengths share one (the decode mode and
    the lengths change no parameter)."""
    return reference_name("vlm" if case == "vlm-len" else case)


def write_weights(tmp, params, case):
    """TMP/<case>.npz: the reference's ``init_params`` of ``case``, made
    whole before it appears (``port_model`` waits for it).  The
    reference's processes write their cases', the test rwkv6's."""
    path = os.path.join(tmp, f"{case}.npz")
    np.savez(path + ".part.npz", **T.flat(params))
    os.replace(path + ".part.npz", path)


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------

class Recorder:
    """Every top-k bisection's threshold while installed: the module
    attributes ``kth_largest_bisect`` is called by (one device's dense
    ``_attend``, the plan's ``full_replan``, the key split's
    ``_attend_split``) replaced by a recording wrapper.  A bisection over
    ranks (``over=``) also gathers the ranks' scores and records whether
    its threshold is bitwise the whole row's (``whole``)."""

    MODULES = ("repro_torch.core.selection", "repro_torch.core.decode_plan",
               "repro_torch.models.attention")

    def __init__(self):
        import importlib
        self.mods = [importlib.import_module(m) for m in self.MODULES]
        self.fn = self.mods[0].kth_largest_bisect
        self.seen, self.whole = [], []

    def __enter__(self):
        def rec(scores, k, *a, over=None, **kw):
            out = self.fn(scores, k, *a, over=over, **kw)
            self.seen.append(out.clone())
            if over is not None:
                row = self.fn(over.gather(scores, scores.dim() - 1), k, *a,
                              **kw)
                self.whole.append(bool((row == out).all()))
            return out
        for m in self.mods:
            m.kth_largest_bisect = rec
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.kth_largest_bisect = self.fn


def plan_rows(cache):
    """Layer 0's (kv_indices, kv_counts) of the self-attention group, or
    None."""
    rows = R.plan_rows(cache)
    return None if rows is None else tuple(np.array(r) for r in rows)


def port_case(tmp, case, mesh):
    """The case on ``mesh`` (None: one device): each step's logits, every
    bisection's threshold, layer 0's plan rows after each step; on a
    mesh also the rank's mesh coordinates, ``counts()``, whether the
    whole cache's blocks gather back to it bitwise, the cache's leaf
    shapes and specs."""
    import torch
    from repro_torch.configs.archs import SMOKE
    from repro_torch.distributed.sharding import cache_leaves
    from repro_torch.models.config import KVCacheConfig, SataDecodeConfig
    from repro_torch.train.step import make_serve_step
    be = R.Port()
    cfg = case_cfg(SMOKE, SataDecodeConfig, KVCacheConfig, case)
    model = T.port_model(tmp, weights_name(case), cfg)
    whole, _ = R.fill_cache(be, model, cfg, family(case), "contiguous",
                            start=start(case),
                            lengths=PORT_ONLY.get(case, {}).get("lengths"))
    out = {}
    if mesh is None:
        cache = whole

        def step(c, t, p):
            return be.step(model, cfg, c, t, p)
    else:
        serve = make_serve_step(cfg, mesh=mesh, mode="infer_tp")
        layout = serve.layout
        layout.shard_(model)
        cache = layout.block_cache(whole)
        out.update(coords=(mesh.coord("data"), mesh.coord("model")),
                   counts=layout.counts(),
                   roundtrip=R._equal_trees(
                       layout.gather_cache(cache, whole), whole),
                   shapes={"/".join(p): tuple(t.shape)
                           for p, t in cache_leaves(cache)},
                   specs={"/".join(p): tuple(s) for p, s in
                          layout.cache_specs(whole).items()})

        def step(c, t, p):
            lg, c = serve(model, c, torch.from_numpy(t),
                          torch.from_numpy(p))
            return lg.numpy(), c
    plans = []

    def run(c, t, p):
        lg, c = step(c, t, p)
        plans.append(plan_rows(c))
        return lg, c
    with Recorder() as rec:
        logits, _, _ = R.drive(run, cache, None, feed=feed(cfg),
                               start=start(case))
    out.update(logits=logits, plans=plans, whole_row=rec.whole,
               thresholds=[t.numpy() for t in rec.seen])
    return out


def run_world(world, tmp):
    from repro_torch.launch.mesh import make_train_mesh
    res = {}
    for shape in MESHES[world]:
        mesh = make_train_mesh(*shape, device="cpu")
        for case in [*CASES, "vlm-len"]:
            res[(shape, case)] = port_case(tmp, case, mesh)
    return res


def main_rank(rank, world, tmp):
    import torch_threads  # noqa: F401  (one intra-op thread)
    import torch
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp}/store{world}", rank=rank,
        world_size=world)
    try:
        res = run_world(world, tmp)
        parts = [None] * world
        torch.distributed.all_gather_object(parts, res)
        if rank == 0:
            torch.save(parts, os.path.join(tmp, f"world{world}.pt"))
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

class _Ref:
    """The reference's side of ``fill_cache``, on one CPU device."""

    def __init__(self):
        import jax.numpy as jnp
        from repro.core.paging import PageAllocator
        from repro.models import decode
        self.dec, self.alloc, self.jnp = decode, PageAllocator, jnp

    def init_cache(self, cfg):
        return self.dec.init_cache(cfg, B, MAX_LEN)

    def to(self, a):
        return self.jnp.asarray(a)


def reference_name(case):
    """The reference run a port case is held to: both routes of a config
    share one (the reference's mesh decode has no plan)."""
    return case.removesuffix("-dense")


def reference_jobs(part, parts):
    """Part ``part`` of the reference's cases, dealt in turn: a part runs
    its cases on every mesh (one weight init and cache fill a case)."""
    cases = [c for c in CASES if c not in PORT_ONLY
             and reference_name(c) == c]
    return cases[part::parts]


def reference_case(tmp, case):
    """The reference's jitted ``make_serve_step`` over the
    sequence-split cache on every mesh of :data:`MESHES`: the case's
    weights written for the port (``write_weights``), its cache filled
    once on one device (no plan: decode off, as its mesh decode runs),
    then on each mesh placed by the specs and stepped."""
    import jax
    import jax.numpy as jnp
    from repro.configs.archs import SMOKE
    from repro.distributed import ctx as dctx
    from repro.distributed.sharding import (batch_specs, cache_specs,
                                            param_specs, to_shardings)
    from repro.launch.mesh import _mesh_kwargs, activate_mesh
    from repro.models import model as jmdl
    from repro.models.config import KVCacheConfig, SataDecodeConfig
    from repro.train.step import make_serve_step
    cfg = dataclasses.replace(
        case_cfg(SMOKE, SataDecodeConfig, KVCacheConfig, case),
        sata=dataclasses.replace(SMOKE[R.FAMILIES[family(case)]].sata,
                                 decode=SataDecodeConfig(mode="off")))
    params = jmdl.init_params(jax.random.PRNGKey(0), cfg)
    write_weights(tmp, params, case)
    cache, _ = R.fill_cache(_Ref(), params, cfg, family(case), "contiguous",
                            start=start(case))
    out = {}
    for shape in (s for shapes in MESHES.values() for s in shapes):
        mesh = jax.make_mesh(shape, ("data", "model"), **_mesh_kwargs(2))
        dctx.set_activation_shardings(
            dctx.make_activation_shardings(mesh, cfg, seq_shard=False),
            mesh=mesh)
        try:
            p_sh = to_shardings(param_specs(params, cfg, mesh,
                                            mode="infer_tp"), mesh)
            c_sh = to_shardings(cache_specs(cache, cfg, mesh), mesh)
            t_sh = to_shardings(batch_specs(
                {"t": np.zeros((B, 1), np.int32)}, mesh), mesh)["t"]
            step = jax.jit(make_serve_step(cfg),
                           in_shardings=(p_sh, c_sh, t_sh, None))
            with activate_mesh(mesh):
                placed = jax.device_put(params, p_sh)

                def run(c, t, p):
                    lg, c = step(placed, c, jnp.asarray(t), jnp.asarray(p))
                    return np.asarray(lg), c
                logits, _, _ = R.drive(run, jax.device_put(cache, c_sh),
                                       None, feed=feed(cfg),
                                       start=start(case))
        finally:
            dctx.clear()
        out.update({f"{shape[0]}x{shape[1]}/{case}/{i}": a
                    for i, a in enumerate(logits)})
    return out


def main_reference(tmp, part, parts):
    out = {}
    for case in reference_jobs(part, parts):
        out.update(reference_case(tmp, case))
    np.savez(os.path.join(tmp, f"reference{part}.npz"), **out)


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        main_reference(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        main_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
