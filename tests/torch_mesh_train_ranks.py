"""The ranks of ``tests/test_torch_mesh_train.py``, the reference's
``train`` on a forced-device mesh, and the configs both sides use.

    python tests/torch_mesh_train_ranks.py RANK WORLD TMP

joins a gloo world through the ``FileStore`` at TMP/store<WORLD>, runs
:func:`run_world` and has rank 0 write the results to
TMP/world<WORLD>.pt (``torch.save``).  The reference's initial
parameters come from TMP/<case>.npz (written by the test from
``repro.models.model.init_params`` while the ranks start,
``write_weights``), so both packages start from the same weights.  World 4 trains every case of :func:`mesh_cases` on the
(2, 2) mesh and runs the checkpoint scenario and one step of each of
:data:`FAMILIES`, and trains bf16 qwen3-4b on (4, 1)
(:data:`BF16_MESH`); world 2 trains on (2, 1) and (1, 2), with gradient
compression on (2, 1), records the shapes a (1, 2) rank's expert
products and logits see, resumes world 4's checkpoint on (1, 2) and
holds the sharded AdamW step to the one-device one.  Every
:func:`mesh_cases` run, on both packages, also keeps its first AdamW
moment after step 1 (the reference's from a step-1 checkpoint of its
``train``): ``0.1 ×`` the clipped first gradient, which the test reads
where a parameter misses ``PARAM_ATOL`` (ROADMAP C12).

    python tests/torch_mesh_train_ranks.py reference TMP PART PARTS

runs the reference's ``train`` on part PART of PARTS of the (mesh shape
of :data:`MESHES`, case) pairs (``reference_jobs``), the parts at once
(``XLA_FLAGS=--xla_force_host_platform_device_count=4`` must be set
before jax starts; the meshes are built with ``AxisType.Auto``, as
``repro.launch.mesh`` builds them: jax's default Explicit axes fail at
the embedding gather) and writes TMP/reference<PART>.npz.

    python tests/torch_mesh_train_ranks.py regions RANK TMP

runs :func:`region_case` for zamba2 and rwkv6 on rank RANK of a 2-rank
world on (1, 2) (``tests/test_torch_ssm_regions.py``).

    python tests/torch_mesh_train_ranks.py collectives RANK TMP

runs each :data:`COLLECTIVE_CASES` step once on rank RANK of a 2-rank
world on (1, 2), without and with context parallelism, and has rank 0
write TMP/collectives.pt: each step's collective bytes by kind
(``ShardMesh.collective_bytes``), for ``tests/test_torch_dryrun.py`` to
hold the dry run's fake world to.
"""
import dataclasses
import os
import shutil
import sys

import numpy as np

STEPS, BATCH = 3, 4
# (arch in SMOKE, seq, kernel-route overrides or None): SMOKE qwen3-4b
# and qwen3-moe take ``_attend`` (SMOKE's kernel is off); "gqa-kernel"
# is qwen3-4b's SMOKE config on the SATA kernel route (chunked
# selection, compacted grid, blocks of 16) with 4 query over 2 KV heads
CASES = {
    "qwen3-4b": ("qwen3-4b", 32, None),
    "qwen3-moe": ("qwen3-moe-235b-a22b", 32, None),
    "gqa-kernel": ("qwen3-4b", 64, dict(n_kv_heads=2, topk_k=8,
                                        topk_impl="bisect", q_chunk=16)),
}
# the other families, one step each on (2, 2) against the port's one
# device: olmo-1b's attention and MLP, zamba2's mamba2 layers and shared
# block and rwkv6's time and channel mix run in their "model" regions,
# vlm's and whisper's too
FAMILIES = {
    "olmo": ("olmo-1b", 32, None),
    "zamba2": ("zamba2-2.7b", 32, None),
    "rwkv6": ("rwkv6-1.6b", 32, None),
    "vlm": ("llama-3.2-vision-90b", 32, None),
    "audio": ("whisper-base", 32, None),
}
# the FAMILIES cases whose updated parameters are held under ROADMAP
# C12's first-update rule (both runs record their first moments): on
# (2, 2) rwkv6's time and channel mix reorder the fp32 sum of one
# near-zero ``wk`` gradient entry inside AdamW's eps (1.09e-5 off after
# the step); every other case stays at PARAM_ATOL, element by element
FAMILY_MOMENTS = ("rwkv6",)
# the modules that compute on their "model" shard in the expert-, vocab-
# and tensor-parallel regions beyond the dense attention and MLP, 3 steps
# each against the port's one device and the reference on the same mesh:
# SMOKE grok-1's experts split by d_ff (``expert_shard="tensor"``) on
# (1, 2) and (2, 2); llama-3.2-vision's cross layers, whisper's encoder
# and cross-attention, zamba2's mamba2 layers and shared block, rwkv6's
# time and channel mix and a tied embedding on (1, 2).  Every case also
# runs its embedding, unembed and loss vocab-parallel over "model".
MODEL_CASES = {"grok": ((1, 2), (2, 2)), "vlm": ((1, 2),),
               "audio": ((1, 2),), "zamba2": ((1, 2),),
               "rwkv6": ((1, 2),), "tied": ((1, 2),)}
# "tied": SMOKE qwen3-4b with ``tie_embeddings``: the unembed is the
# rank's embedding rows, transposed; "gqa" ("gqa-kernel" on ``_attend``),
# "audio9" (9 encoder frames) and "moe3" (3 experts),
# ``tests/test_torch_cp_train.py``'s cases whose KV heads, encoder
# frames, or experts "model" does not divide
ROWS = {**CASES, **FAMILIES, "grok": ("grok-1-314b", 32, None),
        "tied": ("qwen3-4b", 32, dict(tie_embeddings=True)),
        "gqa": ("qwen3-4b", 64, dict(n_kv_heads=2, topk_k=8,
                                     topk_impl="bisect", q_chunk=16)),
        "audio9": ("whisper-base", 32, dict(encoder_len=9)),
        "moe3": ("qwen3-moe-235b-a22b", 32, dict(n_experts=3))}
KERNEL_CASES = ("gqa-kernel",)     # the SATA kernel route, blocks of 16
MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
# cases whose reference ``train`` runs a step a call, each resumed from
# the last one's checkpoint: its jit pins no output shardings, and on a
# model-split mesh GSPMD hands SMOKE zamba2's final_ln and shared-block
# norm scales back split over "model", which its second call refuses
# (``ValueError: Sharding passed to jit does not match``), and so does
# SMOKE rwkv6's second call; a resumed call restores onto its input
# shardings.  ``train`` at ``steps`` k takes step k - 1 at the learning
# rate ``steps = 3`` gives it (warmup 2 steps, then the cosine from step
# 2 to ``decay_steps``)
REF_STEPWISE = ("zamba2", "rwkv6")
# the forward whose region shapes a (1, 2) rank records (``region_shapes``)
SHAPES_MESH, SHAPES_CASES = (1, 2), ("qwen3-moe", "grok")
CKPT_CASE, CKPT_STEPS, CKPT_FAIL = "qwen3-4b", 5, 3
# SMOKE qwen3-4b on (2, 1) against one device: int8 gradient
# compression, two microbatches of 2 rows (a row a data rank each), and
# a batch of one row, which does not divide over the 2 data ranks and
# so replicates (each rank takes the row at half the weight)
COMPRESS_MESH = (2, 1)
VARIANTS = {"compress": dict(compress_grads=True),
            "micro2": dict(micro_steps=2),
            "batch1": dict(batch=1)}
# SMOKE qwen3-4b in bf16 from the seed's own weights on (4, 1): a data
# axis of four ranks, over which each bf16 gradient is summed in fp32
# and rounded once
BF16_MESH = (4, 1)


def mesh_cases(shape):
    """The cases trained 3 steps on mesh ``shape``."""
    return [*CASES] + [c for c, shapes in MODEL_CASES.items()
                       if shape in shapes]


def case_cfg(smoke, case, kernel_config):
    """The case's config from a package's ``SMOKE`` and its
    ``SataKernelConfig``."""
    arch, _, over = ROWS[case]
    cfg = smoke[arch]
    if over is None:
        return cfg
    if case not in KERNEL_CASES:
        return dataclasses.replace(cfg, **over)
    return dataclasses.replace(
        cfg, **over, sata=dataclasses.replace(cfg.sata, kernel=kernel_config(
            use=True, block=16, schedule="compact")))


def flat(tree, prefix=""):
    """{dotted name: array} of a nested params dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def nested(arrays):
    out = {}
    for name, a in arrays.items():
        *path, leaf = name.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = a
    return out


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def write_weights(tmp, smoke, init_params, key, kernel_config):
    """TMP/<case>.npz of every case, in the order the ranks first need
    them, each made whole before it appears (``port_model`` waits)."""
    order = [*CASES, *MODEL_CASES, *FAMILIES]
    for case in order + [c for c in ROWS if c not in order]:
        cfg = case_cfg(smoke, case, kernel_config)
        path = os.path.join(tmp, f"{case}.npz")
        np.savez(path + ".part.npz", **flat(init_params(key, cfg)))
        os.replace(path + ".part.npz", path)


def port_model(tmp, case, cfg, timeout=600.0):
    """The port's model from the reference's weights in TMP/<case>.npz,
    once ``write_weights`` has written them."""
    import time
    from repro_torch.models.model import params_from_jax
    path, t0 = os.path.join(tmp, f"{case}.npz"), time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.1)
    with np.load(path) as z:
        arrays = {n: z[n] for n in z.files}
    return params_from_jax(nested(arrays), cfg, device="cpu")


def train_case(tmp, case, mesh, dtype=None, moments=False, **kw):
    """``train`` of the case on ``mesh`` from the reference's weights
    (with a ``dtype``: from the seed's own, in that dtype): losses, grad
    norms and the gathered final parameters; with ``moments``, also
    AdamW's first moment after step 1 (``0.1 ×`` the clipped first
    gradient), copied as the step leaves it."""
    import repro_torch.train.step as step
    from repro_torch.configs.archs import SMOKE
    from repro_torch.launch.train import train
    from repro_torch.models.config import SataKernelConfig
    cfg = case_cfg(SMOKE, case, SataKernelConfig)
    model = None
    if dtype is None:
        model = port_model(tmp, case, cfg)
    else:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    _, seq, _ = ROWS[case]
    run = dict(steps=STEPS, batch=BATCH, seq=seq, log_every=100, seed=0)
    run.update(kw)
    first, update = {}, step.adamw_update

    def recording(*args, **kwargs):
        out = update(*args, **kwargs)
        if not first:
            first.update({n: m.clone() for n, m in out[1]["m"].items()})
        return out

    step.adamw_update = recording if moments else update
    try:
        out = train(case, cfg=cfg, model=model, mesh=mesh, device="cpu",
                    **run)
    finally:
        step.adamw_update = update
    res = {"losses": out["losses"], "gnorms": out["gnorms"]}
    if mesh is not None and mesh.size > 1:
        from repro_torch.distributed.sharding import ShardLayout, gather
        layout = ShardLayout(cfg, mesh)
        res["params"] = layout.gather_params(out["final_state"]["params"])
        res["counts"] = layout.counts()
        if moments:
            res["m1"] = {n: gather(m, layout.specs[n], mesh)
                         for n, m in first.items()}
    else:
        res["params"] = {n: p.detach().clone() for n, p in
                         out["final_state"]["params"].named_parameters()}
        if moments:
            res["m1"] = first
    return res


def error_of(fn):
    try:
        fn()
    except Exception as e:  # the refusal is the result: type and text
        return type(e).__name__, str(e)
    return None


def adamw_case(mesh):
    """One compressed AdamW step on the rank's blocks of two leaves
    (one sharded over "data" on dim 0, one on dim 1) against the same
    step on the whole leaves, gradients small enough that nothing
    clips: returns the gathered params, moments and error buffers of
    both, and what the step gives when each block takes its own absmax
    (the port before this layout existed)."""
    import torch
    from repro_torch.distributed.sharding import block, gather
    from repro_torch.optim import adamw
    rng = np.random.default_rng(5)
    names = ("a", "b")
    specs = {"a": ("data", None), "b": (None, "data")}
    full = {n: {k: (s * rng.standard_normal((8, 6))).astype(np.float32)
                for k, s in (("p", 1.0), ("g", 1e-2), ("e", 1e-4))}
            for n in names}
    opt = adamw.OptConfig(warmup_steps=2, decay_steps=3, compress_grads=True)

    def run(mesh_, blk):
        t = {n: {k: torch.from_numpy(blk(v, n).copy()) for k, v in d.items()}
             for n, d in full.items()}
        p = {n: t[n]["p"] for n in names}
        st = adamw.init_opt_state(p)
        p, st, e, m = adamw.adamw_update(
            opt, p, {n: t[n]["g"] for n in names}, st,
            {n: t[n]["e"] for n in names}, mesh=mesh_, specs=specs)
        return p, st, e, m

    def sharded_block(a, n):
        return block(torch.from_numpy(a), specs[n], mesh).numpy()

    p, st, e, m = run(mesh, sharded_block)
    got = {n: [gather(x, specs[n], mesh) for x in
               (p[n], st["m"][n], st["v"][n], e[n])] for n in names}
    p1, st1, e1, m1 = run(None, lambda a, n: a)
    want = {n: [p1[n], st1["m"][n], st1["v"][n], e1[n]] for n in names}
    p2, st2, e2, _ = run(None, sharded_block)       # per-block absmax
    local = {n: [p2[n], e2[n]] for n in names}
    return {"got": got, "want": want, "local_absmax": local,
            "gnorm": (float(m["grad_norm"]), float(m1["grad_norm"]))}


def region_shapes(tmp, mesh):
    """A forward of each of SHAPES_CASES on ``mesh`` from the
    reference's weights: the shapes of the slots, ``wi`` and ``wo`` at
    every expert product of the rank, and of its logits."""
    import torch
    from repro_torch.configs.archs import SMOKE
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import ShardLayout, block
    from repro_torch.models import model as mdl
    from repro_torch.models import moe
    from repro_torch.models.config import SataKernelConfig
    out, run = {}, moe._experts

    def seen(p, xin, partial=False):
        out[case]["experts"].append(
            (tuple(xin.shape), tuple(p["wi"].shape), tuple(p["wo"].shape)))
        return run(p, xin, partial)

    moe._experts = seen
    try:
        for case in SHAPES_CASES:
            cfg = case_cfg(SMOKE, case, SataKernelConfig)
            layout = ShardLayout(cfg, mesh)
            model = layout.shard_(port_model(tmp, case, cfg))
            batch = SyntheticLM(cfg, BATCH, ROWS[case][1],
                                seed=0).next_batch()
            local = {k: block(torch.from_numpy(a), (layout.data,), mesh)
                     for k, a in batch.items()}
            out[case] = {"experts": []}
            with torch.no_grad():
                logits, _ = mdl.forward(layout.view(model), cfg, local)
            out[case]["logits"] = tuple(logits.shape)
    finally:
        moe._experts = run
    return out


def run_world(rank, world, tmp):
    import torch
    from repro_torch.launch import mesh as M
    res = {}
    for shape in MESHES[world]:
        mesh = M.make_train_mesh(*shape, device="cpu")
        for case in mesh_cases(shape):
            res[(shape, case)] = train_case(tmp, case, mesh, moments=True)
        if shape == SHAPES_MESH:
            res["shapes"] = region_shapes(tmp, mesh)
        if shape == COMPRESS_MESH:
            for name, kw in VARIANTS.items():
                res[(shape, name)] = train_case(tmp, "qwen3-4b", mesh, **kw)
            res["adamw"] = adamw_case(mesh)
        res[(shape, "staged")] = mesh.host_staged_bytes
    mesh = M.make_train_mesh(*MESHES[world][-1], device="cpu")
    ck = dict(steps=CKPT_STEPS, ckpt_every=1)
    if world == 4:
        bf16 = M.make_train_mesh(*BF16_MESH, device="cpu")
        res["bf16"] = train_case(tmp, "qwen3-4b", bf16, dtype="bfloat16")
        for case in FAMILIES:
            res[case] = train_case(tmp, case, mesh, steps=1,
                                   moments=case in FAMILY_MOMENTS)
        d = os.path.join(tmp, "ckpt22")
        res["uninterrupted"] = train_case(tmp, CKPT_CASE, mesh, **ck)
        res["failed"] = error_of(lambda: train_case(
            tmp, CKPT_CASE, mesh, ckpt_dir=d, fail_at=CKPT_FAIL, **ck))
        if rank == 0:                     # the step-3 checkpoint, kept
            shutil.copytree(d, os.path.join(tmp, "ckpt_at_3"))
        torch.distributed.barrier()
        res["resumed"] = train_case(tmp, CKPT_CASE, mesh, ckpt_dir=d, **ck)
    else:
        d = os.path.join(tmp, "ckpt12")
        if rank == 0:
            shutil.copytree(os.path.join(tmp, "ckpt_at_3"), d)
        torch.distributed.barrier()
        res["resumed"] = train_case(tmp, CKPT_CASE, mesh, ckpt_dir=d, **ck)
    res["refusals"] = {
        "size_mismatch": error_of(lambda: train_case(
            tmp, "qwen3-4b", M.ShardMesh(("data", "model"),
                                         {"data": world, "model": 2},
                                         mesh.group, rank, mesh.device))),
        "axes": error_of(lambda: train_case(
            tmp, "qwen3-4b", M.make_shard_mesh(world, device="cpu"))),
    }
    return res


# ---------------------------------------------------------------------------
# mamba2's and rwkv6's regions, one layer on (1, 2)
# ---------------------------------------------------------------------------

REGION_ARCHS = {"zamba2": "zamba2-2.7b", "rwkv6": "rwkv6-1.6b"}
REGION_MESH, REGION_ROWS = (1, 2), (2, 16)
HEAD_DECADES = 4      # the heads' input scales span 10^-2 .. 10^2


def _spread_heads(cfg, model, gen):
    """Layer 0's heads read inputs 10^-2 .. 10^2 in scale (mamba2's x
    columns of ``in_proj``, rwkv6's ``wk`` columns), so a norm taken
    over one rank's heads differs from the whole's; the leaves that
    init to constants are drawn off them."""
    import torch
    layer = model.layers[0]
    if cfg.family == "hybrid":
        p, w, h = layer.mixer, layer.mixer.in_proj, cfg.ssm_heads
        cols, fixed = slice(cfg.d_inner, 2 * cfg.d_inner), (
            "a_log", "d_skip", "dt_bias", "norm_scale")
    else:
        p, w, h = layer.tmix, layer.tmix.wk, cfg.d_model // cfg.rwkv_head_dim
        cols, fixed = slice(None), ("w0", "bonus_u", "ln_scale", "mix_r",
                                    "mix_w", "cmix_k", "cmix_r")
    scale = 10.0 ** torch.linspace(-HEAD_DECADES / 2, HEAD_DECADES / 2, h)
    with torch.no_grad():
        w[:, cols] *= scale.repeat_interleave(w[:, cols].shape[1] // h)
        for n in fixed:
            t = getattr(p, n)
            t += 0.1 * torch.randn(t.shape, generator=gen) * t.abs().clamp(
                min=1.0)


def region_case(tmp, case, mesh):
    """One layer of SMOKE ``case`` (fp32) on the rank's heads against the
    whole layer on one device: the output, the input's gradient and every
    leaf's gradient (the rank's blocks gathered); then the placement:
    ``gather_params`` of ``shard_``, and a mesh checkpoint of the
    parameters and random moments (the global leaves on disk, the
    blocks restored), each against the global leaves bit for bit; and
    each rank's ``in_proj`` / ``conv_w`` blocks."""
    import copy

    import torch
    from repro_torch.checkpoint.manager import CheckpointManager, _leaves
    from repro_torch.configs.archs import SMOKE
    from repro_torch.distributed.sharding import (ShardLayout, block, gather,
                                                  leaf_specs)
    from repro_torch.models import model as mdl
    cfg = SMOKE[REGION_ARCHS[case]]
    gen = torch.Generator().manual_seed(7)
    model = mdl.Model(cfg, device="cpu", seed=0)
    _spread_heads(cfg, model, gen)
    layout = ShardLayout(cfg, mesh)
    sharded = layout.shard_(copy.deepcopy(model))
    x = torch.randn(REGION_ROWS + (cfg.d_model,), generator=gen)
    wts = torch.randn(x.shape, generator=gen)
    apply = mdl._mamba_block_apply if cfg.family == "hybrid" \
        else mdl._rwkv_block_apply

    def grads(layer, module):
        xin = x.clone().requires_grad_(True)
        out = apply(layer, cfg, xin)
        names = [n for n, _ in module.named_parameters()]
        g = torch.autograd.grad((out * wts).sum(),
                                [xin] + list(module.parameters()))
        return out.detach(), g[0], dict(zip(names, g[1:]))

    out, gx, g = grads(layout.view(sharded)["layers"][0], sharded.layers[0])
    g = {n: gather(t, layout.specs["layers.0." + n], mesh)
         for n, t in g.items()}
    res = {"region": (out, gx, g), "one": grads(model.layers[0],
                                                 model.layers[0])}
    want = dict(model.named_parameters())
    res["gathered"] = {n: torch.equal(t, want[n]) for n, t in
                       layout.gather_params(sharded).items()}
    moments = {n: torch.randn(p.shape, generator=gen)
               for n, p in want.items()}
    state = {"params": sharded, "opt": {"m": {
        n: block(t, layout.specs[n], mesh).clone()
        for n, t in moments.items()}}}
    names = [n for n, _ in _leaves(state)]
    ck = dict(mesh=mesh, specs=leaf_specs(names, layout.specs))
    mgr = CheckpointManager(os.path.join(tmp, f"region_ckpt_{case}"))
    mgr.save(1, state, **ck)
    torch.distributed.barrier()
    with np.load(os.path.join(mgr.dir, "step_1", "leaves.npz")) as z:
        res["saved"] = {n: np.array_equal(z[n], (
            want[n[len("params."):]] if n.startswith("params.")
            else moments[n[len("opt.m."):]]).detach().numpy())
            for n in z.files}
    blocks = {n: t.detach().clone() for n, t in _leaves(state)}
    with torch.no_grad():
        for _, t in _leaves(state):
            t.zero_()
    mgr.restore(state, **ck)
    res["restored"] = {n: torch.equal(t, blocks[n])
                       for n, t in _leaves(state)}
    res["cols"] = {}            # the global columns of the rank's block
    for n in ("in_proj", "conv_w") if cfg.family == "hybrid" else ():
        shape = want["layers.0.mixer." + n].shape
        cols = torch.arange(shape[-1], dtype=torch.float32).expand(shape)
        res["cols"][n] = block(cols, layout.specs["layers.0.mixer." + n],
                               mesh)[0]
    res["specs"] = {n: (tuple(s), type(s).__name__)
                    for n, s in layout.specs.items()}
    res["counts"] = layout.counts()
    return res


def main_regions(rank, tmp):
    """``regions RANK TMP``: rank RANK of the 2-rank world at
    TMP/store_regions; rank 0 writes TMP/regions.pt with both ranks'
    ``region_case`` results."""
    import torch_threads  # noqa: F401  (one intra-op thread)
    import torch
    from repro_torch.launch import mesh as M
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp}/store_regions", rank=rank,
        world_size=2)
    try:
        mesh = M.make_train_mesh(*REGION_MESH, device="cpu")
        res = {case: region_case(tmp, case, mesh) for case in REGION_ARCHS}
        parts = [None, None]
        torch.distributed.all_gather_object(parts, res)
        if rank == 0:
            torch.save(parts, os.path.join(tmp, "regions.pt"))
    finally:
        torch.distributed.destroy_process_group()


# (arch in SMOKE, step kind, batch, seq): the dry run's cells at SMOKE
# width on a (1, 2) mesh; qwen3-4b on the SATA kernel route
# (``launch.dryrun.main_path_cfg``: 128-blocks, so seq 256, whose 128
# query rows a rank keeps under context parallelism tile too)
COLLECTIVE_CASES = {
    "qwen3-4b-train": ("qwen3-4b", "train", 2, 256),
    "qwen3-4b-prefill": ("qwen3-4b", "prefill", 2, 256),
    "qwen3-moe-train": ("qwen3-moe-235b-a22b", "train", 2, 32),
}


def collective_cfg(arch):
    from repro_torch.configs.archs import SMOKE
    from repro_torch.launch.dryrun import main_path_cfg
    return main_path_cfg(SMOKE[arch])


def main_collectives(rank, tmp):
    """``collectives RANK TMP``: every case's step on a real gloo world of
    2 ranks on (1, 2), CPU tensors; rank 0 writes the bytes by kind."""
    import itertools

    import torch_threads  # noqa: F401  (one intra-op thread)
    import torch
    from repro_torch.distributed import ctx
    from repro_torch.launch import mesh as M
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import (init_train_state, make_prefill_step,
                                        make_train_step)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp}/store_collectives", rank=rank,
        world_size=2)
    try:
        res = {False: {}, True: {}}
        for (case, (arch, kind, b, s)), cp in itertools.product(
                COLLECTIVE_CASES.items(), res):
            cfg = collective_cfg(arch)
            mesh = M.make_train_mesh(1, 2, device="cpu")
            gen = torch.Generator().manual_seed(0)
            tok = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                dtype=torch.int32)
            state = init_train_state(cfg, OptConfig(), device="cpu",
                                     mesh=mesh)
            ctx.set_activation_shardings(ctx.make_activation_shardings(
                mesh, cfg, seq_shard=True), mesh=mesh)
            ctx.set_context_parallel(cp)
            try:
                if kind == "train":
                    make_train_step(cfg, OptConfig(), mesh=mesh)(
                        state, {"tokens": tok, "labels": tok})
                else:
                    make_prefill_step(cfg, mesh=mesh)(state["params"],
                                                      {"tokens": tok})
            finally:
                ctx.set_context_parallel(False)
                ctx.clear()
            res[cp][case] = dict(mesh.collective_bytes)
        if rank == 0:
            torch.save(res, os.path.join(tmp, "collectives.pt"))
    finally:
        torch.distributed.destroy_process_group()


def main_rank(rank, world, tmp):
    import torch_threads  # noqa: F401  (one intra-op thread)
    import torch
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp}/store{world}", rank=rank,
        world_size=world)
    try:
        res = run_world(rank, world, tmp)
        if rank == 0:
            torch.save(res, os.path.join(tmp, f"world{world}.pt"))
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def reference_jobs(part, parts):
    """Part ``part`` of the (mesh shape, case) pairs the reference trains,
    split over ``parts`` processes by their count of ``train`` calls
    (the longest first, each to the least loaded part)."""
    jobs = [(shape, case) for shapes in MESHES.values() for shape in shapes
            for case in mesh_cases(shape)]
    calls = {job: STEPS if job[1] in REF_STEPWISE else 1 for job in jobs}
    load, out = [0] * parts, [[] for _ in range(parts)]
    for job in sorted(jobs, key=lambda j: -calls[j]):
        i = load.index(min(load))
        out[i].append(job)
        load[i] += calls[job]
    return out[part]


def main_reference(tmp, part, parts):
    import jax
    from repro.checkpoint.manager import CheckpointManager
    from repro.configs import archs as jarchs
    from repro.launch.mesh import _mesh_kwargs
    from repro.launch.train import train
    from repro.models.config import SataKernelConfig
    out = {}
    for case in ROWS:
        jarchs.SMOKE[case] = case_cfg(jarchs.SMOKE, case, SataKernelConfig)
    for shape, case in reference_jobs(part, parts):
        mesh = jax.make_mesh(shape, ("data", "model"), **_mesh_kwargs(2))
        key = f"{shape[0]}x{shape[1]}/{case}"
        d = os.path.join(tmp, "refm1", key)
        losses, gnorms = [], []
        for steps in ((STEPS,) if case not in REF_STEPWISE
                      else range(1, STEPS + 1)):
            r = train(case, smoke=True, steps=steps, batch=BATCH,
                      seq=ROWS[case][1], mesh=mesh, log_every=100, seed=0,
                      ckpt_dir=d, ckpt_every=1)
            losses += r["losses"]
            gnorms += r["gnorms"]
        out[key + "/losses"] = np.asarray(losses)
        out[key + "/gnorms"] = np.asarray(gnorms)
        for n, a in flat(r["final_state"]["params"]).items():
            out[f"{key}/params/{n}"] = a
        m1 = CheckpointManager(d).restore(r["final_state"], step=1)
        for n, a in flat(m1["opt"]["m"]).items():
            out[f"{key}/m1/{n}"] = a
    np.savez(os.path.join(tmp, f"reference{part}.npz"), **out)


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        main_reference(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    elif sys.argv[1] == "regions":
        main_regions(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1] == "collectives":
        main_collectives(int(sys.argv[2]), sys.argv[3])
    else:
        main_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
