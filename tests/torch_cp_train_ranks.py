"""The ranks of ``tests/test_torch_cp_train.py`` and the reference's
context-parallel steps.

    python tests/torch_cp_train_ranks.py RANK WORLD TMP

joins a gloo world through the ``FileStore`` at TMP/store<WORLD>, runs
:func:`run_world` with context parallelism on (the port's switch,
``distributed.ctx.set_context_parallel`` under the ``seq_shard``
activation specs) and has rank 0 write TMP/world<WORLD>.pt
(``torch.save``).  World 2 runs every case of :data:`CASES` on (1, 2),
world 4 the (2, 2) and (1, 4) cases.  Each case first runs
``make_prefill_step(mesh=)`` on the reference's weights
(TMP/<case>.npz, ``torch_mesh_train_ranks.write_weights``) and a
prefill batch, then ``train(mesh=)`` for ``torch_mesh_train_ranks.STEPS``
steps from them.

    python tests/torch_cp_train_ranks.py reference TMP PART PARTS

runs the reference's jitted ``make_prefill_step`` and ``make_train_step``
on part PART of PARTS of the (mesh, case) pairs, on a forced-device
mesh with ``AxisType.Auto`` axes, under
``set_activation_shardings(make_activation_shardings(mesh, cfg,
seq_shard=True))`` and ``set_context_parallel(True)``, as its dry run
sets them for train and prefill cells, and writes
TMP/reference<PART>.npz: the prefill logits, each step's loss and grad
norm, the final parameters and the first AdamW moment after step 1.
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` must be set
before jax starts.
"""
import os
import sys

import numpy as np

import torch_mesh_train_ranks as R

# (mesh shape, case of ``torch_mesh_train_ranks.ROWS``): SMOKE qwen3-4b
# on ``_attend`` and its GQA config on the SATA kernel route (4 query
# over 2 KV heads: on (1, 4) the KV heads do not divide "model") on every
# mesh, that GQA config on ``_attend`` too on (1, 4); the other families
# on (1, 2), with whisper's encoder also at 9
# frames (held whole on each rank, its layers without a region) and
# qwen3-moe also at 3 experts (no expert region: the whole sequence
# routed on every rank)
MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
CASES = {(1, 2): ("qwen3-4b", "gqa-kernel", "qwen3-moe", "zamba2", "rwkv6",
                  "vlm", "audio", "audio9", "moe3"),
         (2, 2): ("qwen3-4b", "gqa-kernel"),
         (1, 4): ("qwen3-4b", "gqa", "gqa-kernel")}
PREFILL_SEED = 1       # the prefill batch: SyntheticLM's, another seed


def prefill_batch(synthetic_lm, cfg, case):
    """The prefill inputs of ``case`` from a package's ``SyntheticLM``
    (both draw the same): a training batch without its labels."""
    b = synthetic_lm(cfg, R.BATCH, R.ROWS[case][1],
                     seed=PREFILL_SEED).next_batch()
    return {k: a for k, a in b.items() if k not in ("labels", "loss_mask")}


def port_case(tmp, case, mesh):
    """``train_case``'s run of ``case`` on ``mesh`` (None: one device),
    then the prefill logits from the reference's weights; the (query
    rows, keys) of every B3 call (the kernel route's, on the CPU its
    plain version), and each call's admitted-key count per row, the whole
    (B·H, S) gathered from the ranks."""
    import torch
    from repro_torch.configs.archs import SMOKE
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import ShardLayout
    from repro_torch.kernels import ops
    from repro_torch.models.config import SataKernelConfig
    from repro_torch.train.step import make_prefill_step
    cfg = R.case_cfg(SMOKE, case, SataKernelConfig)
    model = R.port_model(tmp, case, cfg)
    if mesh is not None:
        ShardLayout(cfg, mesh).shard_(model)
    batch = {k: torch.from_numpy(a) for k, a in
             prefill_batch(SyntheticLM, cfg, case).items()}
    step = make_prefill_step(cfg, mesh=mesh)
    seen, counts, run = set(), [], ops._block_attention_compact

    def b3(q, k, *args, **kw):
        seen.add((q.shape[1], k.shape[1]))
        counts.append(torch.zeros(q.shape[:2], dtype=torch.int32))
        return run(q, k, *args, admitted=counts[-1], **kw)

    ops._block_attention_compact = b3
    try:
        res = R.train_case(tmp, case, mesh, moments=True)
        res["prefill"] = step(model, batch)
    finally:
        ops._block_attention_compact = run
    res["b3_rows"] = sorted(seen)
    res["admitted"] = counts if mesh is None else \
        gather_counts(counts, mesh)
    if mesh is not None:
        res["cp"] = step.layout.seq is not None
        res["counts"] = step.layout.counts()
    return res


def gather_counts(counts, mesh):
    """The ranks' admitted-key counts (B_rank·H, S / m) of each B3 call
    assembled into the global (B·H, S), every rank's block at its data
    rows and query rows (collective)."""
    import torch
    parts = [None] * mesh.size
    torch.distributed.all_gather_object(
        parts, (mesh.coord("data"), mesh.coord("model"), counts))
    out = []
    for i, c in enumerate(counts):
        bh, sq = c.shape
        whole = torch.zeros((bh * mesh.shape["data"],
                             sq * mesh.shape["model"]), dtype=c.dtype)
        for d, r, cs in parts:
            whole[d * bh:(d + 1) * bh, r * sq:(r + 1) * sq] = cs[i]
        out.append(whole)
    return out


def run_world(world, tmp):
    from repro_torch.distributed import ctx
    from repro_torch.launch import mesh as M
    from repro_torch.configs.archs import SMOKE
    from repro_torch.models.config import SataKernelConfig
    res = {}
    for shape in MESHES[world]:
        mesh = M.make_train_mesh(*shape, device="cpu")
        for case in CASES[shape]:
            cfg = R.case_cfg(SMOKE, case, SataKernelConfig)
            ctx.set_activation_shardings(ctx.make_activation_shardings(
                mesh, cfg, seq_shard=True), mesh=mesh)
            ctx.set_context_parallel(True)
            try:
                res[(shape, case)] = port_case(tmp, case, mesh)
            finally:
                ctx.set_context_parallel(False)
                ctx.clear()
    return res


def main_rank(rank, world, tmp):
    import torch_threads  # noqa: F401  (one intra-op thread)
    import torch
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp}/store{world}", rank=rank,
        world_size=world)
    try:
        res = run_world(world, tmp)
        if rank == 0:
            torch.save(res, os.path.join(tmp, f"world{world}.pt"))
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def reference_jobs(part, parts):
    """Part ``part`` of the (mesh shape, case) pairs, dealt in turn."""
    jobs = [(shape, case) for shapes in MESHES.values() for shape in shapes
            for case in CASES[shape]]
    return jobs[part::parts]


def reference_case(shape, case):
    """The reference's context-parallel prefill and ``STEPS`` train
    steps of ``case`` on a ``shape`` mesh, from ``init_params``' seed-0
    weights (``write_weights``'), with ``train``'s AdamW and batches."""
    import jax
    from repro.configs import archs as jarchs
    from repro.data.pipeline import SyntheticLM
    from repro.distributed import ctx as dctx
    from repro.distributed.sharding import (batch_specs, param_specs,
                                            to_shardings)
    from repro.launch.mesh import _mesh_kwargs, activate_mesh
    from repro.models.config import SataKernelConfig
    from repro.optim.adamw import OptConfig
    from repro.train.step import (init_train_state, make_prefill_step,
                                  make_train_step)
    cfg = R.case_cfg(jarchs.SMOKE, case, SataKernelConfig)
    seq = R.ROWS[case][1]
    mesh = jax.make_mesh(shape, ("data", "model"), **_mesh_kwargs(2))
    dctx.set_activation_shardings(
        dctx.make_activation_shardings(mesh, cfg, seq_shard=True), mesh=mesh)
    dctx.set_context_parallel(True)
    opt = OptConfig(warmup_steps=max(2, R.STEPS // 10), decay_steps=R.STEPS)
    state = init_train_state(jax.random.PRNGKey(0), cfg, opt)
    specs = lambda tree: param_specs(tree, cfg, mesh)  # noqa: E731
    st_sh = to_shardings({
        "params": specs(state["params"]),
        "opt": {"m": specs(state["opt"]["m"]), "v": specs(state["opt"]["v"]),
                "step": jax.sharding.PartitionSpec()}}, mesh)
    state = jax.device_put(state, st_sh)
    out = {}
    key = f"{shape[0]}x{shape[1]}/{case}"
    pb = {k: np.asarray(a) for k, a in
          prefill_batch(SyntheticLM, cfg, case).items()}
    pb_sh = to_shardings(batch_specs(pb, mesh), mesh)
    pipe = SyntheticLM(cfg, R.BATCH, seq, seed=0)
    b0 = pipe.next_batch()
    b_sh = to_shardings(batch_specs(b0, mesh), mesh)
    prefill = jax.jit(make_prefill_step(cfg),
                      in_shardings=(st_sh["params"], pb_sh))
    step = jax.jit(make_train_step(cfg, opt), in_shardings=(st_sh, b_sh),
                   out_shardings=(st_sh, None), donate_argnums=(0,))
    losses, gnorms = [], []
    with activate_mesh(mesh):
        out[key + "/prefill"] = np.asarray(prefill(
            state["params"], jax.device_put(pb, pb_sh)))
        batch = b0
        for i in range(R.STEPS):
            state, metrics = step(state, jax.device_put(batch, b_sh))
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
            if i == 0:
                for n, a in R.flat(state["opt"]["m"]).items():
                    out[f"{key}/m1/{n}"] = a
            batch = pipe.next_batch()
    dctx.set_context_parallel(False)
    dctx.clear()
    out[key + "/losses"] = np.asarray(losses)
    out[key + "/gnorms"] = np.asarray(gnorms)
    for n, a in R.flat(state["params"]).items():
        out[f"{key}/params/{n}"] = a
    return out


def main_reference(tmp, part, parts):
    out = {}
    for shape, case in reference_jobs(part, parts):
        out.update(reference_case(shape, case))
    np.savez(os.path.join(tmp, f"reference{part}.npz"), **out)


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        main_reference(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        main_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
