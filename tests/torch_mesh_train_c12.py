"""ROADMAP queue C entry 12, measured: where the kernel-route case
("gqa-kernel" of ``torch_mesh_train_ranks``) trained 3 steps on the
(2, 2) mesh differs most from the reference's ``train`` on the same mesh,
the three legs of that gap and the first AdamW update there.

    PYTHONPATH=src python tests/torch_mesh_train_c12.py

trains the case four times from the reference's seed-0 weights: the port
on one device and on a 4-rank gloo (2, 2) world (``FileStore`` in a temp
directory), the reference on one device and on a forced 4-device (2, 2)
mesh (each a subprocess of this script; the reference's steps are its
``train``'s, jitted with the same shardings, returning the gradient of
``layers.attn.wq`` too).  It prints, at the element of ``layers.attn.wq``
where the two (2, 2) runs differ most: each run's final value and step
gradients, the legs (port (2, 2) vs port one device, port vs reference on
one device, reference one device vs (2, 2)), each run's clipped first
gradient against AdamW's eps, and how much of each pair's gap their
first updates ``lr · g / (|g| + eps)`` account for.  A minute on 8
cores."""
import os
import subprocess
import sys
import tempfile

import numpy as np

import torch_mesh_train_ranks as R

CASE, LEAF, STEPS = "gqa-kernel", "attn.wq", R.STEPS


def _stack(per_layer):
    return np.stack([per_layer[i] for i in sorted(per_layer)])


def port(tmp, rank, world):
    """The port's run: final ``layers.<i>.attn.wq`` and each step's
    gradient of it (gathered) and grad norm."""
    import torch_threads  # noqa: F401  (one intra-op thread)
    import torch
    import repro_torch.train.step as step
    from repro_torch.distributed.sharding import gather
    mesh = None
    if world > 1:
        torch.distributed.init_process_group(
            "gloo", init_method=f"file://{tmp}/store", rank=rank,
            world_size=world)
        from repro_torch.launch.mesh import make_train_mesh
        mesh = make_train_mesh(2, 2, device="cpu")
    grads, update = [], step.adamw_update

    def recording(opt, params, g, state, err=None, *, mesh=None, specs=None):
        got = {}
        for n in params:
            if n.endswith(LEAF):
                x = g[n].float()
                got[int(n.split(".")[1])] = (
                    gather(x, specs[n], mesh) if mesh is not None
                    else x).numpy().copy()
        grads.append(_stack(got))
        return update(opt, params, g, state, err, mesh=mesh, specs=specs)

    step.adamw_update = recording
    try:
        res = R.train_case(tmp, CASE, mesh)
    finally:
        step.adamw_update = update
    if rank == 0:
        final = _stack({int(n.split(".")[1]): p.numpy() for n, p in
                        res["params"].items() if n.endswith(LEAF)})
        np.savez(os.path.join(tmp, f"port{world}.npz"), final=final,
                 grads=np.stack(grads), gnorms=np.asarray(res["gnorms"]))
    if world > 1:
        torch.distributed.destroy_process_group()


def reference(tmp):
    """The reference's runs on one device and on (2, 2): its ``train``'s
    loop and shardings, the step also returning the leaf's gradient."""
    import jax
    from repro.configs import archs as jarchs
    from repro.data.pipeline import SyntheticLM
    from repro.distributed import ctx as dctx
    from repro.distributed.sharding import (batch_specs, param_specs,
                                            to_shardings)
    from repro.launch.mesh import _mesh_kwargs, activate_mesh, \
        make_local_mesh
    from repro.models import model as mdl
    from repro.models.config import SataKernelConfig
    from repro.optim.adamw import OptConfig, adamw_update
    from repro.train.step import init_train_state
    cfg = R.case_cfg(jarchs.SMOKE, CASE, SataKernelConfig)
    opt = OptConfig(warmup_steps=max(2, STEPS // 10), decay_steps=STEPS)
    grad_fn = jax.value_and_grad(lambda p, b: mdl.loss_fn(p, cfg, b),
                                 has_aux=True)

    def step_fn(state, batch):
        (_, _), g = grad_fn(state["params"], batch)
        p, o, _, om = adamw_update(opt, state["params"], g, state["opt"],
                                   None)
        return {"params": p, "opt": o}, (om["grad_norm"],
                                         g["layers"]["attn"]["wq"])

    for world, mesh in ((1, make_local_mesh()), (4, jax.make_mesh(
            (2, 2), ("data", "model"), **_mesh_kwargs(2)))):
        dctx.set_activation_shardings(
            dctx.make_activation_shardings(mesh, cfg), mesh=mesh)
        state = init_train_state(jax.random.PRNGKey(0), cfg, opt)
        spec = param_specs(state["params"], cfg, mesh)
        st_sh = to_shardings({"params": spec, "opt": {
            "m": spec, "v": spec, "step": jax.sharding.PartitionSpec()}},
            mesh)
        state = jax.device_put(state, st_sh)
        pipe = SyntheticLM(cfg, R.BATCH, R.ROWS[CASE][1], seed=0)
        b_sh = to_shardings(batch_specs(
            jax.eval_shape(pipe.next_batch), mesh), mesh)
        pipe.restore_state({"seed": 0, "step": 0})
        jitted = jax.jit(step_fn, in_shardings=(st_sh, b_sh))
        grads, gnorms = [], []
        with activate_mesh(mesh):
            for _ in range(STEPS):
                state, (gn, g) = jitted(
                    state, jax.device_put(pipe.next_batch(), b_sh))
                grads.append(np.asarray(g))
                gnorms.append(float(gn))
        dctx.clear()
        np.savez(os.path.join(tmp, f"ref{world}.npz"),
                 final=np.asarray(state["params"]["layers"]["attn"]["wq"]),
                 grads=np.stack(grads), gnorms=np.asarray(gnorms))


def first_step(g):
    """AdamW's first normalised step ``g / (|g| + eps)`` (m̂ = g,
    v̂ = g²)."""
    from repro_torch.optim.adamw import OptConfig
    return g / (abs(g) + OptConfig.eps)


def report(tmp):
    import torch
    from repro_torch.optim.adamw import OptConfig, lr_at
    lr1 = float(lr_at(OptConfig(warmup_steps=max(2, STEPS // 10),
                                decay_steps=STEPS), torch.tensor(1)))
    runs = {}
    for name in ("port1", "port4", "ref1", "ref4"):
        with np.load(os.path.join(tmp, f"{name}.npz")) as z:
            runs[name] = {k: z[k] for k in z.files}
    gap = np.abs(runs["port4"]["final"] - runs["ref4"]["final"])
    idx = np.unravel_index(gap.argmax(), gap.shape)
    print(f"element (layer, row, column) {tuple(int(i) for i in idx)} of "
          f"{LEAF}; elements past 1e-5: {int((gap > 1e-5).sum())} of "
          f"{gap.size}")
    n = {}
    for name, r in runs.items():
        g = [float(x[idx]) for x in r["grads"]]
        clipped = g[0] * min(1.0, 1.0 / (float(r["gnorms"][0]) + 1e-9))
        n[name] = first_step(clipped)
        spread = np.abs(r["grads"][0]).mean()
        print(f"{name}: final {float(r['final'][idx]):.9g}; step "
              f"gradients {[f'{x:.4e}' for x in g]} (leaf mean |g| at "
              f"step 0 {spread:.3e}); clipped first gradient "
              f"{clipped:.4e} (AdamW eps {OptConfig.eps:g}); first step "
              f"g / (|g| + eps) {n[name]:.6f}")
    for a, b in (("port4", "ref4"), ("port4", "port1"), ("port1", "ref1"),
                 ("ref1", "ref4")):
        d = float(runs[a]["final"][idx] - runs[b]["final"][idx])
        first = -lr1 * (n[a] - n[b])
        dg = np.abs(runs[a]["grads"][0] - runs[b]["grads"][0])
        print(f"{a} - {b}: gap {d:.4e}; first updates' difference "
              f"{first:.4e} (lr {lr1:g}); the rest {d - first:.3e}; "
              f"step-0 gradient gap there {float(dg[idx]):.3e}, the "
              f"leaf's largest {dg.max():.3e}")


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, here, os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        import jax
        from repro.configs import archs as jarchs
        from repro.models import model as jmodel
        from repro.models.config import SataKernelConfig
        cfg = R.case_cfg(jarchs.SMOKE, CASE, SataKernelConfig)
        np.savez(os.path.join(tmp, f"{CASE}.npz"), **R.flat(
            jmodel.init_params(jax.random.PRNGKey(0), cfg)))
        me = [sys.executable, os.path.abspath(__file__)]
        procs = [subprocess.Popen(me + ["reference", tmp], env=dict(
            env, XLA_FLAGS="--xla_force_host_platform_device_count=4"))]
        procs += [subprocess.Popen(me + ["port", tmp, str(r), "4"], env=env)
                  for r in range(4)]
        procs.append(subprocess.Popen(me + ["port", tmp, "0", "1"], env=env))
        if any(p.wait() for p in procs):
            raise SystemExit("a run failed")
        report(tmp)


if __name__ == "__main__":
    if sys.argv[1:2] == ["reference"]:
        reference(sys.argv[2])
    elif sys.argv[1:2] == ["port"]:
        port(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        main()
