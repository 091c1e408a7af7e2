"""Training loop — port of ``repro.launch.train``: the fault-tolerant
loop, on one device or on the ranks of a ("data", "model") mesh.

  * checkpoint/restart (atomic, keep-k, async save cadence);
  * step-time watchdog (straggler logging);
  * failure injection (``fail_at``): the loop raises at that step and a
    second call with the same ``ckpt_dir`` resumes from the latest
    checkpoint with identical training state;
  * elastic restore: a checkpoint holds global leaves, so a run may
    resume on another mesh (or on one device);
  * gradient accumulation (``micro_steps``) and int8 gradient
    compression.

The loop runs eagerly on a mesh: by default the one-rank
``make_local_mesh(device=device)`` (``"cuda"``; the CPU only when
asked), as the reference's.  With a larger ``mesh=``
(``launch.mesh.make_train_mesh`` over an initialised
``torch.distributed`` world) every rank runs this function
with the same arguments: the same seed and pipeline, of whose batches
it takes its rows; the state is sharded by ``distributed.sharding``'s
train specs (FSDP over the data axes, tensor parallelism over
"model") and the rank computes on the mesh's device.

Usage (one GPU, reduced arch):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --smoke --steps 20 --ckpt-dir /path/to/ckpt
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager, _leaves
from repro_torch.configs.archs import ARCHS, SMOKE
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed.sharding import leaf_specs
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.step import init_train_state, make_train_step


class Watchdog:
    """Step-time straggler detector: flags steps slower than
    ``factor``× the running median, logs and counts them."""

    def __init__(self, factor: float = 3.0):
        self.times, self.factor, self.flagged = [], factor, 0

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) < 5:
            return False
        med = float(np.median(self.times[-50:]))
        if dt > self.factor * med:
            self.flagged += 1
            print(f"[watchdog] straggler step: {dt:.3f}s vs median "
                  f"{med:.3f}s", flush=True)
            return True
        return False


def train(arch: str, smoke: bool = True, steps: int = 20,
          batch: int = 8, seq: int = 32, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 10, fail_at: Optional[int] = None,
          micro_steps: int = 1, compress_grads: bool = False,
          mesh=None, log_every: int = 5, seed: int = 0, *, cfg=None,
          model=None, device="cuda") -> Dict[str, Any]:
    """Train ``steps`` steps of next-token loss on ``SyntheticLM``
    batches.  ``cfg`` overrides ``(SMOKE if smoke else ARCHS)[arch]``;
    ``model`` overrides the ``Model`` built from ``seed`` (its
    parameters are trained in place).  Returns per-step ``losses``,
    ``gnorms`` and ``step_s`` (host seconds per step, synchronized),
    the ``final_state`` and the straggler count.  ``mesh``: default the
    one-rank ``launch.mesh.make_local_mesh(device=device)``, as the
    reference's; a mesh names "data" and "model" axes and the run
    computes on its device; one of more than one rank must span the
    initialised world (``make_train_mesh``), and then ``final_state``
    holds the rank's blocks (``ShardLayout.gather_params`` gathers
    them)."""
    cfg = cfg or (SMOKE if smoke else ARCHS)[arch]
    mesh = make_local_mesh(device=device) if mesh is None else mesh
    _check_mesh(mesh)
    dev = mesh.device
    opt = OptConfig(warmup_steps=max(2, steps // 10), decay_steps=steps,
                    compress_grads=compress_grads)
    state = init_train_state(cfg, opt, seed=seed, device=dev, model=model,
                             mesh=mesh)
    pipe = SyntheticLM(cfg, batch, seq, seed=seed)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    step_fn = make_train_step(cfg, opt, micro_steps=micro_steps, mesh=mesh)
    ck = {"mesh": mesh, "specs": leaf_specs(
        [n for n, _ in _leaves(state)], step_fn.layout.specs)}
    if mgr is not None:
        _barrier(mesh)                # rank 0's last save has landed
    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        mgr.restore(state, **ck)
        man = mgr.manifest()
        pipe.restore_state(man["extra"]["pipeline"])
        start_step = man["step"]
        print(f"[train] resumed from step {start_step}", flush=True)

    wd = Watchdog()
    losses, gnorms, step_s = [], [], []
    for step in range(start_step, steps):
        if fail_at is not None and step == fail_at:
            if mgr is not None:
                # the simulated crash kills the compute process; a save
                # already in flight still lands
                mgr.wait()
                _barrier(mesh)
            raise RuntimeError(f"injected failure at step {step}")
        t0 = time.time()
        db = {k: torch.from_numpy(a).to(dev)
              for k, a in pipe.next_batch().items()}
        state, metrics = step_fn(state, db)
        loss = float(metrics["loss"])              # synchronizes the device
        gnorm = float(metrics["grad_norm"])
        dt = time.time() - t0
        losses.append(loss)
        gnorms.append(gnorm)
        step_s.append(dt)
        wd.observe(dt)
        if step % log_every == 0:
            print(f"[train] step {step} loss {loss:.4f} gnorm {gnorm:.3f}",
                  flush=True)
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, state, extra={"pipeline": pipe.save_state()},
                     blocking=False, **ck)
    if mgr is not None:
        mgr.save(steps, state, extra={"pipeline": pipe.save_state()}, **ck)
        mgr.wait()
        _barrier(mesh)
    return {"losses": losses, "gnorms": gnorms, "step_s": step_s,
            "final_state": state, "stragglers": wd.flagged}


def _check_mesh(mesh) -> None:
    """The mesh must have the reference's ("data", "model") or ("pod",
    "data", "model") axes, and one of more than one rank must span the
    initialised world."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
    if mesh.size > 1 and mesh.size != world:
        raise ValueError(
            f"train(mesh=...): the mesh has {mesh.size} ranks, the world "
            f"{world} — start one process per rank with "
            f"torch.distributed.init_process_group(world_size="
            f"{mesh.size}) and build the mesh with make_train_mesh")
    if tuple(mesh.axis_names) not in (("data", "model"),
                                      ("pod", "data", "model")):
        raise ValueError(
            f"train(mesh=...) needs ('data', 'model') or ('pod', 'data', "
            f"'model') axes, got {tuple(mesh.axis_names)}")


def _barrier(mesh) -> None:
    """Wait for every rank of the mesh (nothing on a one-rank mesh)."""
    import torch.distributed as dist
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--micro-steps", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = train(args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, fail_at=args.fail_at,
                micro_steps=args.micro_steps,
                compress_grads=args.compress_grads, device=args.device)
    print(f"[train] done: first loss {out['losses'][0]:.4f} → "
          f"last {out['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()
