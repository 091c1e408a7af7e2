"""Training loop — port of ``repro.launch.train``: the fault-tolerant
loop on one device.

  * checkpoint/restart (atomic, keep-k, async save cadence);
  * step-time watchdog (straggler logging);
  * failure injection (``fail_at``): the loop raises at that step and a
    second call with the same ``ckpt_dir`` resumes from the latest
    checkpoint with identical training state;
  * gradient accumulation (``micro_steps``) and int8 gradient
    compression.

The loop runs eagerly on ``device`` (default ``"cuda"``; the CPU only
when asked).  Mesh and sharding set-up and elastic restore wait for
slice 5 of the port.

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

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.archs import ARCHS, SMOKE
from repro_torch.data.pipeline import SyntheticLM
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
    ``model`` overrides the ``DenseModel`` built from ``seed`` (its
    parameters are trained in place).  Returns per-step ``losses``,
    ``gnorms`` and ``step_s`` (host seconds per step, synchronized),
    the ``final_state`` and the straggler count."""
    if mesh is not None:
        raise NotImplementedError(
            "train(mesh=...): mesh and sharding set-up are slice 5 of the "
            "PyTorch port")
    cfg = cfg or (SMOKE if smoke else ARCHS)[arch]
    dev = resolve_device(device)
    opt = OptConfig(warmup_steps=max(2, steps // 10), decay_steps=steps,
                    compress_grads=compress_grads)
    state = init_train_state(cfg, opt, seed=seed, device=dev, model=model)
    pipe = SyntheticLM(cfg, batch, seq, seed=seed)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        mgr.restore(state)
        man = mgr.manifest()
        pipe.restore_state(man["extra"]["pipeline"])
        start_step = man["step"]
        print(f"[train] resumed from step {start_step}", flush=True)

    step_fn = make_train_step(cfg, opt, micro_steps=micro_steps)
    wd = Watchdog()
    losses, gnorms, step_s = [], [], []
    for step in range(start_step, steps):
        if fail_at is not None and step == fail_at:
            if mgr is not None:
                # the simulated crash kills the compute process; a save
                # already in flight still lands
                mgr.wait()
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
                     blocking=False)
    if mgr is not None:
        mgr.save(steps, state, extra={"pipeline": pipe.save_state()})
        mgr.wait()
    return {"losses": losses, "gnorms": gnorms, "step_s": step_s,
            "final_state": state, "stragglers": wd.flagged}


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
