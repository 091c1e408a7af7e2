"""Checkpointing — port of ``repro.checkpoint.manager``: atomic,
keep-last-k, async.

Layout: ``<dir>/step_<N>/leaves.npz`` + ``manifest.json``.
  * atomic: written to ``step_<N>.tmp`` then ``os.replace``'d — a crash
    mid-save never corrupts the latest checkpoint;
  * keep-k GC after every successful save;
  * async: the device → host copy happens at ``save`` time, the file
    write runs on a background thread.  Every snapshot owns its copy:
    the train loop updates parameters and moments in place right after
    ``save`` returns, so a snapshot holding views would write whatever
    the next step left there.

A state is a nested dict whose leaves are tensors or ``nn.Module``s
(saved through their ``state_dict``).  bf16 tensors are stored as fp32
(exact) and cast back on restore, which copies into the live state's
tensors in place.

Sharded states (``train(mesh=)``): in ``save(..., mesh=, specs=)``
every rank joins the gather of each leaf to its global value and only
the mesh's rank 0 copies it to the host and writes, so a checkpoint is
the same files whatever mesh wrote it;
``restore(..., mesh=, specs=)`` copies each rank's block of every global
leaf into its sharded state.  Saving on one mesh and restoring on
another (or on one device) is the reference's elastic restore.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.distributed.sharding import block, gather


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) pairs of a nested state, in insertion order."""
    if isinstance(tree, nn.Module):
        for name, t in tree.state_dict().items():
            yield prefix + name, t
    elif isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, f"{prefix}{key}.")
    elif isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree
    else:
        raise TypeError(f"checkpoint leaf {prefix[:-1]!r} is a "
                        f"{type(tree).__name__}, not a tensor or module")


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """An owning host copy (bf16 widened to fp32, exactly)."""
    dt = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to(device="cpu", dtype=dt, copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any, extra: Optional[Dict] = None,
             blocking: bool = True,
             meta_blob: Optional[bytes] = None, *, mesh=None,
             specs: Optional[Dict] = None) -> None:
        """Snapshot ``state`` now (owning host copies) and write it as
        ``step_<step>``, on a background thread unless ``blocking``.
        ``extra`` (JSON) goes into the manifest; ``meta_blob``, opaque
        host bytes (the serve loop's pickled control state), is written
        atomically beside the leaves as ``meta.bin`` (``load_meta``).
        With a ``mesh`` ``state`` holds the rank's blocks (``specs`` per
        leaf name): every rank must call ``save`` (it gathers), and only
        rank 0 writes."""
        self.wait()                                   # one in flight max
        writes = mesh is None or mesh.index == 0
        host = {}
        for name, t in _leaves(state):
            if mesh is not None:
                t = gather(t, specs[name], mesh)      # every rank joins
            if writes:
                host[name] = _host_copy(t)
        if not writes:
            return

        def _write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "leaves.npz", **host)
            manifest = {"step": step, "n_leaves": len(host),
                        "leaves": list(host), "extra": extra or {}}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if meta_blob is not None:
                (tmp / "meta.bin").write_bytes(meta_blob)
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, like: Any, step: Optional[int] = None, *, mesh=None,
                specs: Optional[Dict] = None) -> Any:
        """Copy the checkpoint at ``step`` (default: the latest) into the
        tensors of ``like``, in place, and return ``like``.  Raises if
        the leaf names differ.  With a ``mesh`` ``like`` holds the
        rank's blocks (``specs`` per leaf name): each takes its block of
        the saved global leaf."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        with np.load(self.dir / f"step_{step}" / "leaves.npz") as data:
            leaves = list(_leaves(like))
            names = [n for n, _ in leaves]
            if sorted(names) != sorted(data.files):
                raise ValueError(
                    f"checkpoint leaves differ: missing "
                    f"{sorted(set(names) - set(data.files))}, unexpected "
                    f"{sorted(set(data.files) - set(names))}")
            for name, t in leaves:
                full = torch.from_numpy(data[name])
                if mesh is not None:
                    full = block(full, specs[name], mesh)
                t.copy_(full.to(dtype=t.dtype))
        return like

    def manifest(self, step: Optional[int] = None) -> Dict:
        step = self.latest_step() if step is None else step
        return json.loads(
            (self.dir / f"step_{step}" / "manifest.json").read_text())

    def load_meta(self, step: Optional[int] = None) -> bytes:
        """The ``meta_blob`` saved with ``step`` (default: the latest)."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        return (self.dir / f"step_{step}" / "meta.bin").read_bytes()
