"""The port stands alone: importing it (and its examples) loads neither
JAX nor the JAX package, no source file under ``src/repro_torch`` and no
``examples/*_torch.py`` imports them (at top level or inside a function),
and its entry points refuse to run on the CPU unless asked to."""
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
EXAMPLES = sorted((SRC.parent / "examples").glob("*_torch.py"))


def _modules():
    return sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_import_loads_no_jax_and_no_reference_package():
    mods = _modules()
    for m in ("repro_torch.launch.serve", "repro_torch.launch.train",
              "repro_torch.kernels.sata_attention", "repro_torch.core.sorting",
              "repro_torch.train.step", "repro_torch.optim.adamw",
              "repro_torch.checkpoint.manager", "repro_torch.data.pipeline",
              "repro_torch.models.moe", "repro_torch.core.masks",
              "repro_torch.core.scheduling", "repro_torch.core.tiling",
              "repro_torch.core.simulator", "repro_torch.core.sata",
              "repro_torch.configs.workloads",
              "repro_torch.launch.roofline", "repro_torch.launch.mesh",
              "repro_torch.distributed.sharding",
              "repro_torch.distributed.ctx", "repro_torch.launch.dryrun",
              "repro_torch.launch.inputs", "repro_torch.launch.report"):
        assert m in mods, m
    assert [p.name for p in EXAMPLES] == ["quickstart_torch.py",
                                          "schedule_demo_torch.py",
                                          "serve_topk_torch.py",
                                          "train_lm_torch.py"]
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"for p in {[str(p) for p in EXAMPLES]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('ex', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "# the planner's tiled branch and the tiled simulator\n"
        "import numpy as np\n"
        "from repro_torch.core import plan, simulate_tiled_sata, HwConfig\n"
        "m = np.eye(12, dtype=bool)[None]\n"
        "simulate_tiled_sata(plan(m, s_f=4).tiled, 8, HwConfig())\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_source_scan_finds_no_jax_or_reference_import():
    # ``repro_torch`` never matches: ``\b`` / ``[.\s]`` need the name
    # to end right after ``repro``
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)[.\s])",
                     re.M)
    files = list(PORT.rglob("*.py")) + EXAMPLES
    assert PORT / "launch" / "mesh.py" in files
    assert PORT / "distributed" / "sharding.py" in files
    assert PORT / "distributed" / "ctx.py" in files
    hits = [f"{p}: {m.group(0).strip()}" for p in files
            for m in pat.finditer(p.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("entry", ["serve", "init_cache", "model", "train",
                                   "init_train_state", "serve_replicated",
                                   "make_local_mesh", "make_shard_mesh",
                                   "make_train_mesh"])
def test_entry_points_default_to_cuda_and_never_fall_back(entry):
    """On a machine without a GPU, a call that does not ask for the CPU
    raises instead of running there."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    from repro_torch.configs.archs import SMOKE
    from repro_torch.launch.serve import serve, serve_replicated
    from repro_torch.models.decode import init_cache
    from repro_torch.launch.mesh import (make_local_mesh, make_shard_mesh,
                                         make_train_mesh)
    from repro_torch.launch.train import train
    from repro_torch.models.model import DenseModel
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import init_train_state
    cfg = SMOKE["qwen3-4b"]
    call = {"serve": lambda: serve("qwen3-4b", cfg=cfg),
            "init_cache": lambda: init_cache(cfg, 2, 16),
            "model": lambda: DenseModel(cfg),
            "train": lambda: train("qwen3-4b", steps=1, batch=1, seq=8),
            "init_train_state": lambda: init_train_state(cfg, OptConfig()),
            "serve_replicated": lambda: serve_replicated("qwen3-4b",
                                                         cfg=cfg),
            "make_local_mesh": make_local_mesh,
            "make_shard_mesh": lambda: make_shard_mesh(1),
            "make_train_mesh": lambda: make_train_mesh(1, 1),
            }[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        call()
