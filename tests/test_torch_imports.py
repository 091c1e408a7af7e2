"""The port stands alone: importing it loads neither JAX nor the JAX
package, no source file under ``src/repro_torch`` imports them, and its
entry points refuse to run on the CPU unless asked to."""
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


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
              "repro_torch.checkpoint.manager", "repro_torch.data.pipeline"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
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
    hits = [f"{p}: {m.group(0).strip()}" for p in PORT.rglob("*.py")
            for m in pat.finditer(p.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("entry", ["serve", "init_cache", "model", "train",
                                   "init_train_state"])
def test_entry_points_default_to_cuda_and_never_fall_back(entry):
    """On a machine without a GPU, a call that does not ask for the CPU
    raises instead of running there."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    from repro_torch.configs.archs import SMOKE
    from repro_torch.launch.serve import serve
    from repro_torch.models.decode import init_cache
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
            }[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        call()
