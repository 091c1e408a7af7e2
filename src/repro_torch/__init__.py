"""PyTorch + CUDA port of the SATA serving stack (``repro``'s reference
is JAX/Pallas).  The layout mirrors ``repro`` path for path; the decode
gather kernel is hand-written CUDA for Hopper (``kernels/csrc``).

Entry points take an explicit ``device`` and default to ``"cuda"``: a
machine without a GPU must pass ``device="cpu"`` (the CPU tests do), and
nothing moves to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA request on a machine with
    no visible GPU raises instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            f"is False — pass device='cpu' to run the plain PyTorch path")
    return dev
