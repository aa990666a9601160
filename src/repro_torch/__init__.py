"""PyTorch/CUDA port of the ``repro`` package (the JAX reference).

The port imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.  Every entry point runs on the card unless the caller asks for
the CPU (``device="cpu"``, ``--device cpu``): on the CPU each kernel wrapper
takes its plain PyTorch version, on ``cuda`` it launches the hand-written
Hopper kernel (``csrc/``) or raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; with no card that is an error, never a
    silent fall-back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
