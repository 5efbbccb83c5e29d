"""PyTorch/CUDA port of the Atleus reproduction (``repro``).

Mirrors ``src/repro/`` module by module; the JAX package stays the
reference every part of the port is tested against. The port imports
``torch`` and never ``jax`` or ``repro``.

Entry points take an explicit ``device``. ``None`` means the CUDA card:
with no card they raise rather than fall back to the CPU. Pass
``device="cpu"`` to run the plain PyTorch versions of the kernels (tests).
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises without
    one)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type == "cuda" and dev.index is None:
        # "cuda" means the current card, so that it compares equal to the
        # device of the tensors made on it
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


__all__ = ["resolve_device", "DeviceLike"]
