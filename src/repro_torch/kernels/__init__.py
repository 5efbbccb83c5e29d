"""Hand-written CUDA kernels of the port, one package per TPU kernel.

Each ``ops`` module holds the kernel's wrapper and its plain PyTorch
version. The wrapper runs the plain version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises. ``LAUNCHES`` counts kernel
launches per kernel, so a run can show that its path went through the
kernels: the wrapper adds one where it launches, and nowhere else. A CUDA
graph runs its kernels without their wrappers, so the serving engine takes
back what the wrappers counted while it captured a graph (nothing ran) and
adds that count at each replay; ``chip_smoke.py`` holds the counts of
traced ticks against the kernels in the profiler's trace.
"""
from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {"crossbar_matmul": 0, "flash_attention": 0,
                            "paged_flash_attention": 0, "rwkv6_wkv": 0,
                            "rwkv6_wkv_chunk": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
