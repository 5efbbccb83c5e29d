"""Hand-written CUDA kernels of the port, one package per TPU kernel.

Each ``ops`` module holds the kernel's wrapper and its plain PyTorch
version. The wrapper runs the plain version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises. ``LAUNCHES`` counts kernel
launches per kernel, so a run can show that its path went through the
kernels: the wrapper adds one where it launches, and nowhere else. A CUDA
graph runs its kernels without their wrappers, so the serving engine takes
back what the wrappers counted while it captured a graph (nothing ran) and
adds that count at each replay; ``chip_smoke.py`` holds the counts of
traced ticks against the kernels in the profiler's trace. A backward
entry point (``crossbar_matmul_t``, ``grouped_crossbar_matmul_t``,
``flash_attention_bwd``, ``rwkv6_wkv_bwd``) counts once
per call, whatever kernels it launches.

Importing the package also runs torch's CPU transcendental kernels once
(``_warm_up_cpu_math``), before any plain version runs.
"""
from __future__ import annotations

from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {"crossbar_matmul": 0, "crossbar_matmul_t": 0,
                            "grouped_crossbar_matmul": 0,
                            "grouped_crossbar_matmul_t": 0,
                            "flash_attention": 0, "flash_attention_bwd": 0,
                            "paged_flash_attention": 0,
                            "ring_flash_attention": 0, "rwkv6_wkv": 0,
                            "rwkv6_wkv_chunk": 0, "rwkv6_wkv_bwd": 0,
                            "selective_scan": 0, "moe_route": 0,
                            "moe_combine": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def call_on(fn, dev: int, *args) -> int:
    """Run a launch ``fn(*args)`` with CUDA device ``dev`` current (entered
    only when it is not)."""
    if dev == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def _warm_up_cpu_math() -> None:
    """Run torch's CPU exp, tanh, sigmoid, sin and cos once on a call that
    is split over two intra-op threads. The first ``torch.exp`` of a process
    has computed one thread's half of a 32768-element call up to 1.5e-4 off
    (relative) in 4 of 600 fresh processes under CPU load, the rest of the
    call and every later call exact to 6e-8. Every plain version (and so
    every CPU entry point: the tests, ``launch.train --device cpu``)
    imports this package first, so none of them makes the first call."""
    x = torch.linspace(-8.0, 8.0, 1 << 16)
    for fn in (torch.exp, torch.tanh, torch.sigmoid, torch.sin, torch.cos):
        fn(x)


_warm_up_cpu_math()
