"""Whether a ``torch.profiler`` trace on the card loses kernel records
after earlier, larger traces in the same process: the reason
``chip_smoke.py`` takes its late kernel cases in a process of their own.

    PYTHONPATH=src python benchmarks/torch_trace_volume.py

One kernel case, ``crossbar_matmul_t`` at a llama3.2-1b train
microbatch's (M 1024, K 2048, N 2048) int8 shape, is timed by
``chip_smoke.device_ms_by_name`` (10 calls in a ``cuda_trace``) three
times first, then again after each of a series of traces of growing
volume: 50 calls of the case with CPU activity, the same with the port's
launch ranges (``chip_smoke.named_launchers``), then 20,000 and 100,000
tiny elementwise launches, each with CUDA activity only and with CPU
activity too. A later device time below the first means the later trace
lost records of the case's kernel. Prints the card's name and power limit
first, then one line per step (with each big trace's event count and its
own lost launches).
"""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs                                   # noqa: E402


def main():
    from repro_torch.core import quant
    from repro_torch.kernels.crossbar_matmul import ops as cb_ops

    print(cs.smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(2048, 2048, generator=g, device=dev) * 2048 ** -0.5
    qt = quant.quantize(w, 8)
    gy = torch.randn(1024, 2048, generator=g, device=dev)

    def call():
        return cb_ops.crossbar_matmul_t(gy, qt)

    def measure(tag):
        ms = [cs.device_ms_by_name([call] * 10, cs.CB_T_KERNELS)
              for _ in range(3)]
        print(tag, [round(x, 4) for x in ms], flush=True)

    x = torch.ones(1024, device=dev)

    def many(n):
        for _ in range(n):
            x.add_(1.0)

    measure("device ms at the start")
    with cs.cuda_trace(cpu=True):
        for _ in range(50):
            call()
    measure("after a CPU+CUDA trace of 50 calls")
    with cs.named_launchers(), cs.cuda_trace(cpu=True):
        for _ in range(50):
            call()
    measure("after the same with the port's launch ranges")
    for n in (20000, 100000):
        for cpu in (False, True):
            with cs.cuda_trace(cpu=cpu) as prof:
                many(n)
            print(f"trace of {n} launches, cpu={cpu}: {len(prof.events())} "
                  f"events, {cs.lost_launches(prof)} lost", flush=True)
            measure("after it")


if __name__ == "__main__":
    main()
