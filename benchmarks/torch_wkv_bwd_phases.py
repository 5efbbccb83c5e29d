"""Where the chunked wkv backward kernel's time goes, phase by phase, on
the card.

    PYTHONPATH=src python benchmarks/torch_wkv_bwd_phases.py

Copies of ``src/repro_torch/csrc/rwkv6_wkv.cu`` in which one phase of
``wkv_bwd_chunk_kernel`` is cut out (the sweep's state advance, the
products H, G and dA, A and the decays, the partials' sums, dv's partial,
dS's step, the per-row scans, the row groups' dv sum; and all of them)
are compiled by nvcc into ``build/wkv_bwd_phases/`` and
timed (the kernel's device time in a profiler trace, 10 calls) at one
rwkv6-7b train microbatch (B = 2, T = 512, H = 64, N = 64: 128 blocks, one
an SM) and at B = 1, H = 8 (8 blocks: one block's path, with the card
nearly empty). A cut copy computes garbage: only its time is read,
and the time a phase adds on top of the rest is the full kernel's less
the cut one's. Each variant's registers and spills (``-Xptxas=-v``) and
the residency that ``rwkv6_wkv_bwd_occupancy`` reports stand beside it.

Each output line is one JSON object; the card's name and power limit come
first.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (phase, first text of the phase, the text that follows it) in the kernel
PHASES = (
    ("sweep", "    if (gt < kRows) {\n      float p = 1.f;",
     "  }\n\n  // 2. the sub-chunks from the last"),
    ("rows", "    // P, y and Q, x from a prefix and a suffix scan",
     "  };\n  for (int c = n_sub - 1; c >= 0; --c) {"),
    ("products", "    // 2a. H = dY S^T", "    // 2b. A's partial"),
    ("A_decay", "    // 2b. A's partial",
     "    __syncthreads();\n    if (c + 1 < n_sub) store_out"),
    ("sums", "    // 2c. the warps' partials", "    // dY's B pieces"),
    ("dv_part", "    // 2d. dv's partial", "    // 2e. the gradient into"),
    ("dS_step", "    // 2e. the gradient into",
     "  }\n  __syncthreads();   // sub-chunk 0's sums"),
    ("dv_sum", "    const int s = tid >> 5, jj = 2 * (tid & 31);",
     "  };\n  // dr, dk, dw of the group's rows"),
)
VARIANTS = {"full": (), "no_sweep": ("sweep",), "no_products": ("products",),
            "no_A_decay": ("A_decay",), "no_sums": ("sums",),
            "no_dv_part": ("dv_part",), "no_dS_step": ("dS_step",),
            "no_rows": ("rows",), "no_dv_sum": ("dv_sum",),
            "loads_only": tuple(p[0] for p in PHASES)}
KERNEL = "wkv_bwd_chunk_kernel"


def cut_source(src: str, cut) -> str:
    head, body = src.split(f"\n{KERNEL}(", 1)
    for name, start, end in PHASES:
        a = body.index(start)            # raises if the kernel changed
        b = body.index(end, a)
        if name in cut:
            body = body[:a] + body[b:]
    return head + f"\n{KERNEL}(" + body


def device_us(fn, reps=10):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and KERNEL in e.name) / reps


def ptxas_of_kernel(log: str) -> str:
    """The registers and spills line pair of the chunked backward kernel."""
    lines = log.splitlines()
    for n, line in enumerate(lines):
        if "Function properties" in line and KERNEL in line:
            spill = lines[n + 1].strip()
            used = re.sub(r"^ptxas info\s*:\s*", "", lines[n + 2].strip())
            return f"{used}; {spill}"
    return "not found"


def main():
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    out_dir = ROOT / "build" / "wkv_bwd_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "rwkv6_wkv.cu").read_text()
    procs = {}
    for name, cut in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(cut_source(src, cut))
        so = out_dir / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, regs = {}, {}
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        regs[name] = ptxas_of_kernel(log)
        lib = ctypes.CDLL(str(so))
        lib.rwkv6_wkv_bwd.argtypes = ([vp] * 14 + [vp, cl] + [ci] * 4
                                      + [cl] * 3 + [ci, vp])
        lib.rwkv6_wkv_bwd.restype = ci
        libs[name] = lib
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    blocks = ctypes.c_int(0)
    rc = libs["full"].rwkv6_wkv_bwd_occupancy(ctypes.byref(blocks))
    print(json.dumps({"occupancy_rc": rc, "blocks_per_sm": blocks.value,
                      "ptxas": regs}), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    N, T = 64, 512
    for B, H in ((2, 64), (1, 8)):
        r, k, v, dy = (torch.randn(B, T, H, N, generator=g, device=dev)
                       for _ in range(4))
        w = torch.exp(-torch.exp(-6.0 + 5.0 * torch.rand(
            B, T, H, N, generator=g, device=dev)))
        u = 0.5 * torch.ones(H, N, device=dev)
        s0, ds = (torch.randn(B, H, N, N, generator=g, device=dev)
                  for _ in range(2))
        grads = [torch.empty_like(r) for _ in range(4)]
        du_rows = torch.empty(B, H, N, device=dev)
        ds0 = torch.empty_like(s0)
        ws = torch.empty(B * H * (T // 16) * N * N, device=dev)
        ptrs = [t.data_ptr() for t in (r, k, v, w, u, s0, dy, ds, *grads,
                                       du_rows, ds0, ws)]
        times = {}
        for name, lib in libs.items():
            def call(lib=lib, name=name):
                rc = lib.rwkv6_wkv_bwd(*ptrs[:-1], ptrs[-1], ws.numel(), B,
                                       T, H, N, *r.stride()[:3], 1,
                                       torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            times[name] = device_us(call)
        print(json.dumps({"B": B, "T": T, "H": H, "N": N,
                          "device_us": times}), flush=True)


if __name__ == "__main__":
    main()
