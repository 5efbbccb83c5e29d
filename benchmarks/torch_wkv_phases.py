"""Where the chunked wkv kernel's time goes, phase by phase, and what one
call of the wkv wrapper costs the host, on the card.

    PYTHONPATH=src python benchmarks/torch_wkv_phases.py
    python benchmarks/torch_wkv_phases.py --host [--tree DIR]

Phases: copies of ``src/repro_torch/csrc/rwkv6_wkv.cu`` in which one
phase of ``wkv_chunk_kernel``'s sub-chunk loop is cut out (the prefetch
of the next sub-chunk, the y stores, the decay products, A, the three
tensor-core products; and combinations) are compiled by nvcc into
``build/wkv_phases/`` and timed (the kernel's device time in a profiler
trace, 20 calls) at rwkv6-7b's shapes, B = 8, H = 64, N = 64, T = 16 and
128. A cut copy computes garbage: only its time is read, and the time a
phase adds on top of the rest is the full kernel's less the cut one's.

Host: microseconds for the host to issue one ``rwkv6_wkv`` call at
decode (T = 1), median of 5 runs of 500 calls, for the wrapper of the
checkout at DIR (its own ``src/``, built into its own ``build/``; default
this one). Compare two trees in one call of the script's command, in
turns: A, B, B, A.

Each output line is one JSON object; the card's name and power limit come
first.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (phase, first line of the phase, the text that follows it) in the loop
PHASES = (
    ("prefetch", "    if (c + 1 < n_sub) issue(c + 1);",
     "    cp_async_commit();\n    if (c > 0)"),
    ("y_stores", "    if (c > 0) store_y(c - 1);", "\n    const float* rs"),
    ("decay", "    // decay products as TF32 pieces",
     "    // A[t, s]: warp w takes"),
    ("A", "    // A[t, s]: warp w takes",
     "    __syncthreads();\n\n    // y^T ="),
    ("products", "    // y^T = S^T (r * P)^T",
     "  }\n  __syncthreads();   // the last sub-chunk"),
)
VARIANTS = {"full": (), "no_prefetch": ("prefetch",),
            "no_y_stores": ("y_stores",), "no_decay": ("decay",),
            "no_A": ("A",), "no_products": ("products",),
            "no_decay_A": ("decay", "A"),
            "loads_only": ("decay", "A", "products"),
            "state_only": tuple(p[0] for p in PHASES)}


def cut_source(src: str, cut) -> str:
    for name, start, end in PHASES:
        a = src.index(start)            # raises if the kernel changed
        b = src.index(end, a)
        if name in cut:
            src = src[:a] + src[b:]
    return src


def device_us(fn, reps=20):
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
               and "wkv_chunk_kernel" in e.name) / reps


def phases():
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    out_dir = ROOT / "build" / "wkv_phases"
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
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rwkv6_wkv.argtypes = [vp] * 8 + [ci] * 4 + [cl] * 3 + [ci, vp]
        lib.rwkv6_wkv.restype = ci
        libs[name] = lib
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    B, H, N = 8, 64, 64
    for T in (16, 128):
        r, k, v = (torch.randn(B, T, H, N, generator=g, device=dev)
                   for _ in range(3))
        w = torch.exp(-torch.exp(-6.0 + 5.0 * torch.rand(
            B, T, H, N, generator=g, device=dev)))
        u = 0.5 * torch.ones(H, N, device=dev)
        s0 = torch.randn(B, H, N, N, generator=g, device=dev)
        y = torch.empty_like(r)
        sf = torch.empty_like(s0)
        ptrs = [t.data_ptr() for t in (r, k, v, w, u, s0, y, sf)]
        times = {}
        for name, lib in libs.items():
            def call(lib=lib):
                rc = lib.rwkv6_wkv(*ptrs, B, T, H, N, *r.stride()[:3], 1,
                                   torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            times[name] = device_us(call)
        print(json.dumps({"T": T, "B": B, "H": H, "N": N,
                          "device_us": times}), flush=True)


def host(tree: Path):
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels.rwkv6_wkv import ops

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    B, T, H, N = 8, 1, 64, 64
    r, k, v = (torch.randn(B, T, H, N, generator=g, device=dev)
               for _ in range(3))
    w = torch.rand(B, T, H, N, generator=g, device=dev)
    u = torch.ones(H, N, device=dev)
    s0 = torch.randn(B, H, N, N, generator=g, device=dev)
    for _ in range(50):
        ops.rwkv6_wkv(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(500):
            ops.rwkv6_wkv(r, k, v, w, u, s0)
        runs.append(1e6 * (time.perf_counter() - t) / 500)
        torch.cuda.synchronize()
    print(json.dumps({"tree": str(tree), "host_us": statistics.median(runs),
                      "runs": runs}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", action="store_true",
                    help="time the wrapper's host cost instead of phases")
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose wrapper --host times")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.host:
        host(Path(args.tree).resolve())
    else:
        phases()


if __name__ == "__main__":
    main()
