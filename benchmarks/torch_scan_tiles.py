"""The tiled selective-scan kernel's knobs, timed on the card, and the
register kernel against the tiled one across T (``CHUNK_MIN_T``).

    PYTHONPATH=src python benchmarks/torch_scan_tiles.py [--reps 10]

``src/repro_torch/csrc/selective_scan.cu`` fixes seven constants of its
tiled kernel: ``kTLanes`` and ``kTLanesFew`` (threads a channel when the
grid fills the card, and when it leaves fewer than ``kTFewBlocks``
blocks an SM), ``kTSteps`` (steps a tile), ``kTStages`` (tiles in the
ring), ``kTUnroll`` (steps unrolled), ``kTMinBlocks`` (the launch
bounds' blocks an SM) and ``kTThreads`` (threads a block).
Each variant below is a copy of the source with those lines replaced,
compiled by nvcc into ``build/scan_tiles/`` (all at once; each variant's
ptxas registers and spills are printed) and loaded in place of the built
library. Each is held against ``selective_scan_plain``
(``chip_smoke.SCAN_TOL`` of max |y| and of max |h_T|) and against itself
(two calls, the same bits) at small shapes that reach every copy path (a
width that is not a multiple of 4, contiguous and strided B/C, d_state 4
and 16, a tail tile) and at jamba's width (d_in 16384, d_state 16),
where it is timed: the device time of the scan kernels in a profiler
trace (``--reps`` calls) of ``TIMED``. The variants run in two rounds,
the second in reverse order. Then, with the source's own variant, both
kernels at B = 8 across T (``kernel="recurrent"`` and ``"tiled"``).

Each output line is one JSON object; the card's name and power limit come
first. The exit code is 1 when any variant fails a check.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.selective_scan import ops  # noqa: E402

KNOBS = ("kTLanes", "kTLanesFew", "kTSteps", "kTStages", "kTUnroll",
         "kTMinBlocks", "kTThreads")
VARIANTS = {  # name -> KNOBS' values; the first is the source's
    "l1f2_s32_u4_b3": (1, 2, 32, 2, 4, 3, 128),
    "l1f1_s32_u4_b3": (1, 1, 32, 2, 4, 3, 128),
    "l2f2_s32_u4_b3": (2, 2, 32, 2, 4, 3, 128),
    "l1f2_s16_u4_b3": (1, 2, 16, 2, 4, 3, 128),
    "l1f2_s32_st3_u4_b2": (1, 2, 32, 3, 4, 2, 128),
    "l1f2_s32_u2_b4": (1, 2, 32, 2, 2, 4, 128),
    "l1f2_s32_u4_b2": (1, 2, 32, 2, 4, 2, 128),
    "l1f2_s16_u2_b2_t256": (1, 2, 16, 2, 2, 2, 256)}
# (label, B, T, chunk_lens) timed at jamba's width
# (and what each of a time split's two passes would at least take: the
# kernel over 4 or 32 rows of 128 steps, a 512- or 4096-step prompt cut
# into chunks of 128)
TIMED = (("decode", 8, 1, None), ("verify", 8, 5, None),
         ("prefill", 8, 128, None),
         ("ragged", 8, 128, (128, 100, 64, 1, 0, 128, 37, 5)),
         ("prompt", 1, 512, None), ("long_prompt", 1, 4096, None),
         ("split_pass_4x128", 4, 128, None),
         ("split_pass_32x128", 32, 128, None))
# (B, T, D, N, strided, chunk_lens) checked only: at kTLanesFew (a few
# blocks) and at kTLanes (300 rows: a block an SM or more)
CHECKED = ((2, 70, 100, 16, True, None), (2, 70, 4096, 4, False, None),
           (2, 300, 70, 16, True, (300, 0)), (3, 45, 64, 4, True, None),
           (300, 37, 70, 16, True, None), (300, 20, 128, 4, False, None))
CROSSOVER_T = (1, 2, 3, 4, 5, 6, 8, 12, 16, 32)
OUT = ROOT / "build" / "scan_tiles"


def variant_source(values) -> str:
    """The scan source with the tiled kernel's constants replaced."""
    src = (build.CSRC / "selective_scan.cu").read_text()
    for knob, value in zip(KNOBS, values):
        line = re.search(rf"^constexpr int {knob} = \d+;", src, re.M)
        if line is None:           # the source changed: update KNOBS
            raise RuntimeError(f"no line 'constexpr int {knob} = ...;'")
        src = (src[:line.start()] + f"constexpr int {knob} = {value};"
               + src[line.end():])
    return src


def compile_all():
    """One nvcc per variant, all at once; returns name -> library path."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, values in VARIANTS.items():
        lib, cu = OUT / f"lib_{name}.so", OUT / f"{name}.cu"
        cu.write_text(variant_source(values))
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        libs[name] = lib
        print(json.dumps({"variant": name, "ptxas": cs.ptxas_report(log)}),
              flush=True)
    return libs


def use(lib: Path) -> None:
    """Make the scan wrapper call ``lib``."""
    ops._LIB = None
    build.load = lambda name, path=lib: ctypes.CDLL(str(path))


def checked_inputs(dev, g, B, T, D, N, strided, clens):
    args = list(cs._scan_inputs(dev, g, B, T, D, N, clens))
    if not strided:
        args[1], args[2] = args[1].contiguous(), args[2].contiguous()
    return tuple(args)


def check(args, kernel="auto") -> dict:
    """The kernel against the plain version: relative errors, the same
    bits twice, an idle row's state kept (where dt is 0 in every step)."""
    y, h = ops.selective_scan(*args, kernel=kernel)
    y2, h2 = ops.selective_scan(*args, kernel=kernel)
    yp, hp = ops.selective_scan_plain(*args)
    torch.cuda.synchronize()
    rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in ((y, yp), (h, hp)))
    idle = [i for i in range(args[0].shape[0])
            if not bool(args[0][i].any())]
    out = {"max_rel_err": rel,
           "same_bits": bool(torch.equal(y, y2) and torch.equal(h, h2))}
    if idle:
        out["idle_row_kept"] = all(torch.equal(h[i], args[5][i])
                                   for i in idle)
    out["ok"] = (rel <= cs.SCAN_TOL and out["same_bits"]
                 and out.get("idle_row_kept", True))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(cs.smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    libs = compile_all()
    g = torch.Generator(device=dev).manual_seed(0)
    small = [checked_inputs(dev, g, *c) for c in CHECKED]
    timed = {c[0]: cs._scan_inputs(dev, g, *c[1:3], 16384, 16, c[3])
             for c in TIMED}
    ok = True             # every variant held its checks
    source = next(iter(libs))
    for rnd, order in enumerate((list(libs), list(libs)[::-1])):
        for name in order:
            use(libs[name])
            for c, a in zip(CHECKED, small):
                r = check(a, kernel="tiled")
                ok &= r["ok"]
                print(json.dumps({"variant": name, "round": rnd,
                                  "check": dict(zip(("B", "T", "D", "N",
                                                     "strided", "lens"), c)),
                                  **r}), flush=True)
            for (label, B, T, _), a in zip(TIMED, timed.values()):
                r = check(a)
                ok &= r["ok"]
                ms = cs.device_ms_by_name(
                    [lambda a=a: ops.selective_scan(*a)] * args.reps,
                    cs.SCAN_KERNELS)
                parts, bound, _ = cs.scan_bound(B, T, 16384, 16)
                print(json.dumps({"variant": name, "round": rnd,
                                  "case": label, "B": B, "T": T, **r,
                                  "device_ms": ms, "bound_parts_ms": parts,
                                  "over_bound": ms / bound}),
                      flush=True)
    use(libs[source])
    for T in CROSSOVER_T:
        a = cs._scan_inputs(dev, g, 8, T, 16384, 16)
        row = {"crossover_T": T, "B": 8}
        for kernel in ("recurrent", "tiled"):
            r = check(a, kernel=kernel)
            ok &= r["ok"]
            row[kernel] = {**r, "device_ms": cs.device_ms_by_name(
                [lambda: ops.selective_scan(*a, kernel=kernel)] * args.reps,
                cs.SCAN_KERNELS)}
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
