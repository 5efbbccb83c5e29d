"""The flash backward kernels' tile and plan knobs, timed on the card.

    python benchmarks/torch_flash_bwd_tiles.py [--reps 10]

``src/repro_torch/csrc/flash_attention.cu`` fixes three constants of its
backward: ``kBS`` (rows of a streamed query tile in the dk/dv kernel, keys
of a streamed key tile in the dq kernel), ``kBMinBlocks`` (blocks an SM
holds: the launch bounds) and ``kBWaves`` (blocks for every SM that the
plan aims at when it splits long causal lists). Each variant below is a
copy of the source with those three lines replaced, compiled by nvcc into
``build/flash_bwd_tiles/`` (all at once) and loaded in place of the built
library, held against ``flash_attention_bwd_plain`` (1e-4 relative and
absolute) and against itself (two calls, the same bits), and timed: the
device time of its kernels in a profiler trace (``--reps`` calls) at one
train microbatch's attention, B = 2, T = S = 512 causal, 32/8 (llama3.2-1b)
and 16/16 heads (the paper models), and at the whole batch's B = 4. The
variants run in two rounds, the second in reverse order; SDPA's f32
backward (the yardstick) is timed in the same run.

Each output line is one JSON object; the card's name and power limit come
first.
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

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402

VARIANTS = {  # name -> (kBS, kBMinBlocks, kBWaves); the first is the source's
    "bs32_b3_w2": (32, 3, 2), "bs32_b3_w4": (32, 3, 4),
    "bs32_b2_w2": (32, 2, 2), "bs64_b2_w2": (64, 2, 2)}
SHAPES = ((2, 512, 32, 8), (2, 512, 16, 16), (4, 512, 32, 8))
D = 64
OUT = ROOT / "build" / "flash_bwd_tiles"


KNOBS = ("kBS", "kBMinBlocks", "kBWaves")


def variant_source(values) -> str:
    """The flash source with the backward's three constants replaced."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    for knob, value in zip(KNOBS, values):
        line = re.search(rf"^constexpr int {knob} = \d+;$", src, re.M)
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
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln]
        print(json.dumps({"variant": name, "ptxas": regs[:4]}), flush=True)
    return libs


def use(lib: Path) -> None:
    """Make the flash wrappers call ``lib``."""
    fa._LIB = None
    fa._NEEDS.clear()
    build.load = lambda name, path=lib: ctypes.CDLL(str(path))


def device_us(fn, reps):
    """Device microseconds per call of fn, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / reps
    return out


def inputs(dev, g, B, T, Hq, Hkv):
    q, dout = (torch.randn(B, T, Hq, D, generator=g, device=dev)
               for _ in range(2))
    k, v = (torch.randn(B, T, Hkv, D, generator=g, device=dev)
            for _ in range(2))
    pos = torch.arange(T, device=dev, dtype=torch.int32)[None].expand(
        B, T).contiguous()
    out, lse = fa._launch(q, k, v, pos, pos, None, None, with_lse=True)
    return (q, k, v, pos, pos, out, lse, dout)


def sdpa_bwd(args):
    q, k, v, pos, _, _, _, dout = args
    G = q.shape[2] // k.shape[2]
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(
        ql.transpose(1, 2), kl.repeat_interleave(G, 2).transpose(1, 2),
        vl.repeat_interleave(G, 2).transpose(1, 2),
        attn_mask=fa.visible_mask(pos, pos, None)[:, None])
    return lambda: torch.autograd.grad(o, (ql, kl, vl), dout.transpose(1, 2),
                                       retain_graph=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    libs = compile_all()
    g = torch.Generator(device=dev).manual_seed(0)
    cases = {shape: inputs(dev, g, *shape) for shape in SHAPES}
    want = {shape: fa.flash_attention_bwd_plain(*a)
            for shape, a in cases.items()}
    ok = True
    for rnd, order in enumerate((list(libs), list(libs)[::-1])):
        for name in order:
            use(libs[name])
            for shape, a in cases.items():
                got = fa.flash_attention_bwd(*a)
                again = fa.flash_attention_bwd(*a)
                torch.cuda.synchronize()
                over = max(float(((x - y).abs() - 1e-4 * y.abs()).max())
                           for x, y in zip(got, want[shape]))
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                us = device_us(lambda: fa.flash_attention_bwd(*a), args.reps)
                ok &= over <= 1e-4 and same
                print(json.dumps({
                    "variant": name, "round": rnd,
                    "shape": dict(zip(("B", "T", "Hq", "Hkv"), shape)),
                    "max_err_over_rel": over, "same_bits": same,
                    "device_us": us, "total_us": sum(us.values())}),
                    flush=True)
    for shape, a in cases.items():
        us = device_us(sdpa_bwd(a), args.reps)
        print(json.dumps({"sdpa_backward": dict(zip(("B", "T", "Hq", "Hkv"),
                                                    shape)),
                          "total_us": sum(us.values())}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
