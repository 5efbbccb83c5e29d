"""Where the MoE route kernel's time goes above its decode path: each
block's clock at the stages of one call, on the card.

    PYTHONPATH=src python benchmarks/torch_route_stages.py [--calls 5]

A copy of ``src/repro_torch/csrc/moe_route.cu`` with a stamp of the
card's global timer (``%globaltimer``, ns) at each stage boundary of the
item path, written by thread 0 of each block to a device array, is built
by nvcc into ``build/route_stages/`` and loaded in place of the built
library. The stages: the block's start; its item drawn (item blocks);
the item routed and written; the done ticket drawn; the last item's
finish (offsets, bases, the flag, then counts and aux); past the items
(every block); the flag seen; the first window's rows; the copy's end.
At the MoE models' mixed ticks and mixtral-8x22b's 4400-token prompt
(``chip_smoke.MOE_ROUTERS``, ``MOE_TICKS``) the kernel runs ``--calls``
times, the last call's stamps are read, and each stage's time from the
grid's first start is printed (microseconds: median and largest over the
blocks, the item blocks and the others apart where they differ), with the
call's device time from a profiler trace. Stamps cost a store each; the
device time of the stamped copy is printed beside them.

Each output line is one JSON object; the card's name and power limit come
first.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.crossbar_matmul import ops as cb_ops  # noqa: E402
from repro_torch.kernels.moe_route import ops as moe_ops  # noqa: E402

OUT = ROOT / "build" / "route_stages"
STAGES = ("start", "item_drawn", "item_routed", "done_drawn", "finish_end",
          "past_items", "flag_seen", "rows_done", "copy_end")
STAMP = "if (threadIdx.x == 0) g_stamp[blockIdx.x][{}] = stamp();\n"
# (source line, where the stamp goes: "after" or "before", stage)
POINTS = (("  __shared__ Shared sh;\n", "after", "start"),
          ("    if (c >= a.items) break;\n", "after", "item_drawn"),
          ("    route_tokens<PM>(a, sh, tok0, ntok, true);\n    "
           "__syncthreads();\n", "after", "item_routed"),
          ("    if (sh.last) finish(a, sh, ctl, top1, off, part);\n",
           "before", "done_drawn"),
          ("    if (sh.last) finish(a, sh, ctl, top1, off, part);\n",
           "after", "finish_end"),
          ("  prefetch_units(a, sh);   // the x copy's first units, under "
           "the wait\n", "before", "past_items"),
          ("  copy_units(a, sh, pack, off);\n", "before", "flag_seen"),
          ("    __syncthreads();\n    for (int i = w0; i < ni; ++i) {\n",
           "first_window", "rows_done"),
          ("  copy_units(a, sh, pack, off);\n", "after", "copy_end"))
MAX_BLOCKS = 1024


def stamped_source() -> str:
    src = (build.CSRC / "moe_route.cu").read_text()
    head = ("namespace {\n"
            f"__device__ long long g_stamp[{MAX_BLOCKS}][{len(STAGES)}];\n"
            "__device__ __forceinline__ long long stamp() {\n"
            "  long long t;\n"
            "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
            "  return t;\n}\n")
    src = src.replace("namespace {\n", head, 1)
    for line, where, stage in POINTS:
        if src.count(line) != 1:      # the source changed: update POINTS
            raise RuntimeError(f"no single line {line!r}")
        i = STAGES.index(stage)
        if where == "first_window":   # between the rows and the copy
            first, second = line.split("\n", 1)
            put = f"{first}\n    if (w0 == 0) {STAMP.format(i)}{second}"
        elif where == "after":
            put = line + "  " + STAMP.format(i)
        else:
            put = "  " + STAMP.format(i) + line
        src = src.replace(line, put)
    src += ('\nextern "C" int moe_route_stamps(void* host, int zero) {\n'
            '  static long long z[%d][%d];\n'
            '  return zero ? (int)cudaMemcpyToSymbol(g_stamp, z, sizeof(z))\n'
            '              : (int)cudaMemcpyFromSymbol(host, g_stamp,\n'
            '                                          sizeof(z));\n}\n'
            % (MAX_BLOCKS, len(STAGES)))
    return src


def compile_stamped() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / "moe_route_stamped.cu", OUT / "libmoe_route_stamped.so"
    cu.write_text(stamped_source())
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def summary(h: np.ndarray) -> dict:
    """Each stage's µs from the grid's first start: median and largest
    over the blocks that stamped it (item blocks apart from the others)."""
    h = h[h[:, 0] > 0]
    t0 = h[:, 0].min()
    items = h[:, STAGES.index("item_drawn")] > 0
    out = {"blocks": int(len(h)), "item_blocks": int(items.sum())}
    for i, stage in enumerate(STAGES):
        for label, rows in (("", slice(None)), ("items_", items),
                            ("others_", ~items)):
            col = h[rows, i]
            col = col[col > 0]
            if len(col) and (label == "" or stage in ("flag_seen",
                                                      "copy_end")):
                out[f"{label}{stage}_us"] = [
                    float(np.median(col - t0)) / 1e3,
                    float((col - t0).max()) / 1e3]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(cs.smi_line(), flush=True)
    lib = compile_stamped()
    moe_ops._LIB = None
    build.load = lambda name: lib
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    h = np.zeros((MAX_BLOCKS, len(STAGES)), np.int64)
    for model, E, k, norm, d, _ in cs.MOE_ROUTERS:
        router = torch.randn(d, E, generator=g, device=dev) * d ** -0.5
        cases = [cs.MOE_TICKS[1]]
        if model == "mixtral-8x22b":
            cases.append(("prompt_4400", 1, 4400))
        for label, B, T in cases:
            n = B * T
            x = torch.randn(n, d, generator=g, device=dev)
            mask = (cs._tick_mask(dev, label, B, T).reshape(n)
                    if label == "mixed"
                    else torch.ones(n, dtype=torch.bool, device=dev))
            tile = cb_ops.GROUPED_TILE["prefill"]
            kw = dict(top_k=k, tpe=1, norm_topk=norm, tile=tile,
                      R=cb_ops.grouped_rows(n * k, E, tile))
            logits = x @ router
            for _ in range(args.calls):
                moe_ops.moe_route(logits, mask, x, **kw)
            torch.cuda.synchronize()
            lib.moe_route_stamps(None, 1)
            moe_ops.moe_route(logits, mask, x, **kw)
            torch.cuda.synchronize()
            lib.moe_route_stamps(ctypes.c_void_p(h.ctypes.data), 0)
            ms = cs.device_ms_by_name(
                [lambda: moe_ops.moe_route(logits, mask, x, **kw)] * 10,
                cs.ROUTE_KERNELS)
            print(json.dumps({"model": model, "case": label, "tokens": n,
                              "stamped_device_ms": ms, **summary(h)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
