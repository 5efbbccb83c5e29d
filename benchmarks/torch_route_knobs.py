"""The MoE route kernel's knobs, timed on the card.

    PYTHONPATH=src python benchmarks/torch_route_knobs.py [--reps 10]

``src/repro_torch/csrc/moe_route.cu`` fixes five constants of its route
kernel: ``kChunk`` (tokens of a routing item), ``kRouteAllMax`` (up to
this many tokens every block routes them all and needs no workspace;
above it the items go by ticket and every block waits for the last one's
scan: 0 sends a decode tick that way too, one block routing it while the
others wait), ``kRing`` (copy units a block keeps in flight, 4 KB each in
shared memory), ``kRouteBlocksPerSm`` (the grid's blocks an SM) and
``kPollNs`` (a waiting block's pause between polls of the flag). Each variant below is
a copy of the source with those lines replaced (and, for the variants
that cut a phase, a few lines of code: timed only, not checked; and one
where no block fetches a copy unit before the flag), compiled
by nvcc into
``build/route_knobs/`` (all at once; each variant's ptxas registers and
spills are printed) and loaded in place of the built library. At the MoE
models' decode and mixed ticks and mixtral-8x22b's 4400-token prompt
(``chip_smoke.MOE_ROUTERS``, ``MOE_TICKS``) each is held against
``moe_route_plain`` (``moe_ops.compare_routes``, the layout bit-equal)
and against itself (two calls, the same bits), and timed: the device time
of the route kernels in a profiler trace of ``--reps`` calls; at the decode
ticks also with each call after a 2048 x 2048 f32 product and a pass over
256 MB (``cold_device_ms``: code and data out of the caches, as between a
decode tick's expert products). The variants run in two rounds, the
second in reverse order. Then the
source's variant runs each case ``--repeats`` times more, each call's
outputs held bit for bit against the first's (a race between its blocks
would show as a difference). Last, the device
time of a one-element torch elementwise launch measured the same way (the
floor a launch costs).

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
from repro_torch.kernels.crossbar_matmul import ops as cb_ops  # noqa: E402
from repro_torch.kernels.moe_route import ops as moe_ops  # noqa: E402

KNOBS = ("kChunk", "kRouteAllMax", "kRing", "kRouteBlocksPerSm", "kPollNs")
SOURCE = (32, 32, 8, 2, 32)
# phases cut: (old, new) source lines
CUT_COPY = (("  copy_units(a, sh, nullptr, nullptr);\n", ""),
            ("  copy_units(a, sh, pack, off);\n", ""),
            ("  prefetch_units(a, sh);   // the x copy's first units, under the "
             "routing\n", ""),
            ("  prefetch_units(a, sh);   // the x copy's first units, under "
             "the wait\n", ""))
# no block fetches a copy unit before the flag
LATE = (("  prefetch_units(a, sh);   // the x copy's first units, under the "
         "wait\n", ""),
        ("  __syncthreads();\n  copy_units(a, sh, pack, off);\n",
         "  __syncthreads();\n  prefetch_units(a, sh);\n"
         "  copy_units(a, sh, pack, off);\n"))
ROUTE_ONLY = (("  route_tokens<PM>(a, sh, 0, a.n, first);\n"
               "  __syncthreads();\n",
               "  route_tokens<PM>(a, sh, 0, a.n, first);\n"
               "  asm volatile(\"cp.async.wait_all;\" ::: \"memory\");\n"
               "  return;\n"),)
EMPTY = (("  if (a.n <= kRouteAllMax)\n    route_all<PM>(a, sh);\n  else\n"
          "    route_items<PM>(a, sh);\n",
          "  if (a.n < 0) route_all<PM>(a, sh);\n"),)
VARIANTS = {  # name -> (KNOBS' values, cuts); the first is the source's
    "source": (SOURCE, ()),
    "route_all_0": ((32, 0, 8, 2, 32), ()),
    "chunk_16": ((16, 16, 8, 2, 32), ()),
    "ring_24": ((32, 32, 24, 2, 32), ()),
    "blocks_1": ((32, 32, 8, 1, 32), ()),
    "poll_0": ((32, 32, 8, 2, 0), ()),
    "poll_256": ((32, 32, 8, 2, 256), ()),
    "fetch_after_flag": (SOURCE, LATE),
    "cut_copy": (SOURCE, CUT_COPY),
    "route_only": (SOURCE, ROUTE_ONLY),
    "empty": (SOURCE, EMPTY)}
CUT = ("cut_copy", "route_only", "empty")   # variants timed, not checked
# (label, tokens) timed beside the ticks: mixtral's forward prompt
PROMPT = ("prompt_4400", 4400)
OUT = ROOT / "build" / "route_knobs"


def variant_source(values, cuts) -> str:
    """The route source with the kernel's constants and ``cuts`` replaced."""
    src = (build.CSRC / "moe_route.cu").read_text()
    for old, new in cuts:
        if src.count(old) != 1:    # the source changed: update the cuts
            raise RuntimeError(f"no single line {old!r}")
        src = src.replace(old, new)
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
    for name, (values, cuts) in VARIANTS.items():
        lib, cu = OUT / f"lib_{name}.so", OUT / f"{name}.cu"
        cu.write_text(variant_source(values, cuts))
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
    """Make the route wrapper call ``lib`` (its workspace sized anew, its
    tickets zeroed: the variants lay them out differently)."""
    moe_ops._LIB = None
    moe_ops._NEEDS.clear()
    for _, tickets in moe_ops.WORKSPACES._ws.values():
        tickets.zero_()
    build.load = lambda name, path=lib: ctypes.CDLL(str(path))


def cases(dev, g):
    """(model, label, route kwargs, logits, mask, x) of each timed case."""
    out = []
    for model, E, k, norm, d, _ in cs.MOE_ROUTERS:
        router = torch.randn(d, E, generator=g, device=dev) * d ** -0.5
        ticks = list(cs.MOE_TICKS)
        if model == "mixtral-8x22b":
            ticks.append((PROMPT[0], 1, PROMPT[1]))
        for label, B, T in ticks:
            n = B * T
            x = torch.randn(n, d, generator=g, device=dev)
            mask = (cs._tick_mask(dev, label, B, T).reshape(n)
                    if label in ("decode", "mixed")
                    else torch.ones(n, dtype=torch.bool, device=dev))
            tile = cb_ops.GROUPED_TILE["decode" if n <= 8 else "prefill"]
            kw = dict(top_k=k, tpe=1, norm_topk=norm, tile=tile,
                      R=cb_ops.grouped_rows(n * k, E, tile))
            out.append((model, label, kw, x @ router, mask, x))
    return out


def check(kw, logits, mask, x) -> dict:
    got = moe_ops.moe_route(logits, mask, x, **kw)
    again = moe_ops.moe_route(logits, mask, x, **kw)
    want = moe_ops.moe_route_plain(logits, mask, x, **kw)
    torch.cuda.synchronize()
    c = moe_ops.compare_routes(got, want)
    rk = want.rows[want.weights > 0]
    same = (all(torch.equal(a, b) for a, b in zip(got[:-1], again[:-1]))
            and torch.equal(got.xbuf[rk], again.xbuf[rk]))
    return {"same_bits": same, "layout_equal": c["layout_equal"],
            "ok": c["ok"] and c["layout_equal"] is True and same}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(cs.smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    libs = compile_all()
    timed = cases(dev, torch.Generator(device=dev).manual_seed(0))
    big = torch.empty(64 * 2 ** 20, device=dev)
    square = torch.randn(2048, 2048, device=dev)
    ok = True             # every variant held its checks
    for rnd, order in enumerate((list(libs), list(libs)[::-1])):
        for name in order:
            use(libs[name])
            for model, label, kw, logits, mask, x in timed:
                r = {}
                if name not in CUT:
                    r = check(kw, logits, mask, x)
                    ok &= r["ok"]
                ms = cs.device_ms_by_name(
                    [lambda: moe_ops.moe_route(logits, mask, x, **kw)]
                    * args.reps, cs.ROUTE_KERNELS)
                if label == "decode":
                    def cold():
                        torch.mm(square, square)
                        big.add_(1.0)
                        moe_ops.moe_route(logits, mask, x, **kw)
                    r["cold_device_ms"] = cs.device_ms_by_name(
                        [cold] * args.reps, cs.ROUTE_KERNELS)
                print(json.dumps({"variant": name, "round": rnd,
                                  "model": model, "case": label,
                                  "tokens": x.shape[0], **r,
                                  "device_ms": ms}), flush=True)
    use(libs[next(iter(libs))])
    for model, label, kw, logits, mask, x in timed:
        first = moe_ops.moe_route(logits, mask, x, **kw)
        rk = first.rows[first.weights > 0]
        differ = 0
        for _ in range(args.repeats):
            r = moe_ops.moe_route(logits, mask, x, **kw)
            differ += not (all(torch.equal(a, b)
                               for a, b in zip(first[:-1], r[:-1]))
                           and torch.equal(first.xbuf[rk], r.xbuf[rk]))
        ok &= differ == 0
        print(json.dumps({"variant": next(iter(libs)), "model": model,
                          "case": label, "repeats": args.repeats,
                          "differ": differ}), flush=True)
    one = torch.zeros(1, device=dev)
    print(json.dumps({"launch_floor": "one-element add_", "device_ms":
                      cs.device_ms_by_name([lambda: one.add_(1.0)]
                                           * args.reps, None)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
