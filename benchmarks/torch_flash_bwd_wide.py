"""The head-dim 128 / 256 flash backward's knobs, and where its consumer
warpgroups spend a streamed tile, on the card.

    PYTHONPATH=src python benchmarks/torch_flash_bwd_wide.py [--window]

Copies of ``src/repro_torch/csrc/flash_attention.cu`` are compiled by nvcc
into ``build/flash_bwd_wide/`` (all at once):

  * ``source``: the file as it stands;
  * one knob changed each: ``waves200`` (``kBWavesWidePct`` 200: more,
    shorter splits of the long lists), ``rows256`` and ``rows1024``
    (``kBMaxRowsWide``: the most streamed rows a block sums in its
    registers), ``dkdv_rows128`` (``kBSplitDkdv`` 256: at head dim 128 the
    dk/dv kernel's warpgroups own 64 of 128 keys, every column) and
    ``dq_cols128`` (``kBSplitDq`` 128: at 128 the dq kernel's warpgroups
    split the columns of 64 rows);
  * ``phases``: the file with ``clock64`` counters around each phase of a
    consumer warpgroup's tile (waiting for the stage, the S and dP
    products, the column halves' exchange, p and ds, the dV and dK (dQ)
    products with their pieces, releasing the stage) and the producer's
    wait for a free stage, read back through an ``extern "C"`` function
    of the copy: the cycles of each a tile (a warpgroup's).

Each copy is loaded in place of the built library, held against
``flash_attention_bwd_plain`` (1e-4 relative and absolute) and against
itself (two calls, the same bits), and timed: CUDA events over 30 calls,
and each kernel's device time in a profiler trace of 10 calls, at one train
microbatch (B = 2, T = S = 512, causal): gemma2-9b's 16/8 heads at head dim
256 with and without its softcap of 50, mistral-nemo's 32/8 and internlm2's
48/8 at 128. With ``--window`` also gemma2's published window of 4096 at T
= 4608 (B = 1), with the kernel's and the plain f32 version's largest error
against the plain version run in f64. The copies run in two rounds, the
second in reverse order; each copy's registers and spills
(``-Xptxas=-v``) come first.

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
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402

OUT = ROOT / "build" / "flash_bwd_wide"
KNOBS = {"waves200": ("kBWavesWidePct", 200), "rows256": ("kBMaxRowsWide", 256),
         "rows1024": ("kBMaxRowsWide", 1024),
         "dkdv_rows128": ("kBSplitDkdv", 256), "dq_cols128": ("kBSplitDq", 128)}
# (text of wide_body, the same with the counters): pf[0..5] the consumer's
# phases, pf[6] its tiles; g_prof[KV][9] the producer's waits for a stage
COUNTERS = (
    ("struct BwdParams {",
     "__device__ unsigned long long g_prof[2][16];\nstruct BwdParams {"),
    ("  const int r0 = st_tile * BT;   // the block's first key (row)\n",
     "  const int r0 = st_tile * BT;   // the block's first key (row)\n"
     "  long long pf[7] = {0, 0, 0, 0, 0, 0, 0};\n"),
    ("      mbar_wait(&empty[st], ((it / NS) & 1) ^ 1);\n",
     "      const long long e0 = clock64();\n"
     "      mbar_wait(&empty[st], ((it / NS) & 1) ^ 1);\n"
     "      if (lane == 0)\n        atomicAdd(&g_prof[KV][9], "
     "static_cast<unsigned long long>(clock64() - e0));\n"),
    ("      mbar_wait(&full[st], (it / NS) & 1);\n",
     "      long long c0 = clock64();\n"
     "      mbar_wait(&full[st], (it / NS) & 1);\n"
     "      long long c1 = clock64();\n      pf[0] += c1 - c0;\n"),
    ("      wgmma_wait_all();\n      keep(x1);\n      keep(x2);\n",
     "      wgmma_wait_all();\n      keep(x1);\n      keep(x2);\n"
     "      c0 = clock64();\n      pf[1] += c0 - c1;\n"),
    ("      // p and ds in place of X1 and X2",
     "      c1 = clock64();\n      pf[2] += c1 - c0;\n"
     "      // p and ds in place of X1 and X2"),
    ("      constexpr int NJ = BS / 16, NP = KV ? NJ : 1;\n",
     "      c0 = clock64();\n      pf[3] += c0 - c1;\n"
     "      constexpr int NJ = BS / 16, NP = KV ? NJ : 1;\n"),
    ("      wgmma_commit();\n      wgmma_wait_all();\n      keep(acc);\n"
     "      keep(acc_v);\n",
     "      wgmma_commit();\n      wgmma_wait_all();\n      keep(acc);\n"
     "      keep(acc_v);\n      c1 = clock64();\n      pf[4] += c1 - c0;\n"),
    ("      if (tw == 0) mbar_arrive(&empty[st]);\n    }\n  }\n",
     "      if (tw == 0) mbar_arrive(&empty[st]);\n"
     "      pf[5] += clock64() - c1;\n      pf[6] += 1;\n    }\n  }\n"
     "  if (tw == 0)\n    for (int i = 0; i < 7; ++i)\n"
     "      atomicAdd(&g_prof[KV][i], static_cast<unsigned long long>(pf[i]));\n"),
    ("}  // namespace\n\n// The split workspace that flash_attention_bwd needs",
     "}  // namespace\n\nextern \"C\" int read_prof(unsigned long long* h) {\n"
     "  const unsigned long long z[32] = {};\n"
     "  const cudaError_t e = cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n"
     "  return e != cudaSuccess ? e : cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n"
     "}\n\n// The split workspace that flash_attention_bwd needs"),
)
PHASES = ("wait_full", "s_dp", "exchange", "p_ds", "dkdv_or_dq", "release")
CASES = (("gemma2-9b", "causal+softcap", 2, 512, 16, 8, 256, None, 50.0),
         ("gemma2-9b", "causal, no softcap", 2, 512, 16, 8, 256, None, None),
         ("mistral-nemo-12b", "causal", 2, 512, 32, 8, 128, None, None),
         ("internlm2-20b", "causal", 2, 512, 48, 8, 128, None, None))
WINDOW = ("gemma2-9b", "window 4096+softcap", 1, 4608, 16, 8, 256, 4096, 50.0)


def variant_source(src: str, name: str) -> str:
    if name in KNOBS:
        knob, value = KNOBS[name]
        line = re.search(rf"^constexpr int {knob} = \d+;$", src, re.M)
        if line is None:           # the source changed: update KNOBS
            raise RuntimeError(f"no line 'constexpr int {knob} = ...;'")
        return (src[:line.start()] + f"constexpr int {knob} = {value};"
                + src[line.end():])
    if name == "phases":
        for old, new in COUNTERS:
            if src.count(old) != 1:   # the source changed: update COUNTERS
                raise RuntimeError(f"not once in the source: {old[:60]!r}")
            src = src.replace(old, new)
    return src


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--window", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_flash_bwd_wide: no CUDA card")
    print(chip_smoke.smi_line(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "flash_attention.cu").read_text()
    names = ("source", *KNOBS, "phases")
    procs = {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(src, name))
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log[-4000:], file=sys.stderr)
            sys.exit(f"nvcc {name} failed")
        rep = chip_smoke.ptxas_report(log)
        print(json.dumps({"variant": name, "ptxas": {
            k: v for k, v in rep.items()
            if re.search(r"(dkdv|dq)_kernel<(128|256)>", k)}}), flush=True)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    loaded = {}

    def use(name):
        fa._LIB = None
        fa._NEEDS.clear()
        loaded.setdefault(name, ctypes.CDLL(str(OUT / f"lib{name}.so")))
        load, build.load = build.load, lambda _: loaded[name]
        try:
            fa._lib()
        finally:
            build.load = load

    data = {}
    g = torch.Generator(device=dev).manual_seed(0)
    use("source")
    for model, case, B, T, Hq, Hkv, D, w, cap in CASES + (
            (WINDOW,) if args.window else ()):
        q, dout = (torch.randn(B, T, Hq, D, generator=g, device=dev)
                   for _ in range(2))
        k, v = (torch.randn(B, T, Hkv, D, generator=g, device=dev)
                for _ in range(2))
        pos = torch.arange(T, device=dev, dtype=torch.int32)[None].expand(
            B, T).contiguous()
        out, lse = fa._launch(q, k, v, pos, pos, w, cap, with_lse=True)
        a = (q, k, v, pos, pos, out, lse, dout)
        want = fa.flash_attention_bwd_plain(*a, window=w, softcap=cap)
        ref = (fa.flash_attention_bwd_plain(
            *[x.double() if x.is_floating_point() else x for x in a],
            window=w, softcap=cap) if w is not None else None)
        data[(model, case)] = (a, w, cap, want, ref)

    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            use(name)
            for (model, case), (a, w, cap, want, ref) in data.items():
                call = lambda: fa.flash_attention_bwd(  # noqa: E731
                    *a, window=w, softcap=cap)
                got, again = call(), call()
                torch.cuda.synchronize()
                r = {"round": rnd, "variant": name, "model": model,
                     "case": case,
                     "max_err_over_rel": max(float(
                         ((x - y).abs() - 1e-4 * y.abs()).max())
                         for x, y in zip(got, want)),
                     "same_bits": all(torch.equal(x, y)
                                      for x, y in zip(got, again))}
                if ref is not None:
                    r["f64_kernel_err"], r["f64_plain_err"] = (
                        max(float((x.double() - y).abs().max())
                            for x, y in zip(z, ref)) for z in (got, want))
                r["ms"] = chip_smoke.timed(call, 5 if w else 30)
                kern = chip_smoke.device_ms_per_kernel([call] * 10,
                                                       ("flash_bwd_",))
                r["device_ms"] = sum(kern.values())
                r["device_ms_by_kernel"] = {n[:80]: t for n, t in kern.items()}
                if name == "phases":
                    buf = (ctypes.c_ulonglong * 32)()
                    loaded[name].read_prof(buf)     # zeroes the counters
                    call()
                    torch.cuda.synchronize()
                    loaded[name].read_prof(buf)
                    for kv, kind in ((1, "dkdv"), (0, "dq")):
                        row = [buf[kv * 16 + i] for i in range(10)]
                        tiles = max(row[6], 1)
                        r[f"{kind}_cycles_a_tile"] = {
                            **{p: row[i] / tiles for i, p in enumerate(PHASES)},
                            "producer_wait_empty": row[9] / tiles,
                            "warpgroup_tiles": row[6]}
                print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
