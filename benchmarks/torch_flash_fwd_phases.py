"""Where the head-dim 128 / 256 flash forward's row-tile kernel spends its
time, phase by phase, on the card.

    PYTHONPATH=src python benchmarks/torch_flash_fwd_phases.py

Copies of ``src/repro_torch/csrc/flash_attention.cu`` in which one phase
of ``wg_body`` is cut out (the producer's bulk copies, q's pieces, the
split of a tile into its planes, the scores' wgmmas, the mask and online
softmax, the p.v wgmmas; and all of them) are compiled by nvcc into
``build/flash_fwd_phases/`` and timed through the port's wrappers (the
flash kernels' device time in a profiler trace, 10 calls) at the kernel
phase's shapes: the 32/8 prefill at head dim 128 (T = S = 512),
llama4-scout's paged mixed tick at 128 (40/8 heads, chunks of 128),
gemma2-9b's paged mixed tick at head dim 256 (16/8, softcap 50) and its
prefill of 4608 tokens with the 4096 window. A
cut copy computes garbage: only its time is read, and the time a phase
adds on top of the rest is the full kernel's less the cut one's. Each
variant's registers and spills (``-Xptxas=-v``) stand beside it.

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

# (phase, first text of the phase, the text that follows it) in wg_body
PHASES = (
    ("loads", "        if (RING && k < keys.n_rt) {",
     "      }\n      if (it + 1 < i1 - i0) k = scan(k + 1);"),
    ("q", "    for (int u = tid; u < RB * CH; u += NC) {",
     "    fence_async_smem();\n    const uint32_t qb_a"),
    ("split", "      const float* rk = raw + static_cast<size_t>(st)",
     "      // the positions, for the mask"),
    ("scores", "#pragma unroll\n      for (int k8 = 0; k8 < KS; ++k8) {",
     "      wgmma_commit();\n      wgmma_wait_all();\n      keep(sc);"),
    ("softmax", "      uint32_t vis = 0;", "      // acc += p . v"),
    ("pv", "#pragma unroll\n      for (int j = 0; j < NJ; ++j) {\n"
           "        const uint32_t vo",
     "      wgmma_commit();\n      wgmma_wait_all();\n      keep(acc);"),
)
VARIANTS = {"full": (), "no_loads": ("loads",), "no_q": ("q",),
            "no_split": ("split",), "no_scores": ("scores",),
            "no_softmax": ("softmax",), "no_pv": ("pv",),
            "sync_only": tuple(p[0] for p in PHASES)}
BODY = "__device__ __forceinline__ void wg_body("


def cut_source(src: str, cut) -> str:
    head, body = src.split(BODY, 1)
    for name, start, end in PHASES:
        a = body.index(start)            # raises if the kernel changed
        b = body.index(end, a)
        if name in cut:
            body = body[:a] + body[b:]
    return head + BODY + body


def ptxas_of(log: str, kernel: str) -> str:
    """Registers and spills of one instantiation, from -Xptxas=-v."""
    lines = log.splitlines()
    for n, line in enumerate(lines):
        if "Function properties" in line and kernel in line:
            spill = lines[n + 1].strip()
            used = re.sub(r"^ptxas info\s*:\s*", "", lines[n + 2].strip())
            return f"{used}; {spill}"
    return "not found"


def main():
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    out_dir = ROOT / "build" / "flash_fwd_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, cut in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(cut_source(src, cut))
        so = out_dir / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, regs = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        # the contiguous kernels at 128 (row tiles) and 256 (decode), by
        # mangled name
        regs[name] = {k: ptxas_of(log, k) for k in (
            "12flash_kernelILi128ELb0E", "12flash_kernelILi256ELb0E")}
        libs[name] = so
    print(json.dumps({"ptxas": regs}), flush=True)

    def use(name):
        build.load = lambda _n, so=libs[name]: ctypes.CDLL(str(so))
        fa._LIB = None

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    i32 = dict(dtype=torch.int32, device=dev)

    def contiguous(B, T, S, Hq, Hkv, D, **kw):
        q = torch.randn(B, T, Hq, D, generator=g, device=dev)
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev)
        qp = (torch.arange(T, **i32) + (S - T))[None].expand(B, T)
        kp = torch.arange(S, **i32)[None].expand(B, S)
        qp, kp = qp.contiguous(), kp.contiguous()
        return lambda: fa.flash_attention(q, k, v, qp, kp, **kw)

    def paged_mixed(Hq, Hkv, D, lens, nb, P, **kw):
        page, B, C = 16, len(lens), 128
        lens = torch.tensor(lens, **i32)
        clens = torch.tensor([128, 128, 128, 100, 128, 1, 1, 0], **i32)
        bt = torch.randperm(P, generator=g, device=dev)[:B * nb]
        bt = bt.reshape(B, nb).to(torch.int32)
        kp = torch.randn(P, Hkv, page, D, generator=g, device=dev)
        vp = torch.randn(P, Hkv, page, D, generator=g, device=dev)
        q = torch.randn(B, C, Hq, D, generator=g, device=dev)
        pos = (lens[:, None] + torch.arange(C, device=dev)[None]).to(
            torch.int32)
        return lambda: fa.paged_flash_attention(q, kp, vp, pos, bt, lens,
                                                clens, page_size=page, **kw)

    cases = {
        "prefill_d128_32_8": contiguous(1, 512, 512, 32, 8, 128),
        "paged_mixed_d128_40_8": paged_mixed(
            40, 8, 128, [0, 128, 256, 384, 40, 700, 1000, 0], 63, 512),
        "paged_mixed_d256_gemma2": paged_mixed(
            16, 8, 256, [0, 128, 2048, 4352, 40, 4700, 300, 0], 320, 2600,
            softcap=50.0),
        "prefill_d256_gemma2": contiguous(1, 4608, 4608, 16, 8, 256,
                                          window=4096, softcap=50.0),
    }
    for case, fn in cases.items():
        times = {}
        for name in VARIANTS:
            use(name)
            times[name] = cs.device_ms_by_name([fn] * 10, cs.FA_KERNELS)
        print(json.dumps({"case": case, "device_ms": times}), flush=True)


if __name__ == "__main__":
    main()
