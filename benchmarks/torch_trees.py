"""A kernel's cases on two trees of the repository, in turns on one card:
the same cases, before and after a change.

    PYTHONPATH=src python benchmarks/torch_trees.py OTHER_TREE \\
        --cases {flash,moe,scan} [...] [--serve]

OTHER_TREE is a checkout (or ``git archive``) of another commit, e.g. the
parent, unpacked under ``build/``. Each tree's kernel sources for the chosen
case sets are built first, in parallel, each into its own
``build/repro_torch/``; then four turns, other, this, this, other, each in a
process of its own with that tree's ``repro_torch`` first on the path, run
this tree's ``chip_smoke.py`` cases against their plain versions:

  * ``flash``: the flash forward (the kernel phase's cases: llama3.2-1b's at
    head dim 64, gemma2-9b's at 256, head dim 128 at 32/8, the MoE models'
    and the head-dim-128 forwards' heads), with SDPA's device ms;
  * ``moe``: ``grouped_crossbar_matmul`` on llama4-scout's 16 (5120, 8192)
    and (8192, 5120) expert stacks, int8 and int4, at 8 decode rows on 8
    experts, on one, and 8 tokens top-2; mixtral's 8 (6144, 16384) and
    (16384, 6144), int8, on 8 experts and on one; jamba's 16 (8192, 24576)
    and (24576, 8192), int8, top-2 (the device time counts the grouped
    kernels of either tree's names); a whole dropless llama4-scout MoE
    layer at a decode tick (device ms, device kernels a call, and the ms of
    the kernels that are neither grouped nor crossbar); on a tree that has
    them, ``moe_route`` and ``moe_combine`` at the three MoE models' ticks;
  * ``scan``: ``selective_scan`` at jamba's width (``SCAN_CASES``: decode
    on 8 slots, the verify tick, a 128-token chunk on 8 slots and the same
    chunk ragged, a 512-token and a 4096-token prompt), each with its bound
    (``chip_smoke.scan_bound``) and the exponentials' time beside it.

With ``--serve``, two more turns, other then this, each serve
jamba-1.5-large-398b at one scan period as ``chip_smoke.py`` does
(``moe_serve_phase``, without speculation), with a traced window of graph
decode ticks and one of replayed mixed ticks; each prints the two windows'
device ms a tick and the scans' share.

Each output line is one JSON object with its tree; the card's name and power
limit come first. The exit code is 1 when a build fails or a case fails its
check. Comparing the trees only within one call keeps them on one card.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the kernel sources each case set builds (those a tree has)
SOURCES = {"flash": ("flash_attention",),
           "moe": ("crossbar_matmul", "moe_route"),
           "scan": ("selective_scan",)}
# the grouped decode kernel's name before the work list (PR 28)
OLD_GROUPED = ("grouped_decode_kernel<",)
KEYS = ("name", "model", "case", "kernel", "bits", "shape", "max_abs_err",
        "max_rel_err", "tol", "same_bits", "idle_row_kept", "ms",
        "device_ms", "host_us", "library_device_ms", "plain_device_ms",
        "plain_device_kernels", "device_kernels", "other_device_ms",
        "grouped_and_crossbar_device_ms", "launches", "bound_ms", "bound_by",
        "bound_pieces_ms", "bound_parts_ms", "ok")
WINDOW_KEYS = ("ticks", "replayed", "device_ms_per_tick",
               "traced_wall_ms_per_tick", "device_busy_share",
               "prefill_tokens_per_tick", "scan_device_ms_per_tick",
               "scan_share_of_device", "traced_launches_per_tick")


def build(tree: Path, sets) -> subprocess.Popen:
    names = sorted({n for s in sets for n in SOURCES[s]})
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; "
            "build.build([n for n in sys.argv[2:] if n in build.SOURCES], "
            "force=True)")
    return subprocess.Popen([sys.executable, "-c", code, str(tree / "src"),
                             *names])


def case_gens(cs, dev, g, name):
    """The generators of case set ``name``."""
    from repro_torch import kernels

    if name == "flash":
        return [cs.flash_cases(dev, g, "llama3.2-1b", 32, 8),
                cs.paged_cases(dev, g, "llama3.2-1b", 32, 8),
                cs.gemma_attention_cases(dev, g),
                cs.moe_attention_cases(dev, g),
                cs.head_dim_128_cases(dev, g)]
    if name == "moe":
        cs.GROUPED_KERNELS = OLD_GROUPED + cs.GROUPED_KERNELS
        dists = ("decode_spread", "decode_one", "decode_top2")
        gens = [cs.grouped_cases(dev, g, "llama4-scout-17b-a16e", 16,
                                 cs.LLAMA4_KN, dists=dists),
                cs.grouped_cases(dev, g, "mixtral-8x22b", 8, cs.MIXTRAL_KN,
                                 bits_list=(8,), dists=dists[:2]),
                cs.grouped_cases(dev, g, "jamba-1.5-large-398b", 16,
                                 cs.JAMBA_KN, bits_list=(8,),
                                 dists=("decode_top2",)),
                cs.moe_layer_cases(dev, g, (("llama4-scout-17b-a16e",
                                             cs.MOE_TICKS[:1]),))]
        if "moe_route" in kernels.LAUNCHES:
            gens.append(cs.moe_route_cases(dev, g))
        return gens
    return [(cs.scan_case(dev, g, *c) for c in cs.SCAN_CASES)]


def turn(tree: Path, label: str, kind: str, sets) -> int:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if kind == "serve":
        from repro_torch.configs import get_config

        torch.zeros(1, device=dev)      # the memory counters need a context
        line, _ = cs.moe_serve_phase(dev, get_config("jamba-1.5-large-398b"),
                                     **{**cs.SERVE_KW["jamba-1.5-large-398b"],
                                        "spec": None})
        for window in ("traced_decode_ticks", "traced_mixed_ticks"):
            w = line[window]
            print(json.dumps({"tree": label, "window": window,
                              **{k: w[k] for k in WINDOW_KEYS}}), flush=True)
        return 0
    ok = True
    for name in sets:
        g = torch.Generator(device=dev).manual_seed(0)
        for gen in case_gens(cs, dev, g, name):
            for c in gen:
                c.setdefault("ok", c["max_abs_err"] <= c["tol"])
                ok &= c["ok"]
                print(json.dumps({"tree": label, "set": name,
                                  **{k: c[k] for k in KEYS if k in c}}),
                      flush=True)
    return 0 if ok else 1


def main() -> int:
    if sys.argv[1:2] == ["--turn"]:
        tree, label, kind, *sets = sys.argv[2:]
        return turn(Path(tree), label, kind, sets)
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--cases", nargs="+", choices=tuple(SOURCES),
                    required=True)
    ap.add_argument("--serve", action="store_true")
    args = ap.parse_args()
    other = args.other.resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    procs = [build(other, args.cases), build(ROOT, args.cases)]
    if any(p.wait() != 0 for p in procs):
        print("build failed", file=sys.stderr)
        return 1
    turns = [(other, "other", "cases"), (ROOT, "this", "cases"),
             (ROOT, "this", "cases"), (other, "other", "cases")]
    if args.serve:
        turns += [(other, "other", "serve"), (ROOT, "this", "serve")]
    for tree, label, kind in turns:
        rc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                             "--turn", str(tree), label, kind,
                             *args.cases]).returncode
        if rc != 0:
            print(f"turn {label} ({kind}) failed: rc {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
