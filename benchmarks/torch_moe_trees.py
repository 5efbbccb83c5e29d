"""The MoE decode's kernel cases on two trees of the repository, in turns
on one card: the same cases, before and after a change.

    PYTHONPATH=src python benchmarks/torch_moe_trees.py OTHER_TREE

OTHER_TREE is a checkout (or ``git archive``) of another commit, e.g. the
parent, unpacked under ``build/``. Each tree's kernel sources are built
first, in parallel, each into its own ``build/repro_torch/``; then four
turns, other, this, this, other, each in a process of its own with that
tree's ``repro_torch`` first on the path, run this tree's ``chip_smoke.py``
cases against their plain versions:

  * ``grouped_crossbar_matmul`` on llama4-scout's 16 (5120, 8192) and
    (8192, 5120) expert stacks, int8 and int4, at 8 decode rows on 8
    experts, on one, and 8 tokens top-2; mixtral's 8 (6144, 16384) and
    (16384, 6144), int8, on 8 experts and on one; jamba's 16 (8192,
    24576) and (24576, 8192), int8, top-2 (the device time counts the
    grouped kernels of either tree's names);
  * a whole dropless llama4-scout MoE layer at a decode tick
    (``moe_layer_cases``: device ms and device kernels a call, and the ms
    of the kernels that are neither grouped nor crossbar);
  * on a tree that has them, ``moe_route`` and ``moe_combine`` at the
    three MoE models' ticks (``moe_route_cases``), whose plain versions'
    device time on the same card is the other tree's torch ops.

Each case line gives the tree, the turn, the case's error, device ms and
bound; the card's name and power limit come first. Comparing the trees
only within one call keeps them on one card.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the grouped decode kernel's name before the work list, and after it
OLD_GROUPED = ("grouped_decode_kernel<",)
KEYS = ("name", "model", "case", "bits", "kernel", "max_abs_err", "tol",
        "device_ms", "bound_ms", "bound_by", "plain_device_ms",
        "plain_device_kernels", "device_kernels", "other_device_ms",
        "grouped_and_crossbar_device_ms", "launches", "same_bits", "ok")


def build(tree: Path) -> subprocess.Popen:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; "
            "names = [n for n in ('crossbar_matmul', 'moe_route') "
            "if n in build.SOURCES]; build.build(names, force=True)")
    return subprocess.Popen([sys.executable, "-c", code, str(tree / "src")])


def turn(tree: Path, label: str) -> None:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.GROUPED_KERNELS = OLD_GROUPED + cs.GROUPED_KERNELS
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
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
    for gen in gens:
        for c in gen:
            print(json.dumps({"tree": label, **{k: c[k] for k in KEYS
                                                if k in c}}), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--turn"]:
        turn(Path(sys.argv[2]), sys.argv[3])
        return 0
    other = Path(sys.argv[1]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    procs = [build(other), build(ROOT)]
    if any(p.wait() != 0 for p in procs):
        print("build failed", file=sys.stderr)
        return 1
    for tree, label in ((other, "other"), (ROOT, "this"), (ROOT, "this"),
                        (other, "other")):
        rc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                             "--turn", str(tree), label]).returncode
        if rc != 0:
            print(f"turn {label} failed: rc {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
