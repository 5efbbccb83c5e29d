"""The flash forward's kernel cases on two trees of the repository, in
turns on one card: the same cases, before and after a change.

    PYTHONPATH=src python benchmarks/torch_flash_trees.py OTHER_TREE

OTHER_TREE is a checkout (or ``git archive``) of another commit, e.g. the
parent, unpacked under ``build/``. Both trees' ``csrc/flash_attention.cu``
are built first, in parallel, each into its own ``build/repro_torch/``;
then four turns, other, this, this, other, each in a process of its own
with that tree's ``repro_torch`` first on the path, run this tree's
``chip_smoke.py`` flash cases (the kernel phase's: llama3.2-1b's at head
dim 64, gemma2-9b's at 256, head dim 128 at 32/8, the MoE models' and the
head-dim-128 forwards' heads) against their plain versions. Each case line
gives the tree, the turn, the kernel's error, its device ms (profiler,
10 calls), SDPA's and the bounds; the card's name and power limit come
first. Comparing the trees only within one call keeps them on one card.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def build(tree: Path) -> subprocess.Popen:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; "
            "build.build(['flash_attention'], force=True)")
    return subprocess.Popen([sys.executable, "-c", code, str(tree / "src")])


def turn(tree: Path, label: str) -> None:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    gens = (cs.flash_cases(dev, g, "llama3.2-1b", 32, 8),
            cs.paged_cases(dev, g, "llama3.2-1b", 32, 8),
            cs.gemma_attention_cases(dev, g),
            cs.moe_attention_cases(dev, g),
            cs.head_dim_128_cases(dev, g))
    for gen in gens:
        for c in gen:
            print(json.dumps({
                "tree": label, "name": c["name"], "model": c["model"],
                "case": c["case"], "D": c["shape"]["D"],
                "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                "device_ms": c["device_ms"],
                "library_device_ms": c["library_device_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "bound_pieces_ms": c["bound_pieces_ms"]}), flush=True)


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
