"""How often the first CPU ``torch.exp`` of a fresh process is off, with
and without ``repro_torch.kernels`` imported before it.

    PYTHONPATH=src python benchmarks/torch_cpu_first_exp.py [--pairs 150]
        [--jobs 3]

Each pair starts two fresh processes side by side, beside a third that
only spins for half a second (CPU load): one ("bare") makes its first
``torch.exp`` call on 32768 f32 elements over 2 intra-op threads; the
other ("port") imports ``repro_torch.kernels`` first, which runs torch's
transcendental CPU kernels once at import, then makes the same call.
Each process prints the call's largest error relative to the f64 exp;
one above 1e-6 counts as off (the f32 exp is good to ~6e-8). Prints one
JSON object: per mode, the processes run, those off, and the largest
error seen.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PROBE = """
import sys, torch
if sys.argv[1] == "port":
    import repro_torch.kernels  # noqa: F401 (its import runs the warm-up)
torch.set_num_threads(2)
x = torch.linspace(-20.0, 5.0, 32768)
ref = torch.exp(x.double())
print(float(((torch.exp(x).double() - ref).abs() / ref).max()))
"""
SPIN = "import time\nt = time.time()\nwhile time.time() - t < 0.5: pass"


def one_pair(env) -> dict:
    procs = {mode: subprocess.Popen([sys.executable, "-c", PROBE, mode],
                                    stdout=subprocess.PIPE, text=True,
                                    env=env)
             for mode in ("bare", "port")}
    spin = subprocess.Popen([sys.executable, "-c", SPIN])
    out = {mode: float(p.communicate()[0]) for mode, p in procs.items()}
    spin.wait()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=150)
    ap.add_argument("--jobs", type=int, default=3)
    args = ap.parse_args()
    src = str(Path(__file__).resolve().parent.parent / "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    with ThreadPoolExecutor(args.jobs) as pool:
        runs = list(pool.map(lambda _: one_pair(env), range(args.pairs)))
    print(json.dumps({
        mode: {"processes": len(runs),
               "off": sum(r[mode] > 1e-6 for r in runs),
               "max_rel_err": max(r[mode] for r in runs)}
        for mode in ("bare", "port")}))


if __name__ == "__main__":
    main()
