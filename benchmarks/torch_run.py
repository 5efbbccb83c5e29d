"""Benchmark driver of the port: every ``benchmarks/torch_*.py`` figure
script and ``torch_kernels.py``, under the names of ``benchmarks/run.py``.
Prints ``name,us_per_call,derived`` CSV rows; each script writes its JSON
under ``experiments/paper/``, and the driver a consolidated
``TORCH_BENCH_SUMMARY.json`` there (never the JAX driver's
``BENCH_SUMMARY.json``).

    PYTHONPATH=src:. python benchmarks/torch_run.py [--smoke] [--only NAME] \\
        [--device cpu]

The scripts that run the model run on the CUDA card by default and on
the CPU given ``--device cpu``; the analytic ones need no device.
``--smoke`` (or ``BENCH_SMOKE=1``) shrinks the workloads that read it, as
with the JAX driver. Exits 1 if any script fails.
"""
import argparse
import importlib
import json
import os
import sys
import traceback

# (run.py's name, the port's script, whether its run() takes a device)
MODULES = (
    ("tableII", "torch_kernel_complexity", True),
    ("fig6_systolic", "torch_systolic_config", False),
    ("fig7_breakdown", "torch_compute_breakdown", True),
    ("fig8_noc", "torch_noc", False),
    ("fig9_noise", "torch_noise", True),
    ("fig10_pipeline", "torch_pipeline_stages", False),
    ("fig11_15_end2end", "torch_end2end", False),
    ("fig12_14_quant_energy", "torch_quant_energy", False),
    ("fig13_quant_ppl", "torch_quant_perplexity", True),
    ("kernels", "torch_kernels", True),
    ("serve_throughput", "torch_serve_throughput", True),
)
SUMMARY = "TORCH_BENCH_SUMMARY.json"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced workloads (BENCH_SMOKE=1)")
    ap.add_argument("--only", default=None,
                    help="run a single benchmark by name")
    ap.add_argument("--device", default=None,
                    help="torch device of the scripts that run the model "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.smoke:
        os.environ["BENCH_SMOKE"] = "1"
    mods = MODULES
    if args.only:
        mods = [m for m in MODULES if m[0] == args.only]
        if not mods:
            sys.exit(f"unknown benchmark {args.only!r}")

    from benchmarks import torch_common
    print("name,us_per_call,derived")
    failures = 0
    for name, script, takes_device in mods:
        try:
            mod = importlib.import_module(f"benchmarks.{script}")
            mod.run(args.device) if takes_device else mod.run()
        except Exception:  # noqa: BLE001 - every failure is counted below
            failures += 1
            print(f"{name},nan,FAILED")
            traceback.print_exc()
    summary = {"smoke": os.environ.get("BENCH_SMOKE", "0") == "1",
               "device": args.device or "cuda", "failures": failures,
               "rows": [{"name": n, "us_per_call": u, "derived": d}
                        for n, u, d in torch_common.ROWS]}
    torch_common.OUT.mkdir(parents=True, exist_ok=True)
    (torch_common.OUT / SUMMARY).write_text(json.dumps(summary, indent=1))
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
