"""Whether what runs before ``chip_smoke.py``'s train phase slows its
``Trainer`` step: ``--arch`` (paper-gpt2-medium, whose step is host-bound
on the card, or llama3.2-1b) at full width and depth on an M8F8 base,
with ``chip_smoke.train_phase``'s batches (4 x 512 tokens in 2
microbatches), hyperparameters and a checkpoint every 10 steps. In one
process the Trainer's steps are timed at the start, then after each
stage of ``--stages``, parts of ``chip_smoke.py`` any of which could
leave state behind that slows a later phase:

  traces  ``--traces`` profiler sessions, each of one tiny kernel (as
          ``chip_smoke.device_ms`` takes them; its kernel cases take two
          each)
  cases   the int4 and Fig. 13 kernel cases
          (``chip_smoke.slice10_cases``)
  paged   its serve phase of full-width llama3.2-1b by the paged engine
  dense   the same serve phase with the dense engine after the paged one

Each timing is ``--rounds`` fresh Trainers of ``--steps`` steps: one JSON
line per Trainer (its step ms and their median, the first step left out,
as ``chip_smoke.py`` counts them), and the host's microseconds per launch
of a tiny kernel (``launch_us``: the least of 5 runs of 4000 launches),
which a host-bound step pays per kernel; then the medians by stage. The
first line is the card's name and power limit.

    PYTHONPATH=src python benchmarks/torch_train_history.py [--rounds 2]
        [--steps 20] [--traces 100] [--arch llama3.2-1b]
        [--stages traces,cases,dense]

Runs on the CUDA card only.
"""
import argparse
import gc
import shutil
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs                                   # noqa: E402


def m8f8_base(dev, arch):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core import quant
    from repro_torch.models import transformer as tfm

    cfg = get_config(arch)
    base = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    return cfg, quant.quantize_params(base, QuantConfig(mha_bits=8,
                                                        ff_bits=8))


def trainer_ms(dev, cfg, params, steps):
    """Step ms of a fresh ``Trainer`` set up as ``chip_smoke.train_phase``
    sets up its own."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import steps as st
    from repro_torch.train.trainer import Trainer, TrainerConfig

    ckpt = cs.CKPT_ROOT / "train_history"
    shutil.rmtree(ckpt, ignore_errors=True)
    hp = st.TrainHParams(
        microbatches=cs.TRAIN_MICROBATCHES, adamw=adamw.AdamWConfig(
            lr=1e-3, schedule=adamw.warmup_cosine(max(steps // 10, 1),
                                                  steps)))
    tc = TrainerConfig(seq_len=cs.TRAIN_SEQ, global_batch=cs.TRAIN_BATCH,
                       steps=steps, ckpt_dir=str(ckpt),
                       ckpt_every=cs.CKPT_EVERY, hparams=hp, seed=0,
                       log_every=steps)
    tr = Trainer(cfg, tc, SyntheticLM(cfg.vocab_size, seed=0),
                 params=params, device=dev)
    torch.cuda.synchronize()
    ms = [1e3 * r["sec"] for r in tr.run()]
    del tr
    shutil.rmtree(ckpt, ignore_errors=True)
    return ms


def launch_us(dev, n=4000, runs=5):
    """Host microseconds per launch of a one-element add (the least of
    ``runs`` runs of ``n``)."""
    x = torch.zeros(1, device=dev)
    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            x.add_(1)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t) / n)
    return 1e6 * best


def profiler_sessions(dev, n):
    x = torch.zeros(1, device=dev)
    for _ in range(n):
        cs.device_ms(lambda: x.add_(1), reps=1)


def new_kernel_cases(dev):
    return len(cs.kernel_phase(dev, cs.slice10_cases))


def llama_serve(dev, dense):
    from repro_torch.configs import get_config

    _, eng = cs.serve_phase(dev, get_config("llama3.2-1b"), dense=dense)
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--traces", type=int, default=100)
    ap.add_argument("--arch", default="paper-gpt2-medium")
    ap.add_argument("--stages", default="traces,cases,dense")
    args = ap.parse_args()
    parts = {"traces": lambda: profiler_sessions(dev, args.traces),
             "cases": lambda: cs.emit({"kernel_cases":
                                       new_kernel_cases(dev)}),
             "paged": lambda: llama_serve(dev, dense=False),
             "dense": lambda: llama_serve(dev, dense=True)}
    stages = args.stages.split(",")
    if not set(stages) <= set(parts):
        sys.exit(f"--stages: each of {sorted(parts)}")
    if not torch.cuda.is_available():
        sys.exit("torch_train_history: needs a CUDA card")
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.emit({"nvidia_smi": cs.smi_line()})
    build.build()
    cfg, params = m8f8_base(dev, args.arch)
    medians, launches = {}, {}

    def timed(stage):
        for r in range(args.rounds):
            ms = trainer_ms(dev, cfg, params, args.steps)
            med = statistics.median(ms[1:])
            medians.setdefault(stage, []).append(med)
            us = launch_us(dev)
            launches.setdefault(stage, []).append(us)
            cs.emit({"stage": stage, "round": r, "median_ms": med,
                     "launch_us": us, "step_ms": ms})

    timed("start")
    for i, stage in enumerate(stages):
        parts[stage]()
        timed(f"{i + 1}: after {stage}")
    cs.emit({"arch": args.arch, "medians_ms": medians,
             "launch_us": launches})


if __name__ == "__main__":
    main()
