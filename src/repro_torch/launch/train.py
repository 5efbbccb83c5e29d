"""Training launcher of the PyTorch port: LoRA fine-tuning over a frozen
(optionally crossbar-quantized) base, on the CUDA card by default.

  # full-width llama3.2-1b, M8F8 base, on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --quant M8F8 --steps 20 --batch 4 --seq 512 --microbatches 2

  # noise-aware fine-tuning of the paper's GPT-2-medium
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch paper-gpt2-medium --quant M8F8 --noise-sigma 0.02 --steps 20

  # full-width rwkv6-7b (the wkv forward and backward kernels)
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
      --quant M8F8 --steps 10 --batch 4 --seq 512 --microbatches 2

  # smoke size on the CPU (the kernels' plain versions)
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --device cpu --steps 10

The flags are the JAX launcher's (``repro.launch.train``) plus
``--device``; like it, the launcher has no remat flag (``Trainer`` takes
``exec_cfg=ExecConfig(remat=True)``). Weights are random from ``--seed`` (the two frameworks'
generators differ, so the same seed gives other weights than JAX's).
"""
from __future__ import annotations

import argparse
import re

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import quant as quant_lib
from repro_torch.core.noise import NoiseConfig
from repro_torch.data.pipeline import make_dataset
from repro_torch.models.transformer import ExecConfig, init_params
from repro_torch.optim.adamw import AdamWConfig, warmup_cosine
from repro_torch.train.steps import TrainHParams
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--quant", default="bf16", help="bf16 | M8F8 | M8F4 | ...")
    ap.add_argument("--noise-sigma", type=float, default=0.0,
                    help="noise-aware fine-tuning sigma_rel")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data", default=None, help="memmap token file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device=device)
    if args.quant != "bf16":
        m = re.fullmatch(r"M(\d+)F(\d+)", args.quant)
        if m is None:
            raise ValueError(f"--quant {args.quant!r}: bf16 or MnFm")
        qc = QuantConfig(mha_bits=int(m.group(1)), ff_bits=int(m.group(2)))
        params = quant_lib.quantize_params(params, qc, min_size=1)
        print(f"quantized base ({qc.tag})")

    noise = NoiseConfig(enabled=args.noise_sigma > 0,
                        sigma_rel=args.noise_sigma)
    ec = ExecConfig(noise=noise)
    hp = TrainHParams(
        microbatches=args.microbatches,
        adamw=AdamWConfig(lr=args.lr,
                          schedule=warmup_cosine(args.steps // 10, args.steps)))
    tc = TrainerConfig(seq_len=args.seq, global_batch=args.batch,
                       steps=args.steps, ckpt_dir=args.ckpt_dir,
                       hparams=hp, seed=args.seed)
    ds = make_dataset(cfg.vocab_size, args.seed, args.data)
    tr = Trainer(cfg, tc, ds, exec_cfg=ec, params=params, device=device)
    tr.maybe_restore()
    log = tr.run_with_restarts()
    if log:
        print(f"done: {len(log)} steps, loss {log[0]['loss']:.4f} -> "
              f"{log[-1]['loss']:.4f}")
    else:
        print(f"done: restored at step {tr.step}, nothing left to run")
    return log


if __name__ == "__main__":
    main()
