"""End-to-end driver on the port (counterpart of
``examples/finetune_qlora.py``): QLoRA fine-tune a ~100M-param decoder for
a few hundred steps with checkpointing, restart tolerance, and eval, on
the CUDA card by default.

Presets:
    --preset 100m   12L x d512 x ff2048, vocab 32000 (~92M params)
    --preset 10m    (default) 6L x d256, vocab 8192

    PYTHONPATH=src python examples/torch_finetune_qlora.py --steps 300 [--device cpu]

The flags are the JAX example's plus ``--device``. ``--ckpt-dir``
defaults to ``repro_torch_qlora_ckpt`` in the temporary directory
(``TMPDIR``); a run that finds a checkpoint there resumes from it.
"""
import argparse
import os
import re
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (AttnConfig, LoRAConfig, ModelConfig,
                                      QuantConfig)
from repro_torch.core import quant
from repro_torch.core.noise import NoiseConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import AdamWConfig, warmup_cosine
from repro_torch.train.steps import TrainHParams
from repro_torch.train.trainer import Trainer, TrainerConfig

PRESETS = {
    "100m": dict(n_layers=12, d_model=512, n_heads=8, d_ff=2048,
                 vocab_size=32000),
    "10m": dict(n_layers=6, d_model=256, n_heads=4, d_ff=1024,
                vocab_size=8192),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="10m", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--quant", default="M8F8")
    ap.add_argument("--noise-sigma", type=float, default=0.01)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_qlora_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    p = PRESETS[args.preset]
    cfg = ModelConfig(
        name=f"qlora-{args.preset}", family="dense",
        n_kv_heads=max(1, p["n_heads"] // 2),
        attn=AttnConfig(pattern=("full",)),
        lora=LoRAConfig(rank=16, alpha=16.0, targets=("wq", "wv")),
        **p).validate()
    print(f"model: {cfg.param_count()/1e6:.0f}M params "
          f"(trainable LoRA: {cfg.lora_param_count()/1e6:.2f}M)")

    base = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    if args.quant != "bf16":
        m = re.fullmatch(r"M(\d+)F(\d+)", args.quant)
        base = quant.quantize_params(
            base, QuantConfig(mha_bits=int(m.group(1)),
                              ff_bits=int(m.group(2))), min_size=1)
        print(f"base quantized crossbar-wise ({args.quant})")

    ds = SyntheticLM(cfg.vocab_size, seed=0)
    ec = tfm.ExecConfig(noise=NoiseConfig(enabled=args.noise_sigma > 0,
                                          sigma_rel=args.noise_sigma))
    tc = TrainerConfig(
        seq_len=args.seq, global_batch=args.batch, steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=max(50, args.steps // 5),
        log_every=20,
        hparams=TrainHParams(
            microbatches=2,
            adamw=AdamWConfig(lr=3e-3,
                              schedule=warmup_cosine(args.steps // 10,
                                                     args.steps))))
    trainer = Trainer(cfg, tc, ds, exec_cfg=ec, params=base, device=dev)
    trainer.maybe_restore()
    log = trainer.run_with_restarts()

    # eval perplexity on held-out batches
    nll = []
    with torch.no_grad():
        for i in range(5):
            b = ds.batch(10_000 + i, 16, args.seq)
            lg, _, _ = tfm.forward(
                cfg, base, {"tokens": torch.from_numpy(b["tokens"]).to(dev)},
                lora=trainer.lora, mode="train")
            nll.append(float(tfm.lm_loss(
                cfg, lg, torch.from_numpy(b["labels"]).to(dev))[0]))
    print(f"train loss {log[0]['loss']:.3f} -> {log[-1]['loss']:.3f}; "
          f"eval ppl {np.exp(np.mean(nll)):.2f} "
          f"(corpus floor ~{np.exp(ds.entropy_bound()):.2f})")
    return log, float(np.exp(np.mean(nll)))


if __name__ == "__main__":
    main()
