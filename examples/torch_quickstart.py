"""Quickstart on the port: QLoRA fine-tuning + serving in ~50 lines
(counterpart of ``examples/quickstart.py``), on the CUDA card by default.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import quant
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve.api import Request, make_engine
from repro_torch.train.steps import TrainHParams
from repro_torch.train.trainer import Trainer, TrainerConfig

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()
dev = resolve_device(args.device)

# 1. a small config (same structure as the full llama3.2-1b)
cfg = reduce_config(get_config("llama3.2-1b"), d_model=128, n_heads=4,
                    d_ff=256)

# 2. crossbar-wise quantize the frozen base (the paper's M8F8)
base = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                   device=dev)
base = quant.quantize_params(base, QuantConfig(mha_bits=8, ff_bits=8),
                             min_size=1)

# 3. LoRA fine-tune on a synthetic bigram corpus
ds = SyntheticLM(cfg.vocab_size, seed=0)
tc = TrainerConfig(seq_len=64, global_batch=16, steps=100, log_every=25,
                   hparams=TrainHParams(adamw=AdamWConfig(lr=5e-3)))
trainer = Trainer(cfg, tc, ds, params=base, device=dev)
log = trainer.run()
print(f"loss: {log[0]['loss']:.3f} -> {log[-1]['loss']:.3f}")

# 4. serve with the trained adapter (paged engine)
eng = make_engine(cfg, base, adapters=[trainer.lora], device=dev,
                  max_slots=2, max_len=64)
eng.submit(Request(uid=0, prompt=np.array([5, 17, 23]), max_new_tokens=8))
done = eng.drain()
print("generated:", list(done[0].tokens))
