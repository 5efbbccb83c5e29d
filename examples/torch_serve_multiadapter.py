"""Batched multi-adapter serving on the port (paper SS V.G; counterpart of
``examples/serve_multiadapter.py``): one frozen quantized base, several
LoRA adapters hot simultaneously, continuous batching over a PAGED KV
arena: admission is bounded by page occupancy, prompts prefill in
bucketed chunks, one mixed step (a CUDA graph per signature on the card)
serves prefill + decode rows, and requests sharing a prompt prefix (same
adapter) map the same KV pages via the copy-on-write prefix cache instead
of recomputing them.

    PYTHONPATH=src python examples/torch_serve_multiadapter.py [--device cpu]

Speculative decoding rides on the same engine (--spec-decode): a drafter
guesses up to --spec-k tokens per slot, the verify step checks them all at
once, and rejected tokens roll the paged KV write cursor back:

    PYTHONPATH=src python examples/torch_serve_multiadapter.py \
        --spec-decode --draft ngram --spec-k 4

It serves reduced mistral-nemo-12b (d_model 128, 4 heads), as the JAX
example does. The flags are the JAX example's. ``--draft selfdraft``
raises ``ValueError`` on this example's M8F8 base: the self-drafter
quantizes the target's weights itself and takes no quantized base (the
JAX example fails there too: its ``quantize_params`` cannot requantize
``QuantizedTensor`` leaves).
``--tp`` above 1 raises ``NotImplementedError`` (ROADMAP Queue 1 item 16).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import lora as lora_lib, quant
from repro_torch.models.transformer import init_params
from repro_torch.serve.api import Request, make_engine
from repro_torch.serve.spec import SpecConfig

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
ap.add_argument("--spec-decode", action="store_true",
                help="draft-and-verify decoding with paged-KV rollback")
ap.add_argument("--draft", choices=("ngram", "selfdraft"), default="ngram",
                help="model-free n-gram lookup, or the target model with "
                     "quantize_params-compressed weights as its own drafter "
                     "(raises on this example's quantized base)")
ap.add_argument("--spec-k", type=int, default=4,
                help="max draft tokens per slot per tick")
ap.add_argument("--tp", type=int, default=1,
                help="tensor parallelism (ROADMAP Queue 1 item 16)")
args = ap.parse_args()
if args.tp > 1:
    raise NotImplementedError("tensor-parallel serving is not ported yet "
                              "(ROADMAP Queue 1 item 16)")
dev = resolve_device(args.device)

cfg = reduce_config(get_config("mistral-nemo-12b"), d_model=128, n_heads=4)
g = torch.Generator(device=dev).manual_seed(0)
base = quant.quantize_params(init_params(cfg, g, device=dev),
                             QuantConfig(mha_bits=8, ff_bits=8), min_size=1)

# three "tasks" = three adapters (in production: one per fine-tuned domain)
adapters = [lora_lib.init_lora_params(cfg, g, device=dev) for _ in range(3)]
spec = (SpecConfig(k=args.spec_k, drafter=args.draft)
        if args.spec_decode else None)
eng = make_engine(cfg, base, adapters, mode="paged", device=dev,
                  max_slots=4, max_len=96, page_size=8, prefill_chunk=8,
                  spec=spec)

# shared system-prompt prefix per adapter, unique user tail per request:
# the common case the prefix cache exists for
rng = np.random.default_rng(0)
system = [rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
          for _ in range(3)]
t0 = time.time()
for i in range(10):
    tail = rng.integers(0, cfg.vocab_size,
                        int(rng.integers(3, 8))).astype(np.int32)
    eng.submit(Request(
        uid=i,
        prompt=np.concatenate([system[i % 3], tail]),
        max_new_tokens=12,
        adapter_id=i % 3,
        temperature=0.8 if i % 2 else 0.0))
done = eng.drain()
dt = time.time() - t0
total = sum(c.n_tokens for c in done.values())
stats = eng.stats()
print(f"{len(done)} requests / {total} tokens in {dt:.2f}s "
      f"({total/dt:.1f} tok/s) with 3 adapters hot")
print(f"prefix cache: {stats.prefix_cache.hit_tokens} prompt tokens served "
      f"from resident pages ({stats.prefix_cache.hits} hits, "
      f"{stats.scheduler.cow_forks} CoW forks)")
if args.spec_decode:
    sp = stats.spec
    print(f"spec decode [{args.draft} k={args.spec_k}]: "
          f"accept_rate={sp.accept_rate:.2f} "
          f"({sp.accepted_tokens}/{sp.drafted_tokens} drafts survived, "
          f"{sp.rolled_back_tokens} rolled back, "
          f"{stats.scheduler.rolled_back_pages} pages reclaimed)")
print(f"engine stats: {stats.as_dict()}")
for uid in sorted(done):
    c = done[uid]
    print(f"  req {uid} adapter={c.adapter_id} [{c.finish_reason}]: "
          f"{list(c.tokens)}")
