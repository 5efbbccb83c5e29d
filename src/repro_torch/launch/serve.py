"""Serving launcher of the PyTorch port: batched multi-adapter LoRA
inference through the paged engine, on the CUDA card by default.

  # full-width llama3.2-1b, random weights, M8F8 crossbar base
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --requests 8 --adapters 2 --max-new 16 --max-len 1024

  # full-width, full-depth rwkv6-7b (wkv state per slot, no prefix cache)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --requests 8 --max-batch 8 --max-len 1024 --prefill-chunk 128

  # the paper's GPT-2-medium (or paper-bloom-560m), full depth
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch paper-gpt2-medium --max-batch 8 --max-len 1024

  # smoke size on the CPU (the kernels' plain versions)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch paper-gpt2-medium --smoke --device cpu

The flags are the JAX launcher's (``repro.launch.serve``) for the paged
engine. Those whose feature is not ported yet (``--spec-decode``, ``--tp``,
``--moe-dispatch capacity``, ``--prefix-cache-path``, ``--engine dense``)
raise ``NotImplementedError``; flags that would act on nothing here (the
deprecated ``--paged``, the drafter's ``--draft`` and ``--spec-k``) are
left out. The base is quantized M8F8 with the port's
``quantize_params``, as ``examples/serve_multiadapter.py`` does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import lora as lora_lib
from repro_torch.core import quant
from repro_torch.models.transformer import init_params
from repro_torch.serve.api import Request, make_engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--adapters", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", choices=("paged", "dense"), default="paged")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--prompt-families", type=int, default=0)
    ap.add_argument("--spec-decode", action="store_true")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--moe-dispatch", choices=("dropless", "capacity"),
                    default="dropless")
    ap.add_argument("--prefix-cache-path", default=None)
    args = ap.parse_args(argv)

    if args.engine != "paged":
        raise NotImplementedError("the dense oracle engine is not ported; "
                                  "the port serves through the paged engine")
    if args.spec_decode:
        raise NotImplementedError("speculative decoding is not ported yet "
                                  "(ROADMAP Queue 1 item 10)")
    if args.tp > 1:
        raise NotImplementedError("tensor-parallel serving is not ported yet "
                                  "(ROADMAP Queue 1 item 16)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
    g = torch.Generator(device=device).manual_seed(args.seed)
    params = quant.quantize_params(init_params(cfg, g, device=device),
                                   QuantConfig(mha_bits=8, ff_bits=8),
                                   min_size=1 if args.smoke else 1 << 16)
    adapters = [lora_lib.init_lora_params(cfg, g, device=device)
                for _ in range(args.adapters)]
    eng = make_engine(cfg, params, adapters, mode="paged", device=device,
                      max_slots=args.max_batch, max_len=args.max_len,
                      page_size=args.page_size, num_pages=args.num_pages,
                      prefill_chunk=args.prefill_chunk,
                      enable_prefix_cache=not args.no_prefix_cache,
                      prefix_cache_path=args.prefix_cache_path,
                      moe_dispatch=args.moe_dispatch, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    fams = [rng.integers(0, cfg.vocab_size, 24).astype(np.int32)
            for _ in range(args.prompt_families)]
    t0 = time.time()
    for i in range(args.requests):
        if fams:
            head = fams[i % len(fams)]
            tail = rng.integers(0, cfg.vocab_size,
                                int(rng.integers(2, 8))).astype(np.int32)
            prompt = np.concatenate([head, tail])[:args.max_len - args.max_new
                                                  - 1]
        else:
            plen = int(rng.integers(4, 16))
            prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=args.max_new,
                           adapter_id=i % max(args.adapters, 1),
                           temperature=args.temperature))
    done = eng.drain()
    dt = time.time() - t0
    total_toks = sum(c.n_tokens for c in done.values())
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else str(device))
    print(f"[paged on {where}] served {len(done)} requests / {total_toks} "
          f"tokens in {dt:.2f}s ({total_toks / dt:.1f} tok/s, "
          f"{args.adapters} adapters hot)")
    print(f"  stats: {eng.stats().as_dict()}")
    for uid in sorted(done)[:4]:
        print(f"  req {uid} adapter={done[uid].adapter_id} "
              f"[{done[uid].finish_reason}]: {done[uid].tokens[:10]}")
    return done


if __name__ == "__main__":
    main()
