"""Serving launcher of the PyTorch port: batched multi-adapter LoRA
inference through the paged engine (or the dense oracle, ``--engine
dense``), on the CUDA card by default.

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

  # the dense max_batch x max_len oracle (decode step as one CUDA graph)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --engine dense --max-batch 8 --max-len 1024

  # speculative decoding: n-gram or quantized self-draft drafter
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --smoke --device cpu --spec-decode --draft ngram --spec-k 4

  # prefix-cache persistence: the index is saved at the end of the run and
  # loaded by the next run given the same path
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --smoke --device cpu --prompt-families 2 \\
      --prefix-cache-path build/prefix.npz

  # a mixture-of-experts model (dropless routing; ``--moe-dispatch
  # capacity`` is the benchmark baseline, paged engine only)
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama4-scout-17b-a16e --smoke --device cpu \\
      --moe-dispatch capacity

The flags are the JAX launcher's (``repro.launch.serve``). ``--tp``, whose
feature is not ported yet, raises ``NotImplementedError`` with the paged
engine; with ``--engine dense`` it, ``--moe-dispatch capacity`` and
``--spec-decode`` exit with JAX's messages, and the dense oracle ignores
``--prefix-cache-path``, as JAX's does. The models that take precomputed
embeddings (musicgen-medium, chameleon-34b) are served from tokens, as the
JAX engines serve them. The deprecated
``--paged`` is left out. The base is quantized M8F8 with the port's
``quantize_params`` (one scan period at a time:
``transformer.init_quantized_params``), as
``examples/serve_multiadapter.py`` quantizes it, except
under ``--draft selfdraft``: the self-drafter quantizes the base itself
and takes an unquantized one only (``serve.spec.QuantSelfDrafter``), so
the base stays f32 there, as the JAX launcher serves it.
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
from repro_torch.models.transformer import (init_params,
                                            init_quantized_params)
from repro_torch.serve.api import Request, make_engine
from repro_torch.serve.spec import SpecConfig


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
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative decoding (paged engine only): draft "
                         "k tokens per slot, verify in one mixed step, "
                         "roll back rejected KV")
    ap.add_argument("--draft", choices=("ngram", "selfdraft"),
                    default="ngram",
                    help="drafter: model-free n-gram lookup, or the target "
                         "model with quantize_params-compressed weights "
                         "(the base then stays unquantized)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens per slot per tick")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--moe-dispatch", choices=("dropless", "capacity"),
                    default="dropless")
    ap.add_argument("--prefix-cache-path", default=None,
                    help="persist/restore the prefix index at this .npz "
                         "path (paged engine)")
    args = ap.parse_args(argv)

    if args.engine == "dense":
        if args.spec_decode:
            raise SystemExit("--spec-decode requires --engine paged")
        if args.tp > 1:
            raise SystemExit("--tp requires --engine paged")
        if args.moe_dispatch != "dropless":
            raise SystemExit("--moe-dispatch capacity requires --engine "
                             "paged (the dense oracle always routes "
                             "dropless)")
    spec = (SpecConfig(k=args.spec_k, drafter=args.draft)
            if args.spec_decode else None)
    if args.tp > 1:
        raise NotImplementedError("tensor-parallel serving is not ported yet "
                                  "(ROADMAP Queue 1 item 16)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
    g = torch.Generator(device=device).manual_seed(args.seed)
    if spec is None or spec.drafter != "selfdraft":
        # drawn and quantized one scan period at a time: the f32 base of a
        # large model is never whole on the device
        params = init_quantized_params(
            cfg, g, QuantConfig(mha_bits=8, ff_bits=8), device=device,
            min_size=1 if args.smoke else 1 << 16)
    else:
        params = init_params(cfg, g, device=device)
    adapters = [lora_lib.init_lora_params(cfg, g, device=device)
                for _ in range(args.adapters)]
    if args.engine == "paged":
        eng = make_engine(cfg, params, adapters, mode="paged", device=device,
                          max_slots=args.max_batch, max_len=args.max_len,
                          page_size=args.page_size, num_pages=args.num_pages,
                          prefill_chunk=args.prefill_chunk,
                          enable_prefix_cache=not args.no_prefix_cache,
                          prefix_cache_path=args.prefix_cache_path,
                          spec=spec, moe_dispatch=args.moe_dispatch,
                          seed=args.seed)
    else:
        eng = make_engine(cfg, params, adapters, mode="dense", device=device,
                          max_batch=args.max_batch, max_len=args.max_len,
                          seed=args.seed)
    if args.engine == "paged" and eng.stats().prefix_cache.loaded_pages:
        print(f"  prefix cache: {eng.stats().prefix_cache.loaded_pages} "
              f"pages loaded from {args.prefix_cache_path}")
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
    print(f"[{args.engine} on {where}] served {len(done)} requests / "
          f"{total_toks} tokens in {dt:.2f}s ({total_toks / dt:.1f} tok/s, "
          f"{args.adapters} adapters hot)")
    print(f"  stats: {eng.stats().as_dict()}")
    moe_stats = eng.stats().moe
    if moe_stats.enabled:
        print(f"  moe[{moe_stats.dispatch}]: "
              f"dropped_tokens={moe_stats.dropped_tokens}")
    if args.engine == "paged" and args.prefix_cache_path:
        if eng.prefix is None:
            print("  prefix cache disabled on this model: nothing saved")
        else:
            n = eng.save_prefix_cache()
            print(f"  prefix cache: {n} pages saved to "
                  f"{args.prefix_cache_path}")
    for uid in sorted(done)[:4]:
        print(f"  req {uid} adapter={done[uid].adapter_id} "
              f"[{done[uid].finish_reason}]: {done[uid].tokens[:10]}")
    return done


if __name__ == "__main__":
    main()
