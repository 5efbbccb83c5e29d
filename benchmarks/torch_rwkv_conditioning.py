"""How much a random-init model of the port amplifies a tiny perturbation of
its weights, by depth: the yardstick for comparing f32 kernels with their
plain versions through a whole model.

    PYTHONPATH=src python benchmarks/torch_rwkv_conditioning.py --device cpu

For rwkv6-7b (32 layers) and llama3.2-1b (16 layers), both at d_model 512
(8 heads of 64, d_ff 1792, vocabulary 2048), every weight is multiplied by
(1 + 1e-6 * N(0, 1)), about what f32 kernels that sum in another order
change; each line gives, for one 128-token forward through the first L
layers, the largest logit difference, the position where it occurs, the
median over positions and the difference at the last position, beside
the largest logit. Weights and tokens come from fixed seeds.
"""
import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import transformer as tfm


def perturbed(tree, rel, g):
    if isinstance(tree, dict):
        return {k: perturbed(v, rel, g) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(perturbed(v, rel, g) for v in tree)
    noise = torch.randn(tree.shape, generator=g, device=tree.device)
    return tree * (1 + rel * noise)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, n_layers in (("rwkv6-7b", 32), ("llama3.2-1b", 16)):
        cfg = reduce_config(get_config(arch), n_periods=n_layers, d_model=512,
                            n_heads=8, d_ff=1792, vocab=2048)
        if cfg.rwkv is not None:
            cfg = dataclasses.replace(cfg, rwkv=dataclasses.replace(
                cfg.rwkv, head_dim=64, decay_lora=64, mix_lora=32))
        params = tfm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                 device=dev)
        g = torch.Generator(dev).manual_seed(1)
        other = perturbed(params, 1e-6, g)
        toks = {"tokens": torch.randint(0, cfg.vocab_size, (1, 128),
                                        generator=g, device=dev)}
        L = 1
        while L <= n_layers:
            cut = dataclasses.replace(cfg, n_layers=L)
            a = tfm.forward(cut, params, toks)[0][0]
            b = tfm.forward(cut, other, toks)[0][0]
            err = (a - b).abs().amax(dim=-1)                # per position
            print(f"{arch} layers={L} max_abs_diff={float(err.max()):.3g} "
                  f"at={int(err.argmax())} median={float(err.median()):.3g} "
                  f"last={float(err[-1]):.3g} "
                  f"max_abs_logit={float(a.abs().max()):.3g}", flush=True)
            L *= 2


if __name__ == "__main__":
    main()
