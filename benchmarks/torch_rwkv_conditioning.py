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

    PYTHONPATH=src python benchmarks/torch_rwkv_conditioning.py --grads

``--grads`` measures the same for training, the yardstick of
``chip_smoke.py``'s train-phase bounds: rwkv6-7b at full width (d 4096,
64 heads of 64, d_ff 14336, vocabulary 65536) through its first L = 1,
2, 4, 8 layers, and llama3.2-1b at full width and depth, each on a
dequantized M8F8 base with one rank-32 adapter on wq/wv (B drawn
non-zero), on one train microbatch (2 x 512 SyntheticLM tokens) through
the plain versions (``torch.matmul``, ref attention, autograd of the
plain recurrence). The weights are multiplied by (1 + rel * N(0, 1)) at
rel = 1e-6 and at rel = 2^-16, the bound of the crossbar kernels'
two-bf16-piece split of their f32 operand; each line gives the relative
change of the loss and of every LoRA gradient (L2), and of the losses
of 5 AdamW steps (lr 1e-3) from the same start. The card by default.
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


def grad_sensitivity(dev, arch, n_layers, batch, rels=(1e-6, 2.0 ** -16),
                     steps=5):
    """One line per ``rel``: how far a weight perturbation moves the loss,
    every LoRA gradient and ``steps`` AdamW steps' losses of ``arch`` cut
    to ``n_layers`` at full width (the plain path, a dequantized M8F8
    base)."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core import lora as lora_lib
    from repro_torch.core import quant
    from repro_torch.optim import adamw
    from repro_torch.train import steps as st

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    g = torch.Generator(dev).manual_seed(0)
    params = quant.dequantize_params(quant.quantize_params(
        tfm.init_params(cfg, g, device=dev), QuantConfig(8, 8)))
    lora = lora_lib.init_lora_params(cfg, g, device=dev)
    for entry in lora["layers"]:
        for ab in entry.values():
            ab["b"].normal_(0.0, 0.02, generator=g)
    ec = tfm.ExecConfig(attn_impl="ref", rwkv_impl="ref")
    hp = st.TrainHParams(adamw=adamw.AdamWConfig(lr=1e-3))

    def run(p):
        (loss, _), grads = st.value_and_grad(st.make_loss_fn(cfg, ec), lora,
                                             p, batch, None)
        step = st.make_train_step(cfg, ec, hp)
        state, losses = (lora, adamw.init(lora)), []
        for _ in range(steps):
            *state, m = step(p, *state, batch)
            losses.append(float(m["loss"]))
        return float(loss), list(adamw.leaves(grads)), losses

    loss0, grads0, losses0 = run(params)
    for rel in rels:
        loss1, grads1, losses1 = run(perturbed(params, rel, torch.Generator(
            dev).manual_seed(1)))
        grad_rel = [float((a - b).norm() / b.norm())
                    for a, b in zip(grads1, grads0)]
        step_rel = [abs(a - b) / abs(b) for a, b in zip(losses1, losses0)]
        print(f"{arch} layers={n_layers} rel={rel:.3g} "
              f"loss_rel={abs(loss1 - loss0) / abs(loss0):.3g} "
              f"grad_rel_max={max(grad_rel):.3g} "
              f"grad_rel={[round(x, 6) for x in grad_rel]} "
              f"steps_loss_rel_max={max(step_rel):.3g}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--grads", action="store_true",
                    help="the LoRA gradients' sensitivity at full width")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.grads:
        from repro_torch.data.pipeline import SyntheticLM
        for arch, depths in (("rwkv6-7b", (1, 2, 4, 8)),
                             ("llama3.2-1b", (16,))):
            vocab = get_config(arch).vocab_size
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     SyntheticLM(vocab, seed=0).batch(0, 2, 512).items()}
            for n in depths:
                grad_sensitivity(dev, arch, n, batch)
        return
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
