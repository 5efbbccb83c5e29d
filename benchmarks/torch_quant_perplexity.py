"""Paper Fig. 13 on the port: model perplexity under MnFm crossbar-wise
quantization, by ``benchmarks/bench_quant_perplexity.py``'s protocol:
pretrain reduced ``paper-gpt2-medium`` (2 layers, d 128, 4 heads, d_ff
512) on the synthetic corpus, quantize it crossbar-wise at each MnFm
config (every weight matrix, ``min_size=1``), LoRA-fine-tune on the task
and measure the evaluation perplexity. Expected ordering: bf16 ~ M8F8 <=
M8F4 < M4F8 << M4F4.

    PYTHONPATH=src:. python benchmarks/torch_quant_perplexity.py [--device cpu]

Runs on the CUDA card by default and on the CPU given ``--device cpu``.
Pretraining is ``PRETRAIN_STEPS`` steps of full-parameter AdamW at lr 2e-3
over every leaf of the base (``loss_and_grads``: autograd through the
embedding gather, the tied unembed, LayerNorm, GELU, the dense products
and the flash kernels' backward), written here, as the JAX script writes
its own step. Each quantized fine-tune runs the crossbar kernel and its
transpose (``crossbar_matmul_t``) on int8 or int4 codes; the bf16 row keeps
the f32 base (``torch.matmul``), as the JAX script does. Writes
``experiments/paper/torch_fig13_quant_perplexity.json`` with the JAX
script's payload keys and ``device``.
"""
import argparse

import numpy as np
import torch

from benchmarks.torch_common import emit, save_json
from repro_torch import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import lora as lora_lib, quant
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import TrainHParams, make_train_step

PRETRAIN_STEPS = 250
FT_STEPS = 80
EVAL_BATCHES = 5
BATCH, SEQ = 16, 64
CONFIGS = {"bf16": None, "M8F8": (8, 8), "M8F4": (8, 4), "M4F8": (4, 8),
           "M4F4": (4, 4)}


def config():
    return reduce_config(get_config("paper-gpt2-medium"), n_periods=2,
                         d_model=128, n_heads=4, d_ff=512)


def batch_on(ds, index, dev):
    return {k: torch.from_numpy(v).to(dev)
            for k, v in ds.batch(index, BATCH, SEQ).items()}


def loss_and_grads(cfg, params, batch):
    """(loss, the gradient of every leaf of ``params``), as
    ``jax.value_and_grad`` of the train-mode loss gives them (a leaf the
    loss does not read gets zeros)."""
    leaves = []

    def leaf(x):
        t = x.detach().requires_grad_(True)
        leaves.append(t)
        return t

    with torch.enable_grad():
        live = lora_lib.tree_map(leaf, params)
        lg, _, _ = tfm.forward(cfg, live, {"tokens": batch["tokens"]},
                               mode="train")
        loss = tfm.lm_loss(cfg, lg, batch["labels"])[0]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(x)
              for g, x in zip(grads, leaves))
    return loss.detach(), lora_lib.tree_map(lambda _: next(it), params)


def pretrain(cfg, ds, dev, seed=0):
    """Full pretraining of the small base (AdamW over all params); returns
    (params, the last step's loss)."""
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                             device=dev)
    opt = adamw.init(params)
    oc = AdamWConfig(lr=2e-3)
    loss = None
    for i in range(PRETRAIN_STEPS):
        loss, g = loss_and_grads(cfg, params, batch_on(ds, i, dev))
        params, opt, _ = adamw.apply_updates(oc, params, g, opt)
    return params, float(loss)


@torch.no_grad()
def eval_ppl(cfg, base, lora, ds, dev):
    """exp of the mean loss over ``EVAL_BATCHES`` held-out batches."""
    nll = []
    for i in range(EVAL_BATCHES):
        b = batch_on(ds, 20_000 + i, dev)
        lg, _, _ = tfm.forward(cfg, base, {"tokens": b["tokens"]}, lora=lora,
                               mode="train")
        nll.append(float(tfm.lm_loss(cfg, lg, b["labels"])[0]))
    return float(np.exp(np.mean(nll)))


def finetune_and_ppl(cfg, base, ds, dev, seed=1, steps=None):
    """LoRA fine-tune over ``base`` (``steps`` steps, default ``FT_STEPS``),
    then the evaluation perplexity."""
    step = make_train_step(cfg, tfm.ExecConfig(),
                           TrainHParams(adamw=AdamWConfig(lr=3e-3)))
    lora = lora_lib.init_lora_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    opt = adamw.init(lora)
    for i in range(FT_STEPS if steps is None else steps):
        lora, opt, _ = step(base, lora, opt, batch_on(ds, 1000 + i, dev))
    return eval_ppl(cfg, base, lora, ds, dev)


def quantized(base, tag):
    bits = CONFIGS[tag]
    if bits is None:
        return base
    return quant.quantize_params(
        base, QuantConfig(mha_bits=bits[0], ff_bits=bits[1]), min_size=1)


def run(device=None):
    """Fig. 13's protocol: ``PRETRAIN_STEPS`` pretraining steps and
    ``FT_STEPS`` fine-tuning steps a base, as the JAX script."""
    dev = resolve_device(device)
    cfg = config()
    ds = SyntheticLM(cfg.vocab_size, seed=2)
    base, pre_loss = pretrain(cfg, ds, dev)
    payload = {"pretrain_final_loss": pre_loss, "ppl": {}}
    for tag in CONFIGS:
        ppl = finetune_and_ppl(cfg, quantized(base, tag), ds, dev)
        payload["ppl"][tag] = ppl
        emit(f"torch_fig13_ppl_{tag}", 0.0, f"ppl={ppl:.3f}")
    p = payload["ppl"]
    payload["ordering_ok"] = bool(p["M8F8"] <= p["M8F4"] * 1.02 <= p["M4F4"] * 1.02
                                  and p["M4F4"] >= p["M8F8"])
    payload["steps"] = {"pretrain": PRETRAIN_STEPS, "finetune": FT_STEPS}
    payload["device"] = str(dev)
    emit("torch_fig13_ordering", 0.0,
         f"bf16={p['bf16']:.2f}_M8F8={p['M8F8']:.2f}_M8F4={p['M8F4']:.2f}"
         f"_M4F8={p['M4F8']:.2f}_M4F4={p['M4F4']:.2f}")
    save_json("torch_fig13_quant_perplexity", payload)
    return payload


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    run(ap.parse_args().device)
