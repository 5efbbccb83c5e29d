"""Paper Fig. 9 on the port: noise-aware fine-tuning restores accuracy
under ReRAM non-idealities. Three conditions on reduced
``paper-gpt2-medium`` (2 layers, d 128, 4 heads, d_ff 512) and the
synthetic task, as ``benchmarks/bench_noise.py`` runs them:

  ideal        train clean,  eval clean   (no crossbar noise)
  naive        train clean,  eval noisy   (deploy on non-ideal crossbars)
  noise-aware  train noisy,  eval noisy   (the paper's method)

    PYTHONPATH=src:. python benchmarks/torch_noise.py [--device cpu]

Runs on the CUDA card by default (the flash forward and backward kernels;
the base is not quantized, so no crossbar launch) and on the CPU given
``--device cpu``. Each fine-tune takes ``STEPS`` LoRA steps at lr 5e-3
through ``make_train_step``; the noisy one perturbs the frozen base at
every step (``ExecConfig(noise=...)``, drawn from one generator seeded
``seed + 1``). The noisy evaluation perturbs every base leaf with at least
2 dimensions and more than 4096 elements once, each from its own
generator, seeded by a CRC-32 of the leaf's path (``leaf_generator``): the
same draw in every process. (The JAX script seeds each leaf from Python's
``hash`` of its path, which changes from process to process.) Writes
``experiments/paper/torch_fig9_noise_aware.json`` with the JAX script's
payload keys and ``device``.
"""
import argparse
import zlib

import numpy as np
import torch

from benchmarks.torch_common import emit, save_json
from repro_torch import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import lora as lora_lib
from repro_torch.core.noise import NoiseConfig, apply_weight_noise
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import TrainHParams, make_train_step

SIGMA = 0.03
STEPS = 120
EVAL_BATCHES = 5
BATCH, SEQ = 16, 64


def config():
    return reduce_config(get_config("paper-gpt2-medium"), n_periods=2,
                         d_model=128, n_heads=4, d_ff=512)


def batch_on(ds, index, dev):
    return {k: torch.from_numpy(v).to(dev)
            for k, v in ds.batch(index, BATCH, SEQ).items()}


def train(cfg, params, ds, noise_cfg, dev, seed=0):
    """LoRA fine-tune of the frozen ``params`` (weight noise at every step
    when ``noise_cfg`` is enabled); returns the adapter."""
    ec = tfm.ExecConfig(noise=noise_cfg)
    step = make_train_step(cfg, ec, TrainHParams(adamw=AdamWConfig(lr=5e-3)))
    lora = lora_lib.init_lora_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    opt = adamw.init(lora)
    rng = (torch.Generator(device=dev).manual_seed(seed + 1)
           if noise_cfg.enabled else None)
    for i in range(STEPS):
        lora, opt, _ = step(params, lora, opt, batch_on(ds, i, dev), rng)
    return lora


def leaf_generator(path: str, seed: int, device) -> torch.Generator:
    """The generator of one leaf's noise: seeded by ``seed`` and a CRC-32
    of the leaf's path (the same in every process)."""
    return torch.Generator(device=device).manual_seed(
        (seed << 32) + zlib.crc32(path.encode()))


def perturb(params, sigma: float, seed: int):
    """The base as a non-ideal crossbar holds it: every leaf with at least
    2 dimensions and more than 4096 elements perturbed (``apply_weight_
    noise``, clipped to its absmax) from ``leaf_generator`` of its path,
    written as JAX's ``keystr`` writes it (``['layers'][0]['attn']['wq']``);
    other leaves as they are."""
    nc = NoiseConfig(enabled=True, sigma_rel=sigma)

    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(v, f"{path}['{k}']") for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(visit(v, f"{path}[{i}]")
                              for i, v in enumerate(node))
        if node.ndim >= 2 and node.numel() > 4096:
            return apply_weight_noise(node, nc,
                                      leaf_generator(path, seed, node.device))
        return node

    return visit(params, "")


@torch.no_grad()
def eval_acc(cfg, params, lora, ds, dev, noisy: bool, seed=7):
    """Next-token accuracy over ``EVAL_BATCHES`` held-out batches, on the
    clean base or on one noisy draw of it."""
    if noisy:
        params = perturb(params, SIGMA, seed)
    accs = []
    for i in range(EVAL_BATCHES):
        b = batch_on(ds, 10_000 + i, dev)
        lg, _, _ = tfm.forward(cfg, params, {"tokens": b["tokens"]},
                               lora=lora, mode="train")
        accs.append(float((lg.argmax(-1) == b["labels"].long())
                          .float().mean()))
    return float(np.mean(accs))


def run(device=None):
    """Fig. 9's protocol: ``STEPS`` steps a fine-tune, as the JAX script."""
    dev = resolve_device(device)
    cfg = config()
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    ds = SyntheticLM(cfg.vocab_size, seed=5)

    lora_clean = train(cfg, params, ds, NoiseConfig(enabled=False), dev)
    lora_noisy = train(cfg, params, ds,
                       NoiseConfig(enabled=True, sigma_rel=SIGMA), dev)

    ideal = eval_acc(cfg, params, lora_clean, ds, dev, noisy=False)
    naive = eval_acc(cfg, params, lora_clean, ds, dev, noisy=True)
    aware = eval_acc(cfg, params, lora_noisy, ds, dev, noisy=True)
    payload = {"sigma_rel": SIGMA, "ideal_acc": ideal, "naive_acc": naive,
               "noise_aware_acc": aware,
               "gap_naive_pct": 100 * (ideal - naive),
               "gap_aware_pct": 100 * (ideal - aware),
               "steps": STEPS,
               "device": str(dev)}
    emit("torch_fig9_noise", 0.0,
         f"ideal={ideal:.4f}_naive={naive:.4f}_aware={aware:.4f}")
    save_json("torch_fig9_noise_aware", payload)
    return payload


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    run(ap.parse_args().device)
