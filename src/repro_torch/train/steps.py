"""The LoRA fine-tuning step (PyTorch port of ``repro.train.steps``).

Gradient accumulation runs microbatch by microbatch inside the step, as
the JAX package's microbatch scan does: f32 gradients are summed and
divided by the count. Only the LoRA tree requires gradients; the frozen
base never has any. On the card the forward runs the crossbar, flash and
wkv kernels, whose autograd Functions carry the gradient through their
CUDA backward kernels.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import tree_map
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import ExecConfig
from repro_torch.optim import adamw


@dataclass(frozen=True)
class TrainHParams:
    microbatches: int = 1
    adamw: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)
    full_finetune: bool = False   # paper mode is PEFT (LoRA-only)


def _split_micro(batch: Dict[str, torch.Tensor], n: int
                 ) -> List[Dict[str, torch.Tensor]]:
    """n microbatches of the global batch, rows in order."""
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch of {B} rows in {n} microbatches")
    return [{k: x[i * (B // n):(i + 1) * (B // n)] for k, x in batch.items()}
            for i in range(n)]


def make_loss_fn(cfg: ModelConfig, ec: ExecConfig):
    """(lora, params, micro, rng) -> (loss, metrics): train-mode forward
    from ``micro["tokens"]`` (or, without tokens, from precomputed
    ``micro["embeds"]``) and the token-mean cross entropy, with the MoE
    load-balance loss as a metric. ``rng``: the generator weight noise
    draws from (None without noise)."""
    def loss_fn(lora, params, micro, rng: Optional[torch.Generator]):
        inputs = ({"tokens": micro["tokens"]} if "tokens" in micro
                  else {"embeds": micro["embeds"]})
        logits, _, aux = tfm.forward(cfg, params, inputs, lora=lora,
                                     mode="train", exec_cfg=ec, rng=rng)
        loss, metrics = tfm.lm_loss(cfg, logits, micro["labels"],
                                    micro.get("mask"))
        return loss, {**metrics, "lb_loss": aux["lb_loss"]}
    return loss_fn


def value_and_grad(loss_fn, lora, params, micro, rng
                   ) -> Tuple[Tuple[torch.Tensor, Dict], object]:
    """((loss, metrics), grads of every LoRA leaf), as ``jax.value_and_grad
    (loss_fn, has_aux=True)`` gives them: the leaves are detached copies
    that require a gradient; the caller's tree is untouched."""
    leaves: List[torch.Tensor] = []

    def leaf(x):
        t = x.detach().requires_grad_(True)
        leaves.append(t)
        return t

    with torch.enable_grad():
        live = tree_map(leaf, lora)
        loss, metrics = loss_fn(live, params, micro, rng)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    tree = tree_map(lambda _: next(it), lora)
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree)


def accumulate_grads(loss_fn, lora, params, batch, n: int, rng=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], object]:
    """(loss, metrics, grads) of one step's batch in ``n`` microbatches:
    the f32 gradients summed and divided by ``n``, the loss averaged, as
    the JAX package's microbatch scan (whose metrics then hold only the
    loss); with ``n == 1`` the loss function's own metrics."""
    if n == 1:
        (loss, metrics), grads = value_and_grad(loss_fn, lora, params, batch,
                                                rng)
        return loss, metrics, grads
    gsum, lsum = None, None
    for mb in _split_micro(batch, n):
        (loss, _), g = value_and_grad(loss_fn, lora, params, mb, rng)
        g = tree_map(lambda x: x.to(torch.float32), g)
        gsum = g if gsum is None else tree_map(torch.add, gsum, g)
        lsum = loss if lsum is None else lsum + loss
    return lsum / n, {}, tree_map(lambda x: x / n, gsum)


def make_train_step(cfg: ModelConfig, ec: ExecConfig, hp: TrainHParams
                    ) -> Callable:
    """(params, lora, opt_state, batch, rng) -> (lora, opt_state, metrics).
    ``batch``: tokens (B, T) or embeds (B, T, d), labels (B, T)[, mask]."""
    # ``hp.full_finetune`` is accepted and not read, as in the JAX package:
    # the step trains the LoRA tree either way (the paper's PEFT mode)
    loss_fn = make_loss_fn(cfg, ec)

    def step(params, lora, opt_state, batch, rng=None):
        loss, metrics, grads = accumulate_grads(loss_fn, lora, params, batch,
                                                hp.microbatches, rng)
        new_lora, new_opt, om = adamw.apply_updates(hp.adamw, lora, grads,
                                                    opt_state)
        return new_lora, new_opt, {"loss": loss, **metrics, **om}

    return step
