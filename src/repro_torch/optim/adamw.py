"""AdamW over a tree of tensors (PyTorch port of ``repro.optim.adamw``).

Plain functions on dicts, tuples and lists of tensors, run under
``torch.no_grad()``: the same f32 arithmetic in the same order as the JAX
package's update, which ``torch.optim.AdamW`` does not reproduce (it folds
the bias corrections into the step size and decays the weight before the
update). In PEFT mode the optimizer only ever sees the LoRA tree: the
frozen base has no gradients, moments or updates.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.lora import tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    # step (an int32 tensor) -> lr scale
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar: updates applied so far
    mu: Any
    nu: Any


def leaves(tree):
    """The tensors of a tree, in ``jax.tree.leaves`` order (dict keys
    sorted), so that sums over leaves run in the JAX package's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    first = next(leaves(params))
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    total = None
    for x in leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState
                  ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step with the global-norm clip; returns (new params, new
    state, {"grad_norm", "lr"}). New tensors throughout: the caller's
    params, grads and state are left as they were."""
    step = state.step + 1
    gnorm = global_norm(grads)
    if cfg.grad_clip is not None:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=gnorm.device)
    if cfg.schedule is not None:
        lr = lr * cfg.schedule(step)

    sf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=sf.device), sf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=sf.device), sf)

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        m = cfg.b1 * m + (1 - cfg.b1) * gf
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(gf)
        mh, vh = m / b1c, v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu)
    return (_take(params, out, 0),
            AdamWState(step, _take(params, out, 1), _take(params, out, 2)),
            {"grad_norm": gnorm, "lr": lr})


def _take(ref, out, i):
    """Item ``i`` of each (p, m, v) leaf of ``out``, which has the
    structure of ``ref``."""
    if isinstance(ref, dict):
        return {k: _take(ref[k], out[k], i) for k in ref}
    if isinstance(ref, (tuple, list)):
        return type(ref)(_take(r, o, i) for r, o in zip(ref, out))
    return out[i]


def warmup_cosine(warmup: int, total: int, floor: float = 0.1
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    def sched(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        w = torch.clamp(s / max(warmup, 1), max=1.0)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return w * cos
    return sched
