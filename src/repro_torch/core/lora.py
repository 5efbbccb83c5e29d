"""LoRA / QLoRA (Atleus SS III.B, Eq. 1/4), PyTorch port of
``repro.core.lora``.

Y = W0·X + (alpha/r)·A·B·X with W0 frozen (crossbar-quantized under QLoRA).
The LoRA tree mirrors the model's scan layout: one entry per scan-period
position, leaves stacked over periods. Multi-adapter serving (paper SS V.G)
stacks whole adapter trees along axis 1 and gathers per request row.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hetero

# target name -> path inside the per-position param tree, per block kind.
# rwkv has no attention; the paper's W_Q/W_V targets translate to the
# receptance/value time-mix projections. A Mamba block takes its own
# targets, its input and output projections.
TARGET_PATHS = {
    "attn": {"wq": ("attn", "wq"), "wk": ("attn", "wk"),
             "wv": ("attn", "wv"), "wo": ("attn", "wo")},
    "rwkv": {"wq": ("time_mix", "r_proj"), "wk": ("time_mix", "k_proj"),
             "wv": ("time_mix", "v_proj"), "wo": ("time_mix", "o_proj")},
    "mamba": {"mamba_in": ("in_proj",), "mamba_out": ("out_proj",)},
}


def _targets_for(cfg: ModelConfig, kind: str) -> Dict[str, Tuple[str, ...]]:
    paths = TARGET_PATHS.get(kind, {})
    return {t: paths[t] for t in cfg.lora.targets if t in paths}


def _weight_shape(cfg: ModelConfig, kind: str, target: str) -> Tuple[int, int]:
    d = cfg.d_model
    if kind == "rwkv":
        return (d, d)
    if kind == "mamba":
        d_in = cfg.mamba.expand * d
        return {"mamba_in": (d, 2 * d_in), "mamba_out": (d_in, d)}[target]
    return {"wq": (d, cfg.q_dim), "wk": (d, cfg.kv_dim),
            "wv": (d, cfg.kv_dim), "wo": (cfg.q_dim, d)}[target]


def scan_period(cfg: ModelConfig) -> int:
    """Scan period = lcm(block period, moe period, attn-pattern period in
    global layers) so every scanned position has static behaviour."""
    p = cfg.period
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.period)
    n_attn_pat = len(cfg.attn.pattern)
    if "attn" in cfg.block_pattern and n_attn_pat > 1:
        p = math.lcm(p, cfg.period * n_attn_pat)
    assert cfg.n_layers % p == 0, (cfg.name, p)
    return p


def init_lora_params(cfg: ModelConfig, generator: torch.Generator, *,
                     device=None, dtype=torch.float32):
    """A ~ N(0, 0.02), B = 0 (delta starts at zero). Leaves are stacked
    (n_scan_periods, d_in, r) / (n_scan_periods, r, d_out). Draws from
    ``generator``, which must live on ``device``."""
    p = scan_period(cfg)
    n_sp = cfg.n_layers // p
    r = cfg.lora.rank
    layers = []
    for pos in range(p):
        entry = {}
        kind = cfg.block_kind(pos)
        for t in _targets_for(cfg, kind):
            din, dout = _weight_shape(cfg, kind, t)
            a = torch.randn((n_sp, din, r), generator=generator,
                            device=device, dtype=torch.float32)
            entry[t] = {"a": (0.02 * a).to(dtype),
                        "b": torch.zeros((n_sp, r, dout), device=device,
                                         dtype=dtype)}
        layers.append(entry)
    return {"layers": tuple(layers)}


def lora_delta(x: torch.Tensor, ab: Dict[str, torch.Tensor], scale: float,
               adapter_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(alpha/r) * (x @ A) @ B on the DYNAMIC engine.

    ``ab['a']``: (d_in, r), or (n_adapters, d_in, r) with ``adapter_idx``
    (B,) picking each batch row's adapter (multi-adapter serving)."""
    a, b = ab["a"], ab["b"]
    if adapter_idx is not None:
        a = a[adapter_idx]  # (B, d_in, r)
        b = b[adapter_idx]  # (B, r, d_out)
        xa = hetero.dynamic_einsum("btd,bdr->btr", x, a.to(x.dtype))
        out = hetero.dynamic_einsum("btr,brd->btd", xa, b.to(x.dtype))
    else:
        xa = hetero.dynamic_matmul(x, a.to(x.dtype))
        out = hetero.dynamic_matmul(xa, b.to(x.dtype))
    return (scale * out).to(x.dtype)


def lora_scale(cfg: ModelConfig) -> float:
    return cfg.lora.alpha / cfg.lora.rank


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (nested dicts,
    tuples and lists), like ``jax.tree.map``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_adapters(adapters: Sequence):
    """Stack N adapter trees for batched multi-adapter serving.

    The stack axis is 1 (leaves (n_sp, d_in, r) -> (n_sp, n_ad, d_in, r))
    so slicing the leading scan-period dim still gives one layer."""
    return tree_map(lambda *xs: torch.stack(xs, dim=1), *adapters)


def layer_slice(tree, i: int):
    """Slice index ``i`` of the leading (scan-period) dim of every leaf."""
    def one(x):
        return x.layer(i) if hasattr(x, "layer") else x[i]
    return tree_map(one, tree)
