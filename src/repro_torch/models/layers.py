"""Shared model layers: norms (RMSNorm, LayerNorm), RoPE, MLPs, embeddings
(PyTorch port of ``repro.models.layers``).

All frozen-weight matmuls route through ``hetero.static_matmul`` (the
crossbar path). Weights take the JAX package's layout: a linear map is
stored (d_in, d_out) and applied as ``x @ w``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hetero
from repro_torch.core.noise import NoiseConfig

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, *, device, dtype,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Truncated normal in [-2, 2] scaled by 1/sqrt(fan_in)."""
    fan_in = fan_in if fan_in is not None else (
        shape[-2] if len(shape) >= 2 else shape[-1])
    w = torch.empty(shape, device=device, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)


def init_norm(cfg: ModelConfig, *, device, dtype, lead=()) -> Dict[str, torch.Tensor]:
    shape = (*lead, cfg.d_model)
    p = {"scale": torch.ones(shape, device=device, dtype=dtype)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, device=device, dtype=dtype)
    return p


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    hetero.record_nonlinear(x.numel())
    out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    hetero.record_nonlinear(x.numel())
    out = ((xf - mu) * torch.rsqrt(var + eps) * scale.to(torch.float32)
           + bias.to(torch.float32))
    return out.to(x.dtype)


def apply_norm(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_sincos(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (B, T) -> sin/cos (B, T, head_dim/2) in f32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # a Python base: no host-to-device copy, so a CUDA graph can capture it
    freqs = torch.pow(theta, exps)
    ang = positions.to(torch.float32)[..., None] * freqs   # (B, T, half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, D); rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s, c = sin[:, :, None, :], cos[:, :, None, :]
    xf1, xf2 = x1.to(torch.float32), x2.to(torch.float32)
    out = torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (dense FF block)
# ---------------------------------------------------------------------------


_MLPS = ("gated_silu", "gated_gelu", "gelu")


def init_mlp(cfg: ModelConfig, generator: torch.Generator, *, device, dtype,
             lead=()) -> Dict[str, torch.Tensor]:
    """``w1`` (d, ff), then for a gated MLP ``w3`` (d, ff), then ``w2``
    (ff, d), drawn from ``generator`` in that order."""
    if cfg.mlp not in _MLPS:
        raise ValueError(f"unknown mlp {cfg.mlp!r}")
    d, ff = cfg.d_model, cfg.d_ff
    kw = dict(device=device, dtype=dtype)
    p = {"w1": dense_init(generator, (*lead, d, ff), **kw)}
    if cfg.mlp.startswith("gated"):
        p["w3"] = dense_init(generator, (*lead, d, ff), **kw)
    p["w2"] = dense_init(generator, (*lead, ff, d), fan_in=ff, **kw)
    return p


def activation(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """The MLP's nonlinearity, uncounted (``_act`` counts it)."""
    if "silu" in cfg.mlp:
        return torch.nn.functional.silu(h)
    return torch.nn.functional.gelu(h, approximate="tanh")


def _act(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    hetero.record_nonlinear(h.numel())
    return activation(cfg, h)


def apply_mlp(cfg: ModelConfig, p, x: torch.Tensor, *,
              noise: Optional[NoiseConfig] = None,
              rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """FF-1/FF-2 (Table II) — STATIC engine: gated SiLU (llama), gated
    tanh-approximate GELU (gemma2), or tanh-approximate GELU (GPT-2/BLOOM
    style, no gate). ``noise``: weight noise drawn from ``rng``
    (noise-aware fine-tuning)."""
    nk = dict(noise=noise, rng=rng)
    h = hetero.static_matmul(x, p["w1"], **nk)
    if cfg.mlp.startswith("gated"):
        g = hetero.static_matmul(x, p["w3"], **nk)
        h = _act(cfg, h) * g
    else:
        h = _act(cfg, h)
    return hetero.static_matmul(h, p["w2"], **nk)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def init_embed(cfg: ModelConfig, generator: torch.Generator, *, device,
               dtype) -> Dict[str, torch.Tensor]:
    t = torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                    device=device, dtype=torch.float32)
    p = {"table": (0.02 * t).to(dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                  device=device, dtype=dtype)
    return p


def embed_tokens(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 tokens: torch.Tensor, dtype) -> torch.Tensor:
    x = p["table"].to(dtype)[tokens.long()]
    if cfg.emb_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def unembed(cfg: ModelConfig, p: Dict[str, torch.Tensor],
            x: torch.Tensor) -> torch.Tensor:
    """Tied (``x @ table.T``) or separate unembed — a plain large product
    that goes to ``torch.matmul``, as the JAX package leaves it to XLA."""
    w = p["table"].to(x.dtype).T if cfg.tie_embeddings else p["unembed"]
    logits = hetero.static_matmul(x, w)
    if cfg.final_logit_softcap is not None:
        c = cfg.final_logit_softcap
        logits = (c * torch.tanh(logits.to(torch.float32) / c)).to(logits.dtype)
        hetero.record_nonlinear(logits.numel())
    return logits
