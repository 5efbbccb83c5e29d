"""Mamba selective-state-space block (jamba's 7-of-8 layers), PyTorch port
of ``repro.models.ssm``.

The projections (in/out/x/dt) are STATIC-engine frozen weights: in_proj
and out_proj run the crossbar kernel once quantized, x_proj and dt_proj
stay f32 (``quant.WEIGHT_CLASS``). The selective scan is a DYNAMIC
recurrence with no weight-stationary form; it runs the hand-written CUDA
kernel ``repro_torch.kernels.selective_scan``, which keeps each channel's
state in registers for the whole sequence. The JAX package computes it in
chunks of ``cfg.mamba.chunk`` steps (a ``lax.scan`` with an
``associative_scan`` inside); the result does not depend on the chunk, up
to rounding.

Training: the scan kernel has no backward yet (ROADMAP Queue 1 item 28);
on the CPU autograd runs through the plain recurrence.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hetero
from repro_torch.core.lora import lora_delta, lora_scale
from repro_torch.core.noise import NoiseConfig
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.models import layers

# Per-slot decode-state leaves: the conv tail holds the last K-1 inputs and
# the SSM state is cumulative over the whole stream, both indexed by slot
# row (batch dim). The serving ``SlotStateArena`` snapshots / restores /
# zeroes them by slot id: a paged-KV cursor rewind cannot rewind them.
SLOT_STATE_LEAVES = ("conv", "ssm")


def init_mamba(cfg: ModelConfig, generator: torch.Generator, *, device,
               dtype, lead=()) -> Dict[str, torch.Tensor]:
    """The JAX package's Mamba parameter tree, stacked along ``lead``; the
    random leaves are drawn from ``generator`` (on ``device``), in the
    order of the tree."""
    mc = cfg.mamba
    d = cfg.d_model
    d_in = mc.expand * d
    r = mc.rank(d)
    N = mc.d_state
    kw = dict(device=device, dtype=dtype)
    f32 = dict(device=device, dtype=torch.float32)
    p = {"in_proj": layers.dense_init(generator, (*lead, d, 2 * d_in),
                                      name="in_proj", **kw)}
    conv = torch.randn((*lead, mc.d_conv, d_in), generator=generator, **f32)
    p["conv_w"] = (0.1 * conv).to(dtype)
    p["conv_b"] = torch.zeros((*lead, d_in), **kw)
    p["x_proj"] = layers.dense_init(generator, (*lead, d_in, r + 2 * N),
                                    fan_in=d_in, name="x_proj", **kw)
    p["dt_proj"] = layers.dense_init(generator, (*lead, r, d_in), fan_in=r,
                                     name="dt_proj", **kw)
    u = torch.rand((*lead, d_in), generator=generator, **f32)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    p["dt_bias"] = dt + torch.log(-torch.expm1(-dt))       # inverse softplus
    a_log = torch.log(torch.arange(1, N + 1, **f32))
    p["A_log"] = a_log.expand(*lead, d_in, N).contiguous()
    p["D"] = torch.ones((*lead, d_in), **f32)
    p["out_proj"] = layers.dense_init(generator, (*lead, d_in, d),
                                      fan_in=d_in, name="out_proj", **kw)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor],
                 valid_len: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time. x (B, T, C), w (K, C).
    ``state`` (B, K-1, C) carries the tail of the previous segment.
    ``valid_len`` (B,) marks ragged chunks: the emitted state is the last
    K-1 *valid* inputs of each row (the K-1 rows of the padded input from
    ``clip(len, 0, T)``), so a padded tail never leaks and ``len == 0``
    keeps the incoming state. Nothing is read on the host."""
    B, T, C = x.shape
    K = w.shape[0]
    if state is None:
        state = torch.zeros((B, K - 1, C), device=x.device, dtype=x.dtype)
    xp = torch.cat([state.to(x.dtype), x], dim=1)            # (B, T+K-1, C)
    wf = w.to(torch.float32)
    acc = torch.zeros((B, T, C), device=x.device, dtype=torch.float32)
    for j in range(K):
        acc = acc + xp[:, j:j + T, :].to(torch.float32) * wf[j]
    out = acc + b.to(torch.float32)
    if K == 1:
        new_state = state
    elif valid_len is None:
        new_state = xp[:, T:, :]
    else:
        start = torch.clamp(valid_len.long(), 0, T)
        rows = start[:, None] + torch.arange(K - 1, device=x.device)[None]
        new_state = torch.gather(xp, 1, rows[..., None].expand(B, K - 1, C))
    hetero.record_nonlinear(x.numel() * K)
    return out.to(x.dtype), new_state.to(x.dtype)


def selective_scan(dt, Bc, Cc, xi, A, h0, *, chunk: int,
                   impl: str = "auto"):
    """The selective scan with the JAX package's FLOP tally: y (B, T, D),
    h_final (B, D, N). ``impl``: "auto" — the CUDA kernel on CUDA tensors,
    its plain version on the CPU; "ref" — the plain recurrence anywhere.

    The y contraction is tallied as the JAX package's ``dynamic_einsum``
    ("bldn,bln->bld") over chunks of ``min(chunk, T)`` steps, padded, for
    every chunk. (The JAX package records it once, inside its scan body, so
    its tally counts one chunk whatever T is; the two agree at T <=
    chunk.)"""
    B, T, D = dt.shape
    N = A.shape[-1]
    L = min(chunk, T)
    if L:
        hetero._record(hetero.DYNAMIC, -(-T // L) * 2.0 * B * L * D * N)
    if impl == "ref":
        return scan_ops.selective_scan_plain(dt, Bc, Cc, xi, A, h0)
    if impl != "auto":
        raise ValueError(f"ssm impl {impl!r} (expected 'auto' or 'ref')")
    return scan_ops.selective_scan(dt, Bc, Cc, xi, A, h0)


def apply_mamba_block(
    cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    lora: Optional[Dict] = None, adapter_idx: Optional[torch.Tensor] = None,
    impl: str = "auto", chunk_lens: Optional[torch.Tensor] = None,
    noise: Optional[NoiseConfig] = None, rng: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x (B, T, d) -> (y, new_cache). cache: {conv (B, K-1, d_in), ssm (B,
    d_in, N) f32}; the new state comes back as new tensors (the caller
    decides where it lives).

    ``chunk_lens`` (B,) marks ragged chunks: rows are only valid for their
    first ``chunk_lens[b]`` tokens. Padded steps run with dt == 0 (an
    identity state transition), so the SSM state a row emits is exactly the
    state after its last valid token. ``noise`` perturbs the four frozen
    projections with noise drawn from ``rng``."""
    mc = cfg.mamba
    nk = dict(noise=noise, rng=rng)
    B, T, d = x.shape
    d_in = mc.expand * d
    N = mc.d_state
    r = mc.rank(d)
    scale = lora_scale(cfg)
    f32 = torch.float32

    xz = hetero.static_matmul(x, p["in_proj"], **nk)
    if lora is not None and "mamba_in" in lora:
        xz = xz + lora_delta(x, lora["mamba_in"], scale, adapter_idx)
    xi, z = xz[..., :d_in], xz[..., d_in:]

    conv_state = cache["conv"] if cache is not None else None
    xi, new_conv = _causal_conv(xi, p["conv_w"], p["conv_b"], conv_state,
                                valid_len=chunk_lens)
    xi = torch.nn.functional.silu(xi)
    hetero.record_nonlinear(xi.numel())

    dbc = hetero.static_matmul(xi, p["x_proj"], **nk)
    dt_r, Bc, Cc = dbc[..., :r], dbc[..., r:r + N], dbc[..., r + N:]
    dt = hetero.static_matmul(dt_r, p["dt_proj"], **nk)
    # softplus as jax.nn.softplus computes it: logaddexp(x, 0)
    dt = torch.logaddexp(dt.to(f32) + p["dt_bias"],
                         torch.zeros((), device=x.device, dtype=f32))
    if chunk_lens is not None:
        # padded tail steps become identity transitions (dt=0 -> a=1, bx=0)
        valid = (torch.arange(T, device=x.device)[None, :]
                 < chunk_lens[:, None])
        dt = dt * valid[:, :, None].to(f32)
    A = -torch.exp(p["A_log"])                                  # (d_in, N)
    hetero.record_nonlinear(dt.numel() * 2 * N)

    h0 = (cache["ssm"].to(f32) if cache is not None
          else torch.zeros((B, d_in, N), device=x.device, dtype=f32))
    xf = xi.to(f32)
    y, h_fin = selective_scan(dt, Bc.to(f32), Cc.to(f32), xf, A, h0,
                              chunk=mc.chunk, impl=impl)
    y = y + p["D"] * xf
    y = (y * torch.nn.functional.silu(z.to(f32))).to(x.dtype)
    hetero.record_nonlinear(y.numel())

    out = hetero.static_matmul(y, p["out_proj"], **nk)
    if lora is not None and "mamba_out" in lora:
        out = out + lora_delta(y, lora["mamba_out"], scale, adapter_idx)

    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv, "ssm": h_fin.to(cache["ssm"].dtype)}
    return out, new_cache
