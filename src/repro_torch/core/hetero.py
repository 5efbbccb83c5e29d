"""Heterogeneous compute mapping (Atleus SS IV.A, Eqs. 2-3, 5), PyTorch port
of ``repro.core.hetero``.

Every matrix multiplication is classified by operand staticness:

  STATIC   — activation x *frozen* weight (MHA-1/MHA-4/FF-1/FF-2). A
             crossbar-quantized weight goes to the hand-written CUDA
             ``crossbar_matmul`` kernel (its plain version on the CPU); a
             plain weight goes to ``torch.matmul``, as the JAX package
             leaves it to XLA.
  DYNAMIC  — activation x activation (QK^T, PV) or activation x
             *trainable* weight (LoRA A/B).

A tally (``tally()``) accumulates per-class FLOPs while a function runs, so
the Eq. 5 ratio (>90% of MM on the static engine) can be read off the model
as built. The counts accumulate when the Python code runs: per call in an
eager run, and once when the serving engine captures a step into a CUDA
graph (a replay adds nothing), as the JAX package's tally counts once per
trace.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.core import quant
from repro_torch.core.noise import NoiseConfig, apply_weight_noise
from repro_torch.kernels.crossbar_matmul import ops as cb_ops

STATIC = "static"     # -> ReRAM / crossbar path
DYNAMIC = "dynamic"   # -> systolic path


class _Tally(threading.local):
    def __init__(self):
        self.active: Optional[Dict[str, float]] = None


_TALLY = _Tally()


@contextlib.contextmanager
def tally():
    """Collect per-engine-class FLOPs of the calls made inside the block."""
    prev = _TALLY.active
    _TALLY.active = {STATIC: 0.0, DYNAMIC: 0.0, "nonlinear": 0.0}
    try:
        yield _TALLY.active
    finally:
        _TALLY.active = prev


def _record(cls: str, flops: float) -> None:
    if _TALLY.active is not None:
        _TALLY.active[cls] += float(flops)


def record_nonlinear(elements: int) -> None:
    """Softmax / layernorm / activation element counts (MHA-3, L-1, L-2)."""
    _record("nonlinear", float(elements))


def _matmul_flops(x_shape, w_shape) -> float:
    # batched x (..., m, k) @ w (..., k, n): 2*m*k*n * prod(batch)
    k, n = w_shape[-2], w_shape[-1]
    m = 1
    for d in x_shape[:-1]:
        m *= d
    return 2.0 * m * k * n


def static_matmul(x: torch.Tensor, w, *, noise: Optional[NoiseConfig] = None,
                  rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """Activation x frozen-weight matmul — the ReRAM/crossbar path.

    ``w`` is a 2-D tensor or a 2-D ``QuantizedTensor`` (one layer's slice).
    With ``noise`` enabled (noise-aware fine-tuning) the weight is
    dequantized, perturbed with noise drawn from ``rng`` and multiplied
    densely with ``torch.matmul``, as the JAX package does outside any
    Pallas call; otherwise a quantized weight goes to the crossbar
    kernel."""
    _record(STATIC, _matmul_flops(x.shape, w.shape))
    if noise is not None and noise.enabled:
        wd = (quant.dequantize(w, x.dtype) if quant.is_quantized(w)
              else w.to(x.dtype))
        return torch.matmul(x, apply_weight_noise(wd, noise, rng))
    if quant.is_quantized(w):
        return cb_ops.crossbar_matmul(x, w)
    return torch.matmul(x, w.to(x.dtype))


def static_grouped_matmul(x: torch.Tensor, w, bases: torch.Tensor,
                          counts: torch.Tensor, *, kernel: Optional[str],
                          jax_rows: int, noise: Optional[NoiseConfig] = None,
                          rng: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """The expert products of a mixture-of-experts layer on the STATIC
    engine: the port's counterpart of the JAX package's ``static_einsum``
    ("sbcd,sdf->sbcf" over the slots' stacked weights).

    ``x`` (R, K) holds the routed rows grouped by slot (``models.moe``'s
    compact buffer: slot s owns rows ``bases[s]`` .. ``bases[s] +
    counts[s] - 1``) and ``w`` stacks the slots' (K, N) weights. A
    quantized ``w`` goes to the ``grouped_crossbar_matmul`` kernel with
    ``kernel`` ("decode" or "prefill", which fixed the buffer's row tile);
    a plain one (or a noisy one: noise-aware fine-tuning perturbs the
    dequantized stack with noise drawn from ``rng``) to a dense product per
    slot. Under grad the kernel's autograd Function (dx by
    ``grouped_crossbar_matmul_t``) and the dense products' torch ops carry
    x's gradient; the weights get none. The tally counts what the JAX
    package's einsum counts: 2 * slots * ``jax_rows`` * K * N, its buffer
    holding ``jax_rows`` rows per slot (B * C), whatever rows the port
    computes."""
    slots, K, N = w.shape[-3:]
    _record(STATIC, 2.0 * slots * jax_rows * K * N)
    if noise is not None and noise.enabled:
        wd = (quant.dequantize(w, x.dtype) if quant.is_quantized(w)
              else w.to(x.dtype))
        return _dense_grouped(x, apply_weight_noise(wd, noise, rng), bases,
                              counts)
    if quant.is_quantized(w):
        return cb_ops.grouped_crossbar_matmul(x, w, bases, counts, kernel)
    return _dense_grouped(x, w.to(x.dtype), bases, counts)


def _dense_grouped(x: torch.Tensor, w: torch.Tensor, bases: torch.Tensor,
                   counts: torch.Tensor) -> torch.Tensor:
    """``grouped_crossbar_matmul``'s function on a dense (slots, K, N) stack,
    with no host read (a CUDA graph captures it): each slot's product over
    every row, kept where the row is one of its live rows (``torch.where``,
    so the other rows' values never reach the result); 0 elsewhere."""
    r = torch.arange(x.shape[0], device=x.device)
    out = torch.zeros((x.shape[0], w.shape[-1]), device=x.device,
                      dtype=x.dtype)
    for s in range(w.shape[0]):
        live = (r >= bases[s]) & (r < bases[s] + counts[s])
        out = torch.where(live[:, None], torch.matmul(x, w[s]), out)
    return out


def dynamic_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Dynamic-operand matmul ``x (..., m, k) @ y (..., k, n)``."""
    k = x.shape[-1]
    m = x.numel() // k
    n = y.shape[-1]
    _record(DYNAMIC, 2.0 * m * k * n)
    return torch.matmul(x, y)


def dynamic_einsum(spec: str, *operands) -> torch.Tensor:
    """einsum on the DYNAMIC engine, with flop accounting."""
    _record(DYNAMIC, _einsum_flops(spec, operands))
    return torch.einsum(spec, *operands)


def _einsum_flops(spec: str, operands) -> float:
    inputs, _out = spec.replace(" ", "").split("->")
    terms = inputs.split(",")
    dim_size: Dict[str, int] = {}
    for term, op in zip(terms, operands):
        for ch, s in zip(term, op.shape):
            dim_size[ch] = s
    total = 1
    for s in dim_size.values():
        total *= s
    return 2.0 * total


@dataclass
class BreakdownReport:
    """Eq. 5 check: MM_ReRAM / MM_systolic for one run of a function."""

    static_flops: float
    dynamic_flops: float
    nonlinear_elems: float

    @property
    def static_share(self) -> float:
        tot = self.static_flops + self.dynamic_flops
        return self.static_flops / tot if tot else 0.0

    @property
    def ratio(self) -> float:
        return self.static_flops / max(self.dynamic_flops, 1.0)


def breakdown_of(fn, *args, **kwargs) -> BreakdownReport:
    """Run ``fn(*args, **kwargs)`` under ``tally()`` and report the
    engine-class breakdown.

    Unlike the JAX package's ``breakdown_of``, which traces ``fn``
    abstractly, this runs ``fn`` for real on its inputs' device: the port
    counts when the code runs. Each layer of a Python loop counts, where
    the JAX tally counts a ``lax.scan`` body once."""
    with tally() as t:
        fn(*args, **kwargs)
    return BreakdownReport(t[STATIC], t[DYNAMIC], t["nonlinear"])
