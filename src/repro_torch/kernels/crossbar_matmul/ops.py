"""Crossbar-quantized matmul: the CUDA kernel's wrapper and its plain
version (port of ``repro.kernels.crossbar_matmul``).

``crossbar_matmul(x, qt)`` computes ``x (..., K) @ dequant(qt) (K, N)``.
On a CUDA tensor it launches ``csrc/crossbar_matmul.cu`` (int8 or int4
codes, scale applied per 128-deep K tile after accumulation); on a CPU
tensor it runs ``crossbar_matmul_plain``. Ragged M, K and N are masked in
the kernel, so the wrapper makes no padded copies.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core.quant import QuantizedTensor, dequantize
from repro_torch.kernels import build

CROSSBAR = 128  # ReRAM crossbar size == quantization block == K tile
_LIB = None


def crossbar_matmul_plain(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Dequantize-then-matmul in f32: the same function as the kernel (the
    per-crossbar scales factor out of each 128-row block's partial sum)."""
    w = dequantize(qt, torch.float32)
    return torch.matmul(x.to(torch.float32), w).to(x.dtype)


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("crossbar_matmul")
        lib.crossbar_matmul.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.crossbar_matmul.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_shapes(x: torch.Tensor, qt: QuantizedTensor) -> None:
    if qt.ndim != 2:
        raise ValueError(f"crossbar_matmul takes a 2-D weight, got "
                         f"orig_shape {qt.orig_shape} (slice stacked layers "
                         f"with QuantizedTensor.layer)")
    K, N = qt.orig_shape
    if x.shape[-1] != K:
        raise ValueError(f"x (..., {x.shape[-1]}) @ weight ({K}, {N})")


def _check(x: torch.Tensor, qt: QuantizedTensor) -> None:
    if qt.block != CROSSBAR:
        raise ValueError(f"crossbar_matmul needs {CROSSBAR}x{CROSSBAR} "
                         f"blocks, got {qt.block}")
    K, N = qt.orig_shape
    if x.dtype != torch.float32:
        raise TypeError(f"crossbar_matmul kernel takes f32 activations, got "
                        f"{x.dtype}")
    want = torch.int8 if qt.bits == 8 else torch.uint8
    if qt.bits not in (8, 4) or qt.codes.dtype != want:
        raise TypeError(f"{qt.bits}-bit codes must be {want}, got "
                        f"{qt.codes.dtype}")
    if qt.scales.dtype != torch.float32:
        raise TypeError(f"scales must be f32, got {qt.scales.dtype}")
    for name, t in (("x", x), ("codes", qt.codes), ("scales", qt.scales)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"crossbar_matmul needs a contiguous {name}")
    kp = qt.codes.shape[0] * (2 if qt.bits == 4 else 1)
    np_ = qt.codes.shape[1]
    if (kp % CROSSBAR or np_ % CROSSBAR or kp < K or np_ < N
            or tuple(qt.scales.shape) != (kp // CROSSBAR, np_ // CROSSBAR)):
        raise ValueError(f"codes {tuple(qt.codes.shape)} / scales "
                         f"{tuple(qt.scales.shape)} do not tile {K}x{N}")
    if qt.codes.data_ptr() % 4:
        raise ValueError("codes must be 4-byte aligned")


def crossbar_matmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """x (..., K) @ qt (K, N) -> (..., N)."""
    _check_shapes(x, qt)
    if x.device.type == "cpu" and qt.device.type == "cpu":
        return crossbar_matmul_plain(x, qt)
    if x.device.type != "cuda":
        raise ValueError(f"crossbar_matmul: x on {x.device}, weight on "
                         f"{qt.device}")
    _check(x, qt)
    K, N = qt.orig_shape
    lead = x.shape[:-1]
    M = x.numel() // K
    out = torch.empty((*lead, N), device=x.device, dtype=torch.float32)
    if M == 0:
        return out
    kp = qt.codes.shape[0] * (2 if qt.bits == 4 else 1)
    with torch.cuda.device(x.device):
        rc = _lib().crossbar_matmul(
            x.data_ptr(), qt.codes.data_ptr(), qt.scales.data_ptr(),
            out.data_ptr(), M, K, N, kp, qt.codes.shape[1], qt.bits,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"crossbar_matmul launch failed: CUDA error {rc} "
                           f"(M={M}, K={K}, N={N}, bits={qt.bits})")
    kernels.LAUNCHES["crossbar_matmul"] += 1
    return out
