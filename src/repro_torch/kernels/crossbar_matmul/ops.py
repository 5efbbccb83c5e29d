"""Crossbar-quantized matmul: the CUDA kernel's wrapper and its plain
version (port of ``repro.kernels.crossbar_matmul``).

``crossbar_matmul(x, qt)`` computes ``x (..., K) @ dequant(qt) (K, N)``.
On a CUDA tensor it launches ``csrc/crossbar_matmul.cu`` (int8 or int4
codes, scale applied per 128-deep K tile after accumulation): a split-K
tensor-core kernel for decode-sized M, a wgmma kernel above that; on a CPU
tensor it runs ``crossbar_matmul_plain``. Ragged M, K and N are masked in
the kernel, so the wrapper makes no padded copies. A weight's checks run
once per weight (``_weight_kp``), x's on every call.

Training: an x that needs a gradient goes through ``CrossbarMatmulFn``
on either device. Its backward is ``crossbar_matmul_t`` (dx = g .
dequant(W)^T from the same codes): the prefill kernel's wgmma design
transposed on CUDA tensors, ``crossbar_matmul_t_plain`` on CPU tensors.
The codes and scales get no gradient.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch import kernels
from repro_torch.core.quant import QuantizedTensor, dequantize
from repro_torch.kernels import build, workspace

CROSSBAR = 128  # ReRAM crossbar size == quantization block == K tile
_LIB = None


def crossbar_matmul_plain(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Dequantize-then-matmul in f32: the same function as the kernel (the
    per-crossbar scales factor out of each 128-row block's partial sum)."""
    w = dequantize(qt, torch.float32)
    return torch.matmul(x.to(torch.float32), w).to(x.dtype)


def crossbar_matmul_t_plain(g: torch.Tensor,
                            qt: QuantizedTensor) -> torch.Tensor:
    """g (..., N) @ dequant(qt)^T -> (..., K) in f32: the gradient of
    ``crossbar_matmul`` with respect to x."""
    w = dequantize(qt, torch.float32)
    return torch.matmul(g.to(torch.float32), w.T)


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("crossbar_matmul")
        lib.crossbar_matmul_t.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_size_t, ctypes.c_void_p]
            + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.crossbar_matmul_t.restype = ctypes.c_int
        lib.crossbar_matmul_t_workspace.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
        lib.crossbar_matmul_t_workspace.restype = ctypes.c_size_t
        lib.crossbar_matmul.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_size_t, ctypes.c_void_p]
            + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.crossbar_matmul.restype = ctypes.c_int
        lib.crossbar_matmul_workspace.argtypes = (
            [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)])
        lib.crossbar_matmul_workspace.restype = ctypes.c_size_t
        _LIB = lib
    return _LIB


# (M, Kp, Np, bits, kernel) -> (f32 partials, int tickets) the call needs;
# kernel "t" for ``crossbar_matmul_t``
_NEEDS: Dict[tuple, Tuple[int, int]] = {}
# the split workspace of the forward kernels and of the transposed one
# (their calls run in order on one stream: ``kernels.workspace``)
WORKSPACES = workspace.Workspaces("crossbar_matmul")


def _need(M: int, kp: int, np_: int, bits: int, kernel) -> Tuple[int, int]:
    key = (M, kp, np_, bits, kernel)
    need = _NEEDS.get(key)
    if need is None:
        tickets = ctypes.c_int(0)
        if kernel == "t":
            partials = _lib().crossbar_matmul_t_workspace(
                M, kp, np_, ctypes.byref(tickets))
        else:
            partials = _lib().crossbar_matmul_workspace(
                M, kp, np_, bits, kernel, ctypes.byref(tickets))
        need = _NEEDS[key] = (partials, tickets.value)
    return need


def reserve_workspace(device: torch.device, weights, ms) -> None:
    """Size ``device``'s split-K workspace for the most that ``x (M, K) @
    qt`` needs over every weight ``qt`` of ``weights`` and every M of
    ``ms`` (the kernel the wrapper picks by itself), before a CUDA graph
    captures calls (``kernels.workspace``)."""
    most = (0, 0)
    for qt in weights:
        kp = qt.codes.shape[-2] * (2 if qt.bits == 4 else 1)
        for M in ms:
            p, t = _need(M, kp, qt.codes.shape[-1], qt.bits, KERNELS["auto"])
            most = (max(most[0], p), max(most[1], t))
    WORKSPACES.reserve(device.index, most)


def _check_shapes(x: torch.Tensor, qt: QuantizedTensor) -> None:
    if qt.ndim != 2:
        raise ValueError(f"crossbar_matmul takes a 2-D weight, got "
                         f"orig_shape {qt.orig_shape} (slice stacked layers "
                         f"with QuantizedTensor.layer)")
    K, N = qt.orig_shape
    if x.shape[-1] != K:
        raise ValueError(f"x (..., {x.shape[-1]}) @ weight ({K}, {N})")


def _check_x(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"crossbar_matmul kernel takes f32 activations, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("crossbar_matmul needs a contiguous x")


def _check_weight(qt: QuantizedTensor, device: torch.device) -> int:
    """Everything the kernel needs of the weight; returns the padded K."""
    if qt.block != CROSSBAR:
        raise ValueError(f"crossbar_matmul needs {CROSSBAR}x{CROSSBAR} "
                         f"blocks, got {qt.block}")
    K, N = qt.orig_shape
    want = torch.int8 if qt.bits == 8 else torch.uint8
    if qt.bits not in (8, 4) or qt.codes.dtype != want:
        raise TypeError(f"{qt.bits}-bit codes must be {want}, got "
                        f"{qt.codes.dtype}")
    if qt.scales.dtype != torch.float32:
        raise TypeError(f"scales must be f32, got {qt.scales.dtype}")
    for name, t in (("codes", qt.codes), ("scales", qt.scales)):
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"crossbar_matmul needs a contiguous {name}")
    kp = qt.codes.shape[0] * (2 if qt.bits == 4 else 1)
    np_ = qt.codes.shape[1]
    if (kp % CROSSBAR or np_ % CROSSBAR or kp < K or np_ < N
            or tuple(qt.scales.shape) != (kp // CROSSBAR, np_ // CROSSBAR)):
        raise ValueError(f"codes {tuple(qt.codes.shape)} / scales "
                         f"{tuple(qt.scales.shape)} do not tile {K}x{N}")
    if qt.codes.data_ptr() % 16:
        raise ValueError("codes must be 16-byte aligned")
    return kp


# Weights already checked, by everything the checks read: the codes' and
# scales' addresses, shapes, strides, dtypes and device, the bit width,
# block and original shape. A key that matches gives the same verdict, so
# the cache cannot go stale; it is cleared when it grows large.
_CHECKED: Dict[tuple, int] = {}


def _weight_kp(qt: QuantizedTensor, device: torch.device) -> int:
    c, s = qt.codes, qt.scales
    key = (c.data_ptr(), c.shape, c.stride(), c.dtype, c.device,
           s.data_ptr(), s.shape, s.stride(), s.dtype, s.device,
           qt.bits, qt.block, qt.orig_shape, device)
    kp = _CHECKED.get(key)
    if kp is None:
        kp = _check_weight(qt, device)
        if len(_CHECKED) >= 4096:
            _CHECKED.clear()
        _CHECKED[key] = kp
    return kp


KERNELS = {"auto": 0, "decode": 1, "prefill": 2}


def crossbar_matmul(x: torch.Tensor, qt: QuantizedTensor, *,
                    kernel: str = "auto") -> torch.Tensor:
    """x (..., K) @ qt (K, N) -> (..., N).

    ``kernel`` picks the CUDA kernel: ``"auto"`` lets the library choose
    (the split-K decode kernel while its passes over the codes, one per 8
    rows, stay small; the wgmma prefill kernel otherwise); ``"decode"`` or
    ``"prefill"`` force one, to measure the crossover. A CUDA ``x`` that
    needs a gradient goes through ``CrossbarMatmulFn`` on either device."""
    _check_shapes(x, qt)
    on_cpu = x.device.type == "cpu" and qt.device.type == "cpu"
    if not on_cpu and x.device.type != "cuda":
        raise ValueError(f"crossbar_matmul: x on {x.device}, weight on "
                         f"{qt.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        return CrossbarMatmulFn.apply(x, qt, kernel)
    if on_cpu:
        return crossbar_matmul_plain(x, qt)
    return _launch(x, qt, kernel)


def _launch(x: torch.Tensor, qt: QuantizedTensor, kernel: str) -> torch.Tensor:
    """The forward kernel on CUDA tensors (no autograd)."""
    _check_x(x)
    kp = _weight_kp(qt, x.device)
    K, N = qt.orig_shape
    lead = x.shape[:-1]
    M = x.numel() // K
    out = torch.empty((*lead, N), device=x.device, dtype=torch.float32)
    if M == 0:
        return out
    np_, kind = qt.codes.shape[1], KERNELS[kernel]
    dev = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ws = WORKSPACES.pointers(_need(M, kp, np_, qt.bits, kind), dev)
    rc = kernels.call_on(_lib().crossbar_matmul, dev, x.data_ptr(),
                         qt.codes.data_ptr(), qt.scales.data_ptr(),
                         out.data_ptr(), *ws, M, K, N, kp, np_, qt.bits, kind,
                         stream)
    if rc != 0:
        raise RuntimeError(f"crossbar_matmul launch failed: CUDA error {rc} "
                           f"(M={M}, K={K}, N={N}, bits={qt.bits})")
    kernels.LAUNCHES["crossbar_matmul"] += 1
    return out


def crossbar_matmul_t(g: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """g (..., N) @ dequant(qt)^T -> (..., K) f32, the backward of
    ``crossbar_matmul`` with respect to x: ``csrc/crossbar_matmul.cu``'s
    transposed wgmma kernel on CUDA tensors (N split over blocks through
    the shared workspace where the output tiles leave SMs idle),
    ``crossbar_matmul_t_plain`` on CPU tensors."""
    if qt.ndim != 2:
        raise ValueError(f"crossbar_matmul_t takes a 2-D weight, got "
                         f"orig_shape {qt.orig_shape}")
    K, N = qt.orig_shape
    if g.shape[-1] != N:
        raise ValueError(f"g (..., {g.shape[-1]}) @ weight ({K}, {N})^T")
    if g.device.type == "cpu" and qt.device.type == "cpu":
        return crossbar_matmul_t_plain(g, qt)
    if g.device.type != "cuda":
        raise ValueError(f"crossbar_matmul_t: g on {g.device}, weight on "
                         f"{qt.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"crossbar_matmul_t takes an f32 g, got {g.dtype}")
    if not g.is_contiguous():
        raise ValueError("crossbar_matmul_t needs a contiguous g")
    kp = _weight_kp(qt, g.device)
    M = g.numel() // N
    out = torch.empty((*g.shape[:-1], K), device=g.device,
                      dtype=torch.float32)
    if M == 0:
        return out
    np_, dev = qt.codes.shape[1], g.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ws = WORKSPACES.pointers(_need(M, kp, np_, qt.bits, "t"), dev)
    rc = kernels.call_on(_lib().crossbar_matmul_t, dev, g.data_ptr(),
                         qt.codes.data_ptr(), qt.scales.data_ptr(),
                         out.data_ptr(), *ws, M, K, N, kp, np_, qt.bits,
                         stream)
    if rc != 0:
        raise RuntimeError(f"crossbar_matmul_t launch failed: CUDA error {rc}"
                           f" (M={M}, K={K}, N={N}, bits={qt.bits})")
    kernels.LAUNCHES["crossbar_matmul_t"] += 1
    return out


class CrossbarMatmulFn(torch.autograd.Function):
    """``crossbar_matmul`` with a backward: forward by the forward kernel,
    dx by ``crossbar_matmul_t`` (their plain versions on CPU tensors).
    The weight is frozen: its codes and scales get no gradient."""

    @staticmethod
    def forward(ctx, x, qt, kernel):
        ctx.qt = qt
        if x.device.type == "cpu":
            return crossbar_matmul_plain(x, qt)
        return _launch(x, qt, kernel)

    @staticmethod
    def backward(ctx, g):
        dx = None
        if ctx.needs_input_grad[0]:
            dx = crossbar_matmul_t(g.contiguous(), ctx.qt)
        return dx, None, None
