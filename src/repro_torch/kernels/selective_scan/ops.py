"""Selective scan of the Mamba block: the CUDA kernel's wrapper and its
plain version.

``selective_scan(dt, Bc, Cc, xi, A, h0)`` computes, per batch row and
channel d, ``h_t = exp(dt_t A[d]) ⊙ h_{t-1} + dt_t x_t B_t`` and ``y_t =
h_t · C_t`` from ``h = h0``, and returns ``(y (B, T, D), h_T (B, D, N))``:
what the JAX package's ``_selective_scan`` (``repro.models.ssm``, plain
JAX: a ``lax.scan`` over chunks with an ``associative_scan`` inside, no
Pallas call) returns, whatever its chunk. dt and xi are (B, T, D) f32, Bc
and Cc (B, T, N) f32, A (D, N) and h0 (B, D, N) f32. On CUDA tensors it
launches ``csrc/selective_scan.cu`` (counted as ``selective_scan`` in
``kernels.LAUNCHES``, one a call): dt, xi, A and h0 contiguous, Bc and Cc
read through their batch and time strides (the model's are views of one
projection) with a unit stride along N, N in ``STATES``. Below
``CHUNK_MIN_T`` steps (decode) it runs the register kernel, from it on
(the verify tick, chunks, prompts) the tiled one (step tiles staged in
shared memory by asynchronous copies); ``kernel="recurrent"`` or
``"tiled"`` forces one. On CPU tensors it runs ``selective_scan_plain``. A step with dt = 0 leaves the
state unchanged: that is how the model masks a ragged chunk's padded tail.

Training: the kernel has no backward. Inputs that need a gradient raise
``NotImplementedError`` on CUDA tensors (ROADMAP Queue 1 item 28, the scan
backward); on CPU tensors autograd runs through the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build

# the d_state values the kernel is built for: jamba's 16 and the reduced
# configs' 4
STATES = (4, 16)
# T from which the tiled kernel runs; below it the register kernel, whose
# one-step-ahead loads cover a few steps: at jamba's width on 8 slots the
# tiled kernel is the faster from T = 5 (benchmarks/torch_scan_tiles.py,
# PERF.md)
CHUNK_MIN_T = 5
KERNELS = ("auto", "recurrent", "tiled")
_LIB = None


def selective_scan_plain(dt, Bc, Cc, xi, A, h0):
    """The recurrence one step at a time, in f32."""
    f32 = torch.float32
    dt, Bc, Cc, xi = (t.to(f32) for t in (dt, Bc, Cc, xi))
    A = A.to(f32)
    h = h0.to(f32)
    ys = []
    for t in range(dt.shape[1]):
        a = torch.exp(dt[:, t, :, None] * A)                     # (B, D, N)
        bx = (dt[:, t] * xi[:, t])[..., None] * Bc[:, t][:, None, :]
        h = a * h + bx
        ys.append(torch.einsum("bdn,bn->bd", h, Cc[:, t]))
    if not ys:
        return dt.new_zeros(dt.shape), h
    return torch.stack(ys, dim=1), h


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("selective_scan")
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.selective_scan.argtypes = ([vp] * 8 + [ci] * 4 + [cl] * 4
                                       + [ci, vp])
        lib.selective_scan.restype = ci
        _LIB = lib
    return _LIB


def _check(dt, Bc, Cc, xi, A, h0) -> None:
    """What the kernel takes, for dt on a CUDA device."""
    N = A.shape[1]
    if N not in STATES:
        raise ValueError(f"selective_scan kernel takes d_state in {STATES}, "
                         f"got {N}")
    dev = dt.get_device()
    for name, t in (("dt", dt), ("Bc", Bc), ("Cc", Cc), ("xi", xi),
                    ("A", A), ("h0", h0)):
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{name} on {t.device}, dt on {dt.device}")
        if t.dtype is not torch.float32:
            raise TypeError(f"selective_scan kernel takes f32, {name} is "
                            f"{t.dtype}")
    for name, t in (("dt", dt), ("xi", xi), ("A", A), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"selective_scan needs a contiguous {name}")
    for name, t in (("Bc", Bc), ("Cc", Cc)):
        if t.stride(2) != 1:
            raise ValueError(f"selective_scan needs a unit stride along N "
                             f"in {name}")


def selective_scan(dt, Bc, Cc, xi, A, h0, *, kernel: str = "auto"):
    """dt, xi (B, T, D) f32; Bc, Cc (B, T, N); A (D, N); h0 (B, D, N).
    Returns y (B, T, D), h_final (B, D, N). ``kernel`` picks the CUDA
    kernel: ``"auto"`` the tiled one from T = ``CHUNK_MIN_T`` on, the
    register one below it; ``"recurrent"`` or ``"tiled"`` force one, to
    measure the crossover."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r}, expected one of {KERNELS}")
    B, T, D = dt.shape
    N = A.shape[-1]
    for name, t, want in (("xi", xi, (B, T, D)), ("Bc", Bc, (B, T, N)),
                          ("Cc", Cc, (B, T, N)), ("A", A, (D, N)),
                          ("h0", h0, (B, D, N))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)}, expected {want}")
    args = (dt, Bc, Cc, xi, A, h0)
    if all(t.device.type == "cpu" for t in args):
        return selective_scan_plain(*args)
    if not dt.is_cuda:
        raise ValueError(f"selective_scan: dt on {dt.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise NotImplementedError(
            "selective_scan has no backward kernel on CUDA yet (ROADMAP "
            "Queue 1 item 28: the scan backward)")
    _check(*args)
    y = dt.new_empty((B, T, D))
    h_final = dt.new_empty((B, D, N))
    if B == 0:
        return y, h_final
    tiled = T >= CHUNK_MIN_T if kernel == "auto" else kernel == "tiled"
    dev = dt.get_device()
    rc = kernels.call_on(
        _lib().selective_scan, dev, dt.data_ptr(), Bc.data_ptr(),
        Cc.data_ptr(), xi.data_ptr(), A.data_ptr(), h0.data_ptr(),
        y.data_ptr(), h_final.data_ptr(), B, T, D, N, Bc.stride(0),
        Bc.stride(1), Cc.stride(0), Cc.stride(1), int(tiled),
        torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"selective_scan launch failed: CUDA error {rc} "
                           f"(B={B}, T={T}, D={D}, N={N})")
    kernels.LAUNCHES["selective_scan"] += 1
    return y, h_final
