"""RWKV6 wkv recurrence: the CUDA kernel's wrapper and its plain version
(port of ``repro.kernels.rwkv6_wkv``).

``rwkv6_wkv(r, k, v, w, u, s0)`` computes, per batch row and head,
``y_t = r_t · (S + u ⊙ k_t v_tᵀ)`` and ``S ← diag(w_t) S + k_t v_tᵀ`` from
``S = s0``, and returns ``(y, s_final)``. r/k/v/w are (B, T, H, N) f32, u
(H, N) f32, s0 (B, H, N, N) f32. On CUDA tensors it launches
``csrc/rwkv6_wkv.cu``, which reads the (B, T, H, N) layout through its
strides (no head folding or padding copies); on CPU tensors it runs
``rwkv6_wkv_plain``. Ragged steps are the caller's: a step with k = 0 and
w = 1 leaves the state unchanged, which is how the model masks them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build

HEAD_DIMS = (8, 16, 32, 64)   # head dims the kernel is instantiated for
_LIB = None


def rwkv6_wkv_plain(r, k, v, w, u, s0):
    """The sequential recurrence, one step at a time, in f32."""
    r, k, v, w = (x.to(torch.float32) for x in (r, k, v, w))
    s = s0.to(torch.float32)
    uu = u.to(torch.float32)[..., :, None]                   # (H, N, 1)
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # (B, H, N, N)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], s + uu * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("rwkv6_wkv")
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rwkv6_wkv.argtypes = [vp] * 8 + [ci] * 4 + [cl] * 3 + [vp]
        lib.rwkv6_wkv.restype = ci
        _LIB = lib
    return _LIB


def _check(r, k, v, w, u, s0) -> None:
    B, T, H, N = r.shape
    if N not in HEAD_DIMS:
        raise ValueError(f"rwkv6_wkv kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {N}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"rwkv6_wkv kernel takes f32, {name} is {t.dtype}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.stride() != r.stride():
            raise ValueError(f"{name} strides {t.stride()} differ from r's "
                             f"{r.stride()}")
    if r.stride(-1) != 1:
        raise ValueError("rwkv6_wkv needs a unit stride along head_dim")
    for name, t in (("u", u), ("s0", s0)):
        if not t.is_contiguous():
            raise ValueError(f"rwkv6_wkv needs a contiguous {name}")


def rwkv6_wkv(r, k, v, w, u, s0):
    """r/k/v/w (B, T, H, N) f32; u (H, N); s0 (B, H, N, N).
    Returns y (B, T, H, N), s_final (B, H, N, N)."""
    B, T, H, N = r.shape
    for name, t, shape in (("k", k, r.shape), ("v", v, r.shape),
                           ("w", w, r.shape), ("u", u, (H, N)),
                           ("s0", s0, (B, H, N, N))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    tensors = (r, k, v, w, u, s0)
    if all(t.device.type == "cpu" for t in tensors):
        return rwkv6_wkv_plain(*tensors)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv: r on {r.device}")
    _check(*tensors)
    y = torch.empty((B, T, H, N), device=r.device, dtype=torch.float32)
    s_final = torch.empty((B, H, N, N), device=r.device, dtype=torch.float32)
    if B == 0:
        return y, s_final
    sb, st, sh, _ = r.stride()
    with torch.cuda.device(r.device):
        rc = _lib().rwkv6_wkv(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_final.data_ptr(),
            B, T, H, N, sb, st, sh, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6_wkv launch failed: CUDA error {rc} "
                           f"(B={B}, T={T}, H={H}, N={N})")
    kernels.LAUNCHES["rwkv6_wkv"] += 1
    return y, s_final
