"""RWKV6 wkv recurrence: the CUDA kernel's wrapper and its plain version
(port of ``repro.kernels.rwkv6_wkv``).

``rwkv6_wkv(r, k, v, w, u, s0)`` computes, per batch row and head,
``y_t = r_t · (S + u ⊙ k_t v_tᵀ)`` and ``S ← diag(w_t) S + k_t v_tᵀ`` from
``S = s0``, and returns ``(y, s_final)``. r/k/v/w are (B, T, H, N) f32, u
(H, N) f32, s0 (B, H, N, N) f32. On CUDA tensors it launches one of the
two kernels of ``csrc/rwkv6_wkv.cu``, both reading the (B, T, H, N) layout
through its strides (no head folding or padding copies): the register
recurrence for decode and short chunks (counted as ``rwkv6_wkv`` in
``kernels.LAUNCHES``), the chunked tensor-core kernel from T =
``CHUNK_MIN_T`` on (``rwkv6_wkv_chunk``). On CPU tensors it runs
``rwkv6_wkv_plain``. Ragged steps are the caller's: a step with k = 0 and
w = 1 leaves the state unchanged, which is how the model masks them. The
kernels have no backward yet: on CUDA tensors that need a gradient the
wrapper raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build

HEAD_DIMS = (8, 16, 32, 64)   # head dims the recurrence is instantiated for
CHUNK_N = 64                  # the head dim of the chunked kernel
# The chunked kernel from this T on: where its device time falls below the
# recurrence's at rwkv6-7b's shapes on an H100 (chip_smoke.py's crossover
# cases; the numbers are in the source's note and PERF.md).
CHUNK_MIN_T = 8
KERNELS = ("auto", "recurrent", "chunk")
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
        lib.rwkv6_wkv.argtypes = [vp] * 8 + [ci] * 4 + [cl] * 3 + [ci, vp]
        lib.rwkv6_wkv.restype = ci
        _LIB = lib
    return _LIB


def _check(r, k, v, w, u, s0) -> None:
    """What both kernels take, for r on a CUDA device (cheap attribute
    reads: the wrapper is on the decode path)."""
    N = r.shape[3]
    if N not in HEAD_DIMS:
        raise ValueError(f"rwkv6_wkv kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {N}")
    dev, f32 = r.get_device(), torch.float32
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if t.get_device() != dev or not t.is_cuda:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
        if t.dtype is not f32:
            raise TypeError(f"rwkv6_wkv kernel takes f32, {name} is {t.dtype}")
    rs = r.stride()
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.stride() != rs:
            raise ValueError(f"{name} strides {t.stride()} differ from r's "
                             f"{rs}")
    if rs[3] != 1:
        raise ValueError("rwkv6_wkv needs a unit stride along head_dim")
    if not (u.is_contiguous() and s0.is_contiguous()):
        raise ValueError("rwkv6_wkv needs a contiguous u and s0")


def rwkv6_wkv(r, k, v, w, u, s0, *, kernel: str = "auto"):
    """r/k/v/w (B, T, H, N) f32; u (H, N); s0 (B, H, N, N).
    Returns y (B, T, H, N), s_final (B, H, N, N).

    ``kernel`` picks the CUDA kernel: ``"auto"`` the chunked kernel from
    T = ``CHUNK_MIN_T`` on where it takes the inputs (N = 64, 16-byte
    aligned rows), the recurrence otherwise; ``"recurrent"`` or
    ``"chunk"`` force one, to measure the crossover."""
    B, T, H, N = shape = r.shape
    for name, t, want in (("k", k, shape), ("v", v, shape), ("w", w, shape),
                          ("u", u, (H, N)), ("s0", s0, (B, H, N, N))):
        if t.shape != want:
            raise ValueError(f"{name} {tuple(t.shape)}, expected "
                             f"{tuple(want)}")
    if kernel not in KERNELS:
        raise ValueError(f"rwkv6_wkv kernel {kernel!r}, expected one of "
                         f"{KERNELS}")
    if not r.is_cuda:
        if all(t.device.type == "cpu" for t in (r, k, v, w, u, s0)):
            return rwkv6_wkv_plain(r, k, v, w, u, s0)
        raise ValueError(f"rwkv6_wkv: r on {r.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, s0)):
        # the kernels have no backward yet: never return a tensor that
        # cuts the autograd graph
        raise NotImplementedError(
            "rwkv6_wkv has no CUDA backward yet (ROADMAP Queue 1 item 22: "
            "rwkv training and the wkv backward kernel); run rwkv6-7b under "
            "torch.no_grad() on the card, or with rwkv_impl='ref'")
    _check(r, k, v, w, u, s0)
    sb, st, sh, _ = r.stride()
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr())
    # the chunked kernel takes N = 64 and 16-byte aligned rows
    chunk_ok = (N == CHUNK_N and (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]
                                  | ptrs[4]) & 15 == 0
                and (sb | st | sh) & 3 == 0)
    if kernel == "auto":
        chunked = chunk_ok and T >= CHUNK_MIN_T
    else:
        chunked = kernel == "chunk"
        if chunked and not chunk_ok:
            raise ValueError("the chunked rwkv6_wkv kernel takes N = 64 and "
                             "16-byte aligned r/k/v/w/u")
    y = r.new_empty((B, T, H, N))
    s_final = r.new_empty((B, H, N, N))
    if B == 0:
        return y, s_final
    dev = r.get_device()
    args = (*ptrs, s0.data_ptr(), y.data_ptr(), s_final.data_ptr(), B, T, H,
            N, sb, st, sh, int(chunked),
            torch._C._cuda_getCurrentRawStream(dev))
    if dev == torch.cuda.current_device():
        rc = _lib().rwkv6_wkv(*args)
    else:
        with torch.cuda.device(dev):
            rc = _lib().rwkv6_wkv(*args)
    if rc != 0:
        raise RuntimeError(f"rwkv6_wkv launch failed: CUDA error {rc} "
                           f"(B={B}, T={T}, H={H}, N={N}, "
                           f"chunked={chunked})")
    kernels.LAUNCHES["rwkv6_wkv_chunk" if chunked else "rwkv6_wkv"] += 1
    return y, s_final
