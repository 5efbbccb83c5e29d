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
w = 1 leaves the state unchanged, which is how the model masks them.

Training: inputs that need a gradient go through ``WkvFn`` on either
device. Its forward is the same wrapper; its backward is
``rwkv6_wkv_bwd``, the gradient of (y, s_final) with respect to all six
inputs: ``csrc/rwkv6_wkv.cu``'s backward kernel on CUDA tensors (counted as
``rwkv6_wkv_bwd``), ``rwkv6_wkv_bwd_plain`` on CPU tensors. The JAX package
has no Pallas backward: it autodiffs its chunk-checkpointed ``wkv_scan``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build, workspace

HEAD_DIMS = (8, 16, 32, 64)   # head dims the recurrence is instantiated for
CHUNK_N = 64                  # the head dim of the chunked kernel
# The chunked kernel from this T on: where its device time falls below the
# recurrence's at rwkv6-7b's shapes on an H100 (chip_smoke.py's crossover
# cases; the numbers are in the source's note and PERF.md).
CHUNK_MIN_T = 8
KERNELS = ("auto", "recurrent", "chunk")
# the backward kernel keeps the forward's state every BWD_CHECKPOINT steps
# (as the JAX package's wkv_scan checkpoints its scan) and, for the chunk
# it is in, every BWD_STAGE steps, in its workspace; it recomputes the
# states of BWD_STAGE steps at a time in shared memory
BWD_CHECKPOINT = 64
BWD_STAGE = 8
WORKSPACES = workspace.Workspaces("rwkv6_wkv_bwd")
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


def rwkv6_wkv_bwd_plain(r, k, v, w, u, s0, dy, ds=None):
    """The gradient of ``(y, s_final) = rwkv6_wkv_plain(...)`` with respect
    to r, k, v, w (B, T, H, N), u (H, N) and s0 (B, H, N, N), from dy (B,
    T, H, N) and ds (B, H, N, N; None for zero), one step at a time in f32.
    With S_t the state after step t, per head and step:
    dr_t = S_{t-1} dy_t + u * k_t (v_t . dy_t); dk_t = dS_t v_t + u * r_t
    (v_t . dy_t); dv_t = dS_t^T k_t + (r_t . (u * k_t)) dy_t; dw_t[i] =
    sum_j dS_t[i, j] S_{t-1}[i, j]; du = sum over rows and steps of r_t *
    k_t (v_t . dy_t); dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T, ds0 = dS_0.
    Returns (dr, dk, dv, dw, du, ds0), f32."""
    f32 = torch.float32
    r, k, v, w, dy = (x.to(f32) for x in (r, k, v, w, dy))
    uu = u.to(f32)
    states = [s0.to(f32)]                                  # S_0 .. S_{T-1}
    for t in range(r.shape[1] - 1):
        states.append(w[:, t, :, :, None] * states[-1]
                      + k[:, t, :, :, None] * v[:, t, :, None, :])
    dS = (torch.zeros_like(states[0]) if ds is None else ds.to(f32))
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(uu)
    for t in reversed(range(r.shape[1])):
        rt, kt, vt, wt, dyt = r[:, t], k[:, t], v[:, t], w[:, t], dy[:, t]
        vdy = (vt * dyt).sum(-1, keepdim=True)               # (B, H, 1)
        s_prev = states[t]
        dr[:, t] = torch.einsum("bhij,bhj->bhi", s_prev, dyt) + uu * kt * vdy
        dk[:, t] = torch.einsum("bhij,bhj->bhi", dS, vt) + uu * rt * vdy
        dv[:, t] = (torch.einsum("bhij,bhi->bhj", dS, kt)
                    + (rt * uu * kt).sum(-1, keepdim=True) * dyt)
        dw[:, t] = (dS * s_prev).sum(-1)
        du = du + (rt * kt * vdy).sum(0)
        dS = wt[..., :, None] * dS + rt[..., :, None] * dyt[..., None, :]
    return dr, dk, dv, dw, du, dS


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("rwkv6_wkv")
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rwkv6_wkv.argtypes = [vp] * 8 + [ci] * 4 + [cl] * 3 + [ci, vp]
        lib.rwkv6_wkv.restype = ci
        lib.rwkv6_wkv_bwd.argtypes = ([vp] * 14 + [vp, cl] + [ci] * 4
                                      + [cl] * 3 + [vp])
        lib.rwkv6_wkv_bwd.restype = ci
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
    on_cpu = all(t.device.type == "cpu" for t in (r, k, v, w, u, s0))
    if not (on_cpu or r.is_cuda):
        raise ValueError(f"rwkv6_wkv: r on {r.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, s0)):
        return WkvFn.apply(r, k, v, w, u, s0, kernel)
    if not r.is_cuda:
        return rwkv6_wkv_plain(r, k, v, w, u, s0)
    return _launch(r, k, v, w, u, s0, kernel)


def _launch(r, k, v, w, u, s0, kernel):
    """One of the two forward kernels on CUDA tensors (no autograd)."""
    B, T, H, N = r.shape
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


def _bwd_need(B, T, H, N):
    """f32 floats of the backward's workspace: per (b, h) the state at each
    ``BWD_CHECKPOINT``-step boundary and, for the chunk being walked, at
    each ``BWD_STAGE``-step boundary in it."""
    chunks = -(-T // BWD_CHECKPOINT)
    return B * H * (chunks + BWD_CHECKPOINT // BWD_STAGE) * N * N


def rwkv6_wkv_bwd(r, k, v, w, u, s0, dy, ds=None):
    """The gradient of ``rwkv6_wkv`` with respect to (r, k, v, w, u, s0),
    from dy (B, T, H, N) and ds (B, H, N, N), the gradients of y and
    s_final (``ds`` None for zero). Returns (dr, dk, dv, dw) (B, T, H, N),
    du (H, N) and ds0 (B, H, N, N), f32.

    On CUDA tensors it launches ``csrc/rwkv6_wkv.cu``'s backward kernel:
    one block per (b, h) sweeps the forward, keeping the state every
    ``BWD_CHECKPOINT`` steps in the workspace, then walks the chunks back,
    recomputing their states ``BWD_STAGE`` steps at a time; r/k/v/w are
    read through their strides, as the forward reads them; dy and ds must
    be contiguous. On CPU tensors it runs ``rwkv6_wkv_bwd_plain``."""
    B, T, H, N = shape = r.shape
    for name, t, want in (("k", k, shape), ("v", v, shape), ("w", w, shape),
                          ("u", u, (H, N)), ("s0", s0, (B, H, N, N)),
                          ("dy", dy, shape)):
        if t.shape != want:
            raise ValueError(f"{name} {tuple(t.shape)}, expected "
                             f"{tuple(want)}")
    if ds is not None and ds.shape != (B, H, N, N):
        raise ValueError(f"ds {tuple(ds.shape)}, expected {(B, H, N, N)}")
    given = [t for t in (r, k, v, w, u, s0, dy, ds) if t is not None]
    if all(t.device.type == "cpu" for t in given):
        return rwkv6_wkv_bwd_plain(r, k, v, w, u, s0, dy, ds)
    if not r.is_cuda:
        raise ValueError(f"rwkv6_wkv_bwd: r on {r.device}")
    _check(r, k, v, w, u, s0)
    dev = r.get_device()
    for name, t in (("dy", dy), ("ds", ds)):
        if t is None:
            continue
        if t.get_device() != dev or t.dtype is not torch.float32:
            raise ValueError(f"rwkv6_wkv_bwd: {name} is {t.dtype} on "
                             f"{t.device}, r f32 on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"rwkv6_wkv_bwd needs a contiguous {name}")
    grads = [r.new_empty(shape) for _ in range(4)]
    du_rows = r.new_empty((B, H, N))
    ds0 = r.new_empty((B, H, N, N))
    if B == 0:
        return (*grads, u.new_zeros((H, N)), ds0)
    need = _bwd_need(B, T, H, N)
    ws, ws_n, _, _ = WORKSPACES.pointers((need, 0), dev)
    sb, st, sh, _ = r.stride()
    rc = kernels.call_on(
        _lib().rwkv6_wkv_bwd, dev, r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), s0.data_ptr(), dy.data_ptr(),
        0 if ds is None else ds.data_ptr(), *(t.data_ptr() for t in grads),
        du_rows.data_ptr(), ds0.data_ptr(), ws, ws_n, B, T, H, N, sb, st, sh,
        torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"rwkv6_wkv_bwd launch failed: CUDA error {rc} "
                           f"(B={B}, T={T}, H={H}, N={N})")
    kernels.LAUNCHES["rwkv6_wkv_bwd"] += 1
    # du sums the rows' parts in a fixed order (no atomics in the kernel)
    return (*grads, du_rows.sum(0), ds0)


class WkvFn(torch.autograd.Function):
    """``rwkv6_wkv`` with a backward: the forward kernels (the plain
    recurrence on CPU tensors), then ``rwkv6_wkv_bwd`` (its plain version
    on CPU tensors). Saves only the six inputs."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, kernel):
        ctx.save_for_backward(r, k, v, w, u, s0)
        # an output the loss does not use (s_final, in training) gets None,
        # not a tensor of zeros for the kernel to read
        ctx.set_materialize_grads(False)
        if r.device.type == "cpu":
            return rwkv6_wkv_plain(r, k, v, w, u, s0)
        return _launch(r, k, v, w, u, s0, kernel)

    @staticmethod
    def backward(ctx, dy, ds):
        need = ctx.needs_input_grad[:6]
        if not any(need):
            return (None,) * 7
        r, k, v, w, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r, dtype=torch.float32)
        grads = rwkv6_wkv_bwd(r, k, v, w, u, s0, dy.contiguous(),
                              None if ds is None else ds.contiguous())
        return (*(g if n else None for g, n in zip(grads, need)), None)
