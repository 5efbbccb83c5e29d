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
inputs: one of ``csrc/rwkv6_wkv.cu``'s two backward kernels on CUDA
tensors (the chunked tensor-core kernel at N = 64, the recurrence at the
other head dims; counted together as ``rwkv6_wkv_bwd``),
``rwkv6_wkv_bwd_plain`` on CPU tensors. The JAX package
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
KERNELS = ("auto", "recurrent", "chunk")   # of the forward and backward
# The backward's kernels: "chunk" (N = 64) walks sub-chunks of BWD_SUB
# steps on the tensor cores and keeps the state at the start of each in
# its workspace; "recurrent" (any of HEAD_DIMS) keeps the forward's state
# every BWD_CHECKPOINT steps (as the JAX package's wkv_scan checkpoints its
# scan) and, for the chunk it is in, every BWD_STAGE steps, recomputing
# the states of BWD_STAGE steps at a time in shared memory.
BWD_SUB = 16
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
                                      + [cl] * 3 + [ci, vp])
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


def _chunk_ok(N, ptrs, strides) -> bool:
    """Whether the chunked kernels take these inputs: N = 64, and 16-byte
    aligned rows (pointers, and strides a multiple of 4 floats)."""
    aligned = 0
    for p in ptrs:
        aligned |= p
    sb, st, sh = strides
    return N == CHUNK_N and aligned & 15 == 0 and (sb | st | sh) & 3 == 0


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
    chunk_ok = _chunk_ok(N, ptrs, (sb, st, sh))
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


def _bwd_need(B, T, H, N, chunked):
    """f32 floats of the backward's workspace: per (b, h) the state at the
    start of each ``BWD_SUB``-step sub-chunk (``chunked``), or at each
    ``BWD_CHECKPOINT``-step boundary and, for the chunk being walked, at
    each ``BWD_STAGE``-step boundary in it."""
    if chunked:
        return B * H * -(-T // BWD_SUB) * N * N
    chunks = -(-T // BWD_CHECKPOINT)
    return B * H * (chunks + BWD_CHECKPOINT // BWD_STAGE) * N * N


def rwkv6_wkv_bwd(r, k, v, w, u, s0, dy, ds=None, *, kernel: str = "auto"):
    """The gradient of ``rwkv6_wkv`` with respect to (r, k, v, w, u, s0),
    from dy (B, T, H, N) and ds (B, H, N, N), the gradients of y and
    s_final (``ds`` None for zero). Returns (dr, dk, dv, dw) (B, T, H, N),
    du (H, N) and ds0 (B, H, N, N), f32.

    On CUDA tensors it launches one of ``csrc/rwkv6_wkv.cu``'s two backward
    kernels (counted together as ``rwkv6_wkv_bwd``). ``kernel="auto"``
    takes the chunked kernel where it takes the inputs (N = 64, 16-byte
    aligned r/k/v/w/u/dy rows), the recurrence otherwise; ``"recurrent"``
    or ``"chunk"`` force one. The chunked kernel: one block of 16 warps
    per (b, h), four groups of them each owning 16 key rows, sweeps the
    forward on the tensor cores keeping the state at the start of every
    ``BWD_SUB``-step sub-chunk, then walks the sub-chunks back with their
    products in 3xTF32 on the tensor cores: 0.323 device ms at one
    rwkv6-7b train microbatch (B 2, T 512, H 64, N 64) on an NVIDIA H100
    80GB HBM3 at 700 W (``benchmarks/torch_wkv_bwd_phases.py``), against
    the recurrence's 0.646 (``chip_smoke.py``; PERF.md). The recurrence
    (any of ``HEAD_DIMS``): one block per (b, h) sweeps the forward,
    keeping the state every ``BWD_CHECKPOINT`` steps, then walks the
    chunks back, recomputing their states ``BWD_STAGE`` steps at a time,
    in f32. Both read r/k/v/w
    through their strides, as the forward reads them; dy and ds must be
    contiguous. On CPU tensors it runs ``rwkv6_wkv_bwd_plain``."""
    B, T, H, N = shape = r.shape
    for name, t, want in (("k", k, shape), ("v", v, shape), ("w", w, shape),
                          ("u", u, (H, N)), ("s0", s0, (B, H, N, N)),
                          ("dy", dy, shape)):
        if t.shape != want:
            raise ValueError(f"{name} {tuple(t.shape)}, expected "
                             f"{tuple(want)}")
    if ds is not None and ds.shape != (B, H, N, N):
        raise ValueError(f"ds {tuple(ds.shape)}, expected {(B, H, N, N)}")
    if kernel not in KERNELS:
        raise ValueError(f"rwkv6_wkv_bwd kernel {kernel!r}, expected one of "
                         f"{KERNELS}")
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
    sb, st, sh, _ = r.stride()
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), dy.data_ptr())
    chunk_ok = _chunk_ok(N, ptrs, (sb, st, sh))
    chunked = chunk_ok if kernel == "auto" else kernel == "chunk"
    if chunked and not chunk_ok:
        raise ValueError("the chunked rwkv6_wkv_bwd kernel takes N = 64 and "
                         "16-byte aligned r/k/v/w/u/dy")
    grads = [r.new_empty(shape) for _ in range(4)]
    du_rows = r.new_empty((B, H, N))
    ds0 = r.new_empty((B, H, N, N))
    if B == 0:
        return (*grads, u.new_zeros((H, N)), ds0)
    need = _bwd_need(B, T, H, N, chunked)
    ws, ws_n, _, _ = WORKSPACES.pointers((need, 0), dev)
    rc = kernels.call_on(
        _lib().rwkv6_wkv_bwd, dev, *ptrs[:5], s0.data_ptr(), ptrs[5],
        0 if ds is None else ds.data_ptr(), *(t.data_ptr() for t in grads),
        du_rows.data_ptr(), ds0.data_ptr(), ws, ws_n, B, T, H, N, sb, st, sh,
        int(chunked), torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"rwkv6_wkv_bwd launch failed: CUDA error {rc} "
                           f"(B={B}, T={T}, H={H}, N={N}, "
                           f"chunked={chunked})")
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
