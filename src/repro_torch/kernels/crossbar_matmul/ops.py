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

``grouped_crossbar_matmul(x, qt, bases, counts, kernel)``: the expert
products of a mixture-of-experts layer. ``qt`` stacks the slots' (K, N)
weights as (slots, K, N); the rows of ``x`` (R, K) are grouped by slot
(slot s owns rows ``bases[s]`` .. ``bases[s] + counts[s] - 1``, then
padding to ``bases[s + 1]``; ``bases`` are multiples of the kernel's row
tile, ``GROUPED_TILE``). Every live row gets its slot's product and every
other row 0. On a CUDA tensor it launches the same source's grouped
kernels, which read ``bases`` and ``counts`` from device memory (a CUDA
graph captures the call whatever the routing): at decode a fixed grid of
whole blocks per SM over a work list of the live row groups that it
derives from ``counts`` (``grouped_decode_work_list`` mirrors it); on a
CPU tensor
``grouped_crossbar_matmul_plain``. An x that needs a gradient goes through
``GroupedCrossbarMatmulFn`` on either device, as in ``crossbar_matmul``:
its backward is ``grouped_crossbar_matmul_t`` (dx = g . dequant(W_s)^T
over each slot's live rows, 0 in every other row), the transposed kernel's
body over the buffer's 64-row tiles on CUDA tensors,
``grouped_crossbar_matmul_t_plain`` on CPU tensors. It takes the prefill
kernel's layout only (bases multiples of 64): under grad the decode
kernel's 8-row layout raises.
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
        lib.grouped_crossbar_matmul.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_size_t, ctypes.c_void_p,
                                     ctypes.c_int]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.grouped_crossbar_matmul.restype = ctypes.c_int
        lib.grouped_crossbar_matmul_workspace.argtypes = (
            [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)])
        lib.grouped_crossbar_matmul_workspace.restype = ctypes.c_size_t
        lib.grouped_crossbar_matmul_t.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_size_t, ctypes.c_void_p,
                                     ctypes.c_int]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.grouped_crossbar_matmul_t.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# (M, Kp, Np, bits, kernel) -> (f32 partials, int tickets) the call needs;
# kernel "t" for ``crossbar_matmul_t`` and ``grouped_crossbar_matmul_t``
# (R rows), ("grouped", 1 or 2) for ``grouped_crossbar_matmul``'s decode or
# prefill kernel
_NEEDS: Dict[tuple, Tuple[int, int]] = {}
# the split workspace of the forward kernels and of the transposed ones
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
        elif isinstance(kernel, tuple):
            partials = _lib().grouped_crossbar_matmul_workspace(
                M, kp, np_, bits, kernel[1], ctypes.byref(tickets))
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


# ---------------------------------------------------------------------------
# grouped: the expert products of a mixture-of-experts layer
# ---------------------------------------------------------------------------

# rows a block of each grouped kernel owns: every slot's rows are padded to
# a multiple of it
GROUPED_TILE = {"decode": 8, "prefill": 64}
DECODE_MAX_BYTES = 96 << 20     # csrc/crossbar_matmul.cu kDecodeMaxBytes


def grouped_kernel(rows: int, qt: QuantizedTensor) -> str:
    """The grouped kernel for ``rows`` routed assignments over the slots of
    ``qt`` (slots, K, N), by ``picks_decode``'s rule on the rows a slot
    holds when they spread over as many slots as they can: the decode
    kernel while its passes over one slot's codes (one per 8 rows) read at
    most 96 MiB, or make one pass."""
    slots = qt.codes.shape[0]
    per = -(-rows // max(1, min(rows, slots)))
    passes = -(-per // 8)
    code_bytes = qt.codes[0].numel()
    return ("decode" if passes == 1 or passes * code_bytes
            <= DECODE_MAX_BYTES else "prefill")


def grouped_rows(rows: int, slots: int, tile: int) -> int:
    """Rows of a grouped buffer that holds ``rows`` assignments over
    ``slots`` slots, each slot's padded to a multiple of ``tile``: at most
    ``tile - 1`` padding rows for each slot that holds any."""
    n = rows + min(rows, slots) * (tile - 1)
    return -(-n // tile) * tile


# the grouped decode kernel's grid and work list (csrc/crossbar_matmul.cu
# grouped_live_decode_kernel): blocks per SM, warps a block, K splits of a
# tile at most
GROUPED_DECODE_BLOCKS_PER_SM = 4
DECODE_WARPS = 4
MAX_SPLIT = 32


def grouped_decode_grid(sms: int = 132) -> int:
    """Blocks of a grouped decode launch: whole blocks per SM, set by the
    card alone (a CUDA graph replays the call for any counts); its
    workspace holds a ticket for each and two work counters."""
    return GROUPED_DECODE_BLOCKS_PER_SM * sms


def grouped_decode_splits(live_groups: int, Np: int, Kp: int,
                          grid: int) -> int:
    """K splits of each (live row group, N tile): as many as the grid
    holds for the L live row groups' tiles, at most one K tile a warp and
    ``MAX_SPLIT``, at least 1 (``gd_splits``)."""
    tiles = live_groups * (Np // CROSSBAR)
    S = grid // tiles if tiles else 1
    most = -(-(Kp // CROSSBAR) // DECODE_WARPS)
    return max(1, min(S, most, MAX_SPLIT))


def grouped_decode_work_list(counts, bases, Kp: int, Np: int, grid: int):
    """The work list that each block of the grouped decode kernel derives
    from ``counts`` on the device (a pure mirror of its rule, for the
    tests; nothing on the card path calls it). Live row groups: slot s's
    ceil(counts[s] / 8) groups of 8 rows from ``bases[s]``, in slot order
    (L in all); units u = (nt * L + lg) * S + rank over N tiles nt, live
    row groups lg and K splits rank. With no more units than blocks, unit
    u runs on block ceil(u * grid / units); with more, block b runs unit
    b, then each free block the next one left. Returns one dict per unit,
    in order: block (None: the first free one), slot, m0 (first row),
    live (end of the slot's live rows), nt, rank, S, tile (its ticket)
    and k_tiles (the K tiles its warps read: warp w of split rank takes
    tiles rank * 4 + w, then every S * 4)."""
    groups = []
    for s, c in enumerate(int(c) for c in counts):
        for g in range(-(-c // 8)):
            groups.append((s, int(bases[s]) + 8 * g, int(bases[s]) + c))
    L, n_nt, n_kt = len(groups), Np // CROSSBAR, Kp // CROSSBAR
    S = grouped_decode_splits(L, Np, Kp, grid)
    units, n_units = [], L * n_nt * S
    for u in range(n_units):
        tile, rank = divmod(u, S)
        nt, lg = divmod(tile, L)
        s, m0, live = groups[lg]
        block = (-(-u * grid // n_units) if n_units <= grid
                 else u if u < grid else None)
        units.append(dict(block=block, slot=s, m0=m0, live=live, nt=nt,
                          rank=rank, S=S, tile=tile, k_tiles=sorted(
                              kt for w in range(DECODE_WARPS)
                              for kt in range(rank * DECODE_WARPS + w, n_kt,
                                              S * DECODE_WARPS))))
    return units


def grouped_crossbar_matmul_plain(x: torch.Tensor, qt: QuantizedTensor,
                                  bases: torch.Tensor,
                                  counts: torch.Tensor) -> torch.Tensor:
    """Per slot, dequantize then ``torch.matmul`` in f32 over its live rows;
    every other row 0. Reads ``bases`` and ``counts`` on the host."""
    out = torch.zeros((x.shape[0], qt.orig_shape[-1]), device=x.device,
                      dtype=torch.float32)
    xf = x.to(torch.float32)
    for s, (b, c) in enumerate(zip(bases.tolist(), counts.tolist())):
        if c:
            w = dequantize(qt.layer(s), torch.float32)
            out[b:b + c] = torch.matmul(xf[b:b + c], w)
    return out.to(x.dtype)


def grouped_crossbar_matmul_t_plain(g: torch.Tensor, qt: QuantizedTensor,
                                    bases: torch.Tensor,
                                    counts: torch.Tensor) -> torch.Tensor:
    """g (R, N) -> dx (R, K) f32: per slot, dequantize then ``g .
    W^T`` over its live rows; every other row 0 (the gradient of
    ``grouped_crossbar_matmul`` with respect to x). Reads ``bases`` and
    ``counts`` on the host."""
    out = torch.zeros((g.shape[0], qt.orig_shape[-2]), device=g.device,
                      dtype=torch.float32)
    gf = g.to(torch.float32)
    for s, (b, c) in enumerate(zip(bases.tolist(), counts.tolist())):
        if c:
            w = dequantize(qt.layer(s), torch.float32)
            out[b:b + c] = torch.matmul(gf[b:b + c], w.T)
    return out


def _check_grouped(x, qt, bases, counts, kernel, *,
                   transposed: bool = False) -> None:
    """The shapes of a grouped call: x (R, K), or with ``transposed`` g
    (R, N), over a (slots, K, N) weight; R a multiple of the row tile."""
    name = ("grouped_crossbar_matmul_t" if transposed
            else "grouped_crossbar_matmul")
    if qt.ndim != 3:
        raise ValueError(f"{name} takes a (slots, K, N) weight, got "
                         f"orig_shape {qt.orig_shape}")
    slots, K, N = qt.orig_shape
    if qt.codes.shape[0] != slots:
        raise ValueError(f"codes {tuple(qt.codes.shape)} of {slots} slots")
    width = N if transposed else K
    if x.ndim != 2 or x.shape[1] != width:
        raise ValueError(f"{'g' if transposed else 'x'} {tuple(x.shape)} "
                         f"with weight ({slots}, {K}, {N}): it must be (R, "
                         f"{width})")
    if tuple(bases.shape) != (slots + 1,) or tuple(counts.shape) != (slots,):
        raise ValueError(f"bases {tuple(bases.shape)} / counts "
                         f"{tuple(counts.shape)} for {slots} slots")
    if kernel not in GROUPED_TILE:
        raise ValueError(f"kernel {kernel!r} (expected one of "
                         f"{sorted(GROUPED_TILE)})")
    if x.shape[0] % GROUPED_TILE[kernel]:
        raise ValueError(f"{x.shape[0]} rows: the {kernel} kernel's buffer "
                         f"is a multiple of {GROUPED_TILE[kernel]} rows")


def _grouped_weight_kp(qt: QuantizedTensor, device: torch.device) -> int:
    """``_check_weight`` for each slot's (K, N) weight; returns the padded
    K. The stack must be contiguous (one slot's codes after another's)."""
    kp = _weight_kp(qt.layer(0), device)
    for name, t in (("codes", qt.codes), ("scales", qt.scales)):
        if not t.is_contiguous():
            raise ValueError(f"grouped_crossbar_matmul needs contiguous "
                             f"{name}")
    return kp


def reserve_grouped_workspace(device: torch.device, weights, rows) -> None:
    """Size ``device``'s workspace for every grouped call of each (slots,
    K, N) weight of ``weights`` over each number of routed assignments in
    ``rows`` (the kernel and buffer that ``models.moe`` picks for it)."""
    most = (0, 0)
    for qt in weights:
        slots = qt.codes.shape[0]
        kp = qt.codes.shape[-2] * (2 if qt.bits == 4 else 1)
        for n in rows:
            kernel = grouped_kernel(n, qt)
            R = grouped_rows(n, slots, GROUPED_TILE[kernel])
            p, t = _need(R, kp, qt.codes.shape[-1], qt.bits,
                         ("grouped", KERNELS[kernel]))
            most = (max(most[0], p), max(most[1], t))
    WORKSPACES.reserve(device.index, most)


def _check_layout(name: str, bases: torch.Tensor, counts: torch.Tensor,
                  device: torch.device) -> None:
    for what, t in (("bases", bases), ("counts", counts)):
        if t.dtype != torch.int32 or t.device != device:
            raise TypeError(f"{what} must be int32 on {device}, got "
                            f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous {what}")


def grouped_crossbar_matmul(x: torch.Tensor, qt: QuantizedTensor,
                            bases: torch.Tensor, counts: torch.Tensor,
                            kernel: str) -> torch.Tensor:
    """x (R, K) grouped by slot @ qt (slots, K, N) -> (R, N): each live row
    of slot s times dequant(qt[s]), 0 in every other row. ``bases`` (slots
    + 1,) and ``counts`` (slots,) int32 on x's device; ``kernel``
    ("decode" or "prefill") fixes the row tile that ``bases`` respect.
    An ``x`` that needs a gradient goes through ``GroupedCrossbarMatmulFn``
    on either device; its dx takes the prefill kernel's layout only, so
    under grad ``kernel`` must be "prefill"."""
    _check_grouped(x, qt, bases, counts, kernel)
    on_cpu = x.device.type == "cpu" and qt.device.type == "cpu"
    if not on_cpu and x.device.type != "cuda":
        raise ValueError(f"grouped_crossbar_matmul: x on {x.device}, weight "
                         f"on {qt.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        if kernel != "prefill":
            raise ValueError(
                f"grouped_crossbar_matmul: an x that needs a gradient takes "
                f"the prefill kernel's layout (bases multiples of "
                f"{GROUPED_TILE['prefill']} rows), got kernel {kernel!r}")
        return GroupedCrossbarMatmulFn.apply(x, qt, bases, counts, kernel)
    if on_cpu:
        return grouped_crossbar_matmul_plain(x, qt, bases, counts)
    return _grouped_launch(x, qt, bases, counts, kernel)


def _grouped_launch(x: torch.Tensor, qt: QuantizedTensor,
                    bases: torch.Tensor, counts: torch.Tensor,
                    kernel: str) -> torch.Tensor:
    """The grouped forward kernel on CUDA tensors (no autograd)."""
    _check_x(x)
    _check_layout("grouped_crossbar_matmul", bases, counts, x.device)
    kp = _grouped_weight_kp(qt, x.device)
    slots, K, N = qt.orig_shape
    R = x.shape[0]
    out = torch.empty((R, N), device=x.device, dtype=torch.float32)
    if R == 0:
        return out
    np_, kind = qt.codes.shape[-1], KERNELS[kernel]
    dev = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ws = WORKSPACES.pointers(_need(R, kp, np_, qt.bits, ("grouped", kind)),
                             dev)
    rc = kernels.call_on(_lib().grouped_crossbar_matmul, dev, x.data_ptr(),
                         qt.codes.data_ptr(), qt.scales.data_ptr(),
                         out.data_ptr(), *ws, bases.data_ptr(),
                         counts.data_ptr(), slots, R, K, N, kp, np_, qt.bits,
                         kind, stream)
    if rc != 0:
        raise RuntimeError(f"grouped_crossbar_matmul launch failed: CUDA "
                           f"error {rc} (R={R}, slots={slots}, K={K}, N={N}, "
                           f"bits={qt.bits}, kernel={kernel})")
    kernels.LAUNCHES["grouped_crossbar_matmul"] += 1
    return out


def grouped_crossbar_matmul_t(g: torch.Tensor, qt: QuantizedTensor,
                              bases: torch.Tensor,
                              counts: torch.Tensor) -> torch.Tensor:
    """g (R, N) grouped by slot -> dx (R, K) f32: each live row of slot s
    times dequant(qt[s])^T, 0 in every other row; the backward of
    ``grouped_crossbar_matmul`` with respect to x. ``bases`` and
    ``counts`` as the forward took them, in the prefill kernel's layout
    (bases multiples of 64, R a multiple of 64). ``csrc/crossbar_matmul.cu``'s
    ``grouped_t_kernel`` on CUDA tensors (the slot read from each 64-row
    tile, N split through the shared workspace where the output tiles leave
    SMs idle; a tile that crosses into another slot, which bases off the
    64-row tile make, comes out NaN, never a finite wrong dx),
    ``grouped_crossbar_matmul_t_plain`` on CPU tensors (right for any
    layout)."""
    _check_grouped(g, qt, bases, counts, "prefill", transposed=True)
    if g.device.type == "cpu" and qt.device.type == "cpu":
        return grouped_crossbar_matmul_t_plain(g, qt, bases, counts)
    if g.device.type != "cuda":
        raise ValueError(f"grouped_crossbar_matmul_t: g on {g.device}, "
                         f"weight on {qt.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"grouped_crossbar_matmul_t takes an f32 g, got "
                        f"{g.dtype}")
    if not g.is_contiguous():
        raise ValueError("grouped_crossbar_matmul_t needs a contiguous g")
    _check_layout("grouped_crossbar_matmul_t", bases, counts, g.device)
    kp = _grouped_weight_kp(qt, g.device)
    slots, K, N = qt.orig_shape
    R = g.shape[0]
    out = torch.empty((R, K), device=g.device, dtype=torch.float32)
    if R == 0:
        return out
    np_, dev = qt.codes.shape[-1], g.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ws = WORKSPACES.pointers(_need(R, kp, np_, qt.bits, "t"), dev)
    rc = kernels.call_on(_lib().grouped_crossbar_matmul_t, dev, g.data_ptr(),
                         qt.codes.data_ptr(), qt.scales.data_ptr(),
                         out.data_ptr(), *ws, bases.data_ptr(),
                         counts.data_ptr(), slots, R, K, N, kp, np_, qt.bits,
                         stream)
    if rc != 0:
        raise RuntimeError(f"grouped_crossbar_matmul_t launch failed: CUDA "
                           f"error {rc} (R={R}, slots={slots}, K={K}, N={N}, "
                           f"bits={qt.bits})")
    kernels.LAUNCHES["grouped_crossbar_matmul_t"] += 1
    return out


class GroupedCrossbarMatmulFn(torch.autograd.Function):
    """``grouped_crossbar_matmul`` with a backward: forward by the grouped
    kernel, dx by ``grouped_crossbar_matmul_t`` (their plain versions on
    CPU tensors). The weight is frozen and the layout is routing: the
    codes, scales, ``bases`` and ``counts`` get no gradient."""

    @staticmethod
    def forward(ctx, x, qt, bases, counts, kernel):
        ctx.qt = qt
        ctx.save_for_backward(bases, counts)
        if x.device.type == "cpu":
            return grouped_crossbar_matmul_plain(x, qt, bases, counts)
        return _grouped_launch(x, qt, bases, counts, kernel)

    @staticmethod
    def backward(ctx, g):
        dx = None
        if ctx.needs_input_grad[0]:
            bases, counts = ctx.saved_tensors
            dx = grouped_crossbar_matmul_t(g.contiguous(), ctx.qt, bases,
                                           counts)
        return dx, None, None, None, None
