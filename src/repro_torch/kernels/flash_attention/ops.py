"""Flash attention: the CUDA kernels' wrappers and their plain versions
(port of ``repro.kernels.flash_attention``).

``flash_attention`` takes the JAX package's public layout: q (B, T, Hq, D),
k/v (B, S, Hkv, D), explicit positions q_pos (B, T) / kv_pos (B, S) where
``kv_pos == -1`` marks an invalid key. ``paged_flash_attention`` computes
the same function with K/V read from one layer's page pool
(P, Hkv, page, D) through a block table, ``ring_flash_attention`` with
K/V read from a sliding-window layer's per-slot ring (B, Hkv, W, D) and
the chunk's own K/V, in one launch. All give 0 for a row that sees no
key, as the Pallas kernel does (``ref_attention`` gives the mean of V
there instead). Head dims ``HEAD_DIMS`` forward, ``BWD_HEAD_DIMS``
backward. On CUDA tensors the wrappers launch
``csrc/flash_attention.cu`` (tensor cores in 3xTF32, one block per kv
head's GQA group and row tile, causal tiles skipped, short query tiles
split over the context through a workspace, ``kernels.workspace``; at
head dims 128 and 256 row tiles on wgmma and decode in f32 over a work
list of the live keys that the kernel derives from ``lens``, mirrored by
``decode_work_list``); on CPU tensors they run the plain versions.

Training: q, k or v that need a gradient go through ``FlashAttentionFn``
on either device. Its forward also gives the per-row log-sum-exp ``lse``
(B, Hq, T), and its backward runs ``flash_attention_bwd`` (dq, dk, dv
recomputed from q, k, v, out and lse, as the JAX package's custom VJP of
its blocked attention): the kernels on CUDA tensors, the plain versions
on CPU tensors. The paged and ring kernels have no backward (training
never pages), so ``paged_flash_attention`` and ``ring_flash_attention``
raise for inputs that need a gradient.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels import build, workspace

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128, 256)   # head dims of the forward kernels
BWD_HEAD_DIMS = (8, 16, 32, 64)         # and of the backward kernels
_LIB = None


def visible_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                 window: Optional[int]) -> torch.Tensor:
    """(B, T, S) bool: 0 <= kv_pos <= q_pos (and q_pos - kv_pos < window)."""
    m = kv_pos[:, None, :] <= q_pos[:, :, None]
    m &= kv_pos[:, None, :] >= 0
    if window is not None:
        m &= (q_pos[:, :, None] - kv_pos[:, None, :]) < window
    return m


def flash_attention_plain(q, k, v, q_pos, kv_pos, *, window=None,
                          softcap=None, with_lse: bool = False):
    """Materialized f32 softmax attention; rows with no visible key -> 0.
    ``with_lse``: also return each row's log-sum-exp (B, Hq, T), as the
    forward kernel writes it for the backward."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.to(torch.float32).reshape(B, T, Hkv, G, D) * (D ** -0.5)
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.to(torch.float32))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = visible_mask(q_pos, kv_pos, window)[:, None, None]  # (B,1,1,T,S)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    l = p.sum(dim=-1).clamp_min(1e-30)                        # (B,Hkv,G,T)
    o = torch.einsum("bhgts,bshd->bthgd", p, v.to(torch.float32))
    o = o / l.permute(0, 3, 1, 2)[..., None]
    o = o.reshape(B, T, Hq, D).to(q.dtype)
    if not with_lse:
        return o
    lse = s.amax(dim=-1) + torch.log(l)                       # (B,Hkv,G,T)
    return o, lse.reshape(B, Hq, T)


def flash_attention_bwd_plain(q, k, v, q_pos, kv_pos, out, lse, dout, *,
                              window=None, softcap=None, block_kv: int = 512):
    """dq, dk, dv of ``flash_attention`` by the blocked recompute that the
    JAX package's custom VJP runs (``_flash_bwd_scoped``): per block of
    keys, p = exp(cap(s) - lse) under the mask, dv = p^T dout,
    ds = p (dout v^T - D_i) (times 1 - tanh^2 with a softcap), dq += ds k,
    dk = ds^T q D^-1/2; f32. ``lse`` (B, Hq, T) as the forward gives it."""
    f32 = torch.float32
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    c = D ** -0.5
    qg = q.to(f32).reshape(B, T, Hkv, G, D) * c
    do = dout.to(f32).reshape(B, T, Hkv, G, D)
    drow = torch.sum(do * out.to(f32).reshape(B, T, Hkv, G, D),
                     dim=-1).permute(0, 2, 3, 1)              # (B,Hkv,G,T)
    lse_g = lse.to(f32).reshape(B, Hkv, G, T)
    dq = torch.zeros((B, T, Hkv, G, D), dtype=f32, device=q.device)
    dk = torch.empty((B, S, Hkv, D), dtype=f32, device=q.device)
    dv = torch.empty((B, S, Hkv, D), dtype=f32, device=q.device)
    for s0 in range(0, S, block_kv):
        kb = k[:, s0:s0 + block_kv].to(f32)
        vb = v[:, s0:s0 + block_kv].to(f32)
        s = torch.einsum("bthgd,bshd->bhgts", qg, kb)
        dcap = None
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
            dcap = 1.0 - torch.square(t)
        msk = visible_mask(q_pos, kv_pos[:, s0:s0 + block_kv],
                           window)[:, None, None]
        p = torch.where(msk, torch.exp(s - lse_g[..., None]),
                        torch.zeros((), dtype=f32, device=q.device))
        dp = torch.einsum("bthgd,bshd->bhgts", do, vb)
        dv[:, s0:s0 + block_kv] = torch.einsum("bhgts,bthgd->bshd", p, do)
        ds = p * (dp - drow[..., None])
        if dcap is not None:
            ds = ds * dcap
        dq += torch.einsum("bhgts,bshd->bthgd", ds, kb)
        dk[:, s0:s0 + block_kv] = torch.einsum("bhgts,bthgd->bshd", ds, qg)
    dq = (dq * c).reshape(B, T, Hq, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def gather_pages(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Materialize one layer's pool (P, Hkv, page, D) through a block table
    (B, nb) as contiguous K or V (B, nb * page, Hkv, D); -1 entries read
    page 0 (masked by ``paged_kv_pos``)."""
    B, nb = block_table.shape
    _, Hkv, page, D = pool.shape
    g = pool[block_table.clamp_min(0).long()]        # (B, nb, Hkv, page, D)
    return g.permute(0, 1, 3, 2, 4).reshape(B, nb * page, Hkv, D)


def paged_kv_pos(block_table, lens, chunk_lens, page_size) -> torch.Tensor:
    """(B, nb * page) key positions: the global position where the key is
    mapped and below ``lens + chunk_lens``, else -1 (invisible)."""
    B, nb = block_table.shape
    gpos = torch.arange(nb * page_size, device=block_table.device)
    visible = torch.repeat_interleave(block_table >= 0, page_size, dim=1)
    end = (lens + chunk_lens)[:, None]
    ok = visible & (gpos[None, :] < end)
    return torch.where(ok, gpos[None, :], torch.full_like(gpos[None, :], -1))


def paged_flash_attention_plain(q, kp, vp, positions, block_table, lens,
                                chunk_lens, *, page_size, window=None,
                                softcap=None) -> torch.Tensor:
    kg = gather_pages(kp, block_table)
    vg = gather_pages(vp, block_table)
    kv_pos = paged_kv_pos(block_table, lens, chunk_lens, page_size)
    return flash_attention_plain(q, kg, vg, positions, kv_pos, window=window,
                                 softcap=softcap)


def ring_slot_pos(last: torch.Tensor, W: int) -> torch.Tensor:
    """(B, W) positions a ring of W slots holds when ``last`` (B, 1) is
    the latest position written: slot i holds the latest position
    congruent to i mod W, at most ``last`` (negative for a slot not yet
    written)."""
    i = torch.arange(W, device=last.device)[None, :]
    return last - torch.remainder(last - i, W)


def ring_kv_pos(lens, chunk_lens, positions, W: int) -> torch.Tensor:
    """(B, W + T) key positions of [a sliding layer's ring ; the chunk]:
    the ring's slots after ``lens`` positions (``ring_slot_pos``), chunk
    key t is ``positions[:, t]`` where t < ``chunk_lens``, else -1."""
    B, T = positions.shape
    hist = ring_slot_pos((lens.long() - 1)[:, None], W)
    t = torch.arange(T, device=positions.device)[None, :]
    chunk = torch.where(t < chunk_lens[:, None], positions.long(),
                        torch.full_like(hist[:, :1], -1))
    return torch.cat([hist, chunk], dim=1)


def ring_flash_attention_plain(q, k_ring, v_ring, k_chunk, v_chunk,
                               positions, lens, chunk_lens, *, window=None,
                               softcap=None) -> torch.Tensor:
    """The concatenation [ring (B, Hkv, W, D) ; chunk (B, T, Hkv, D)] that
    the JAX package's ``_paged_attend`` materializes, then
    ``flash_attention_plain``."""
    kg = torch.cat([k_ring.transpose(1, 2).to(q.dtype), k_chunk], dim=1)
    vg = torch.cat([v_ring.transpose(1, 2).to(q.dtype), v_chunk], dim=1)
    kv_pos = ring_kv_pos(lens, chunk_lens, positions, k_ring.shape[2])
    return flash_attention_plain(q, kg, vg, positions, kv_pos, window=window,
                                 softcap=softcap)


# ---------------------------------------------------------------------------
# the head-dim 128 and 256 kernels' cut, and their decode work list (mirrors)
# ---------------------------------------------------------------------------

# csrc/flash_attention.cu: ``wg_body``'s keys of a tile and rows of a block
# (row tiles, G*T > 8 rows), ``decode_body``'s rows (G*T <= 8), keys of a
# unit and blocks an SM holds
WG_KEYS = {128: 32, 256: 16}
WG_ROWS = {128: 128, 256: 64}
DECODE_ROWS = 8
DECODE_KEYS = 16
DECODE_BLOCKS_PER_SM = {128: 3, 256: 2}
MAX_SPLIT = 32                 # ``kMaxSplit``: splits of one item, at most


def decode_grid(B: int, Hkv: int, D: int, sms: int = 132) -> int:
    """Blocks of a decode launch at head dim 128 or 256 (``plan``): whole
    blocks per SM, at least one per (slot, kv head). Set by the shapes
    alone, so a captured CUDA graph stays valid while ``lens`` change."""
    want = max(B * Hkv, DECODE_BLOCKS_PER_SM[D] * sms)
    return -(-want // sms) * sms


def slot_units(kt: int, lens, chunk_lens, *, n_tiles: int = 0,
               ring_w: Optional[int] = None, pool_keys: Optional[int] = None):
    """Each slot's units, the tiles (``kt`` keys) that may hold a visible
    key, as ``decode_body`` counts them: the contiguous entry point's every tile
    (``n_tiles``); the paged one's tiles below min(pool_keys, lens +
    chunk_lens); the ring's written slots' tiles (min(lens, W)) then the
    chunk's (chunk_lens), as (ring units, all units) pairs."""
    out = []
    for b in range(len(lens)):
        if ring_w is not None:
            ur = -(-min(max(int(lens[b]), 0), ring_w) // kt)
            out.append((ur, ur + -(-int(chunk_lens[b]) // kt)))
        elif pool_keys is not None:
            end = min(pool_keys, int(lens[b]) + int(chunk_lens[b]))
            out.append((0, -(-end // kt)))
        else:
            out.append((0, n_tiles))
    return out


def decode_work_list(units, Hkv: int, grid: int):
    """The decode work list that each block of ``decode_body`` derives on
    the device (a pure mirror of its rule, for the tests; nothing on the card
    path calls it). ``units``: ``slot_units``' (ring units, units) per
    slot. Live slots (units > 0) get n = 1 + spare * units // (all units *
    Hkv) splits per kv head (at most units and ``MAX_SPLIT``), spare being
    the blocks beyond one per live (slot, head); slot b's heads take
    consecutive blocks in slot order. Returns one dict per block that has
    an item: block, b, h, split, n, first (the block of split 0, whose
    index its partials start at) and the unit range [u0, u1)."""
    U = sum(u for _, u in units)
    live = sum(1 for _, u in units if u > 0)
    spare = max(0, grid - live * Hkv)
    items, start = [], 0
    for b, (_, u) in enumerate(units):
        if u == 0:
            continue
        n = min(1 + spare * u // (U * Hkv), u, MAX_SPLIT)
        for h in range(Hkv):
            for j in range(n):
                items.append(dict(block=start + h * n + j, b=b, h=h, split=j,
                                  n=n, first=start + h * n,
                                  u0=u * j // n, u1=u * (j + 1) // n))
        start += n * Hkv
    return items


def unit_tile(x: int, ring_units: int, n_ring_tiles: int) -> int:
    """The tile of a slot's unit x: ring units are the first ring tiles,
    the rest the chunk's tiles (after the ``n_ring_tiles`` ring tiles)."""
    return x if x < ring_units else n_ring_tiles + (x - ring_units)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("flash_attention")
        vp, ci, cf, cs = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_size_t)
        lib.flash_attention_workspace.argtypes = [ci] * 6 + [
            ctypes.POINTER(cs)]
        lib.flash_attention_workspace.restype = cs
        ws = [vp, cs, vp, cs]           # partials, their count, tickets, ...
        lib.flash_attention.argtypes = [vp] * 7 + ws + [ci] * 7 + [cf, vp]
        lib.flash_attention_bwd.argtypes = ([vp] * 12 + ws + [ci] * 7
                                            + [cf, vp])
        lib.flash_attention_bwd_workspace.argtypes = [ci] * 6 + [
            ctypes.POINTER(cs)]
        lib.flash_attention_bwd_workspace.restype = cs
        lib.flash_attention_bwd.restype = ci
        lib.flash_attention.restype = ci
        lib.paged_flash_attention.argtypes = ([vp] * 8 + ws + [ci] * 8
                                              + [cf, vp])
        lib.paged_flash_attention.restype = ci
        lib.ring_flash_attention.argtypes = ([vp] * 9 + ws + [ci] * 7
                                             + [cf, vp])
        lib.ring_flash_attention.restype = ci
        _LIB = lib
    return _LIB


# (B, T, Hq, Hkv, S, D[, "bwd"]) -> (f32 partials, int tickets) the call
# needs
_NEEDS: Dict[tuple, Tuple[int, int]] = {}
# the split workspace of both forward entry points and of the backward
# (their calls run in order on one stream: ``kernels.workspace``)
WORKSPACES = workspace.Workspaces("flash_attention")


def _need_of(shape: tuple, bwd: bool = False) -> Tuple[int, int]:
    key = shape + (("bwd",) if bwd else ())
    need = _NEEDS.get(key)
    if need is None:
        tickets = ctypes.c_size_t(0)
        query = (_lib().flash_attention_bwd_workspace if bwd
                 else _lib().flash_attention_workspace)
        partials = query(*shape, ctypes.byref(tickets))
        need = _NEEDS[key] = (partials, tickets.value)
    return need


def reserve_workspace(device: torch.device, shapes) -> None:
    """Size ``device``'s split-KV workspace for the most that a call of any
    (B, T, Hq, Hkv, S, D) in ``shapes`` needs (S: nb * page for the paged
    entry point), before a CUDA graph captures calls
    (``kernels.workspace``)."""
    most = (0, 0)
    for shape in shapes:
        p, t = _need_of(tuple(shape))
        most = (max(most[0], p), max(most[1], t))
    WORKSPACES.reserve(device.index, most)


def _need(t: torch.Tensor, name: str, dtype, device, ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"flash attention needs a contiguous {name}")
    if t.data_ptr() % 16:
        raise ValueError(f"flash attention needs a 16-byte aligned {name}")


def _flags(window, softcap):
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    return (0 if window is None else int(window),
            0.0 if softcap is None else float(softcap))


def _check_heads(q, Hkv):
    B, T, Hq, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads over {Hkv} kv heads")


def flash_attention(q, k, v, q_pos, kv_pos, *, window=None,
                    softcap=None) -> torch.Tensor:
    """q (B, T, Hq, D); k/v (B, S, Hkv, D); q_pos (B, T); kv_pos (B, S).
    q, k or v that need a gradient go through ``FlashAttentionFn``."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, q_pos, kv_pos, window,
                                      softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, kv_pos, window=window,
                                     softcap=softcap)
    return _launch(q, k, v, q_pos, kv_pos, window, softcap, with_lse=False)


def _check_contiguous_args(q, k, v, q_pos, kv_pos):
    """Shapes, dtypes and layout of the contiguous entry points' inputs;
    returns (B, T, Hq, S, Hkv, D)."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    _need(q, "q", torch.float32, q.device, 4)
    for name, t in (("k", k), ("v", v)):
        _need(t, name, torch.float32, q.device, 4)
        if tuple(t.shape) != (B, S, Hkv, D):
            raise ValueError(f"{name} {tuple(t.shape)} != {(B, S, Hkv, D)}")
    _need(q_pos, "q_pos", torch.int32, q.device, 2)
    _need(kv_pos, "kv_pos", torch.int32, q.device, 2)
    if tuple(q_pos.shape) != (B, T) or tuple(kv_pos.shape) != (B, S):
        raise ValueError("positions must be (B, T) and (B, S)")
    _check_heads(q, Hkv)
    return B, T, Hq, S, Hkv, D


def _launch(q, k, v, q_pos, kv_pos, window, softcap, *, with_lse: bool):
    """The forward kernel on CUDA tensors (no autograd): out, and with
    ``with_lse`` (out, lse (B, Hq, T))."""
    B, T, Hq, S, Hkv, D = _check_contiguous_args(q, k, v, q_pos, kv_pos)
    w, c = _flags(window, softcap)
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, T), device=q.device, dtype=torch.float32)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    dev = q.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ws = WORKSPACES.pointers(_need_of((B, T, Hq, Hkv, S, D)), dev)
    rc = kernels.call_on(
        _lib().flash_attention, dev, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, *ws, B, T, Hq, S, Hkv, D, w, c,
        stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    kernels.LAUNCHES["flash_attention"] += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd(q, k, v, q_pos, kv_pos, out, lse, dout, *,
                        window=None, softcap=None):
    """(dq, dk, dv) of ``flash_attention`` from its inputs, its ``out`` and
    ``lse`` (B, Hq, T) and ``dout`` (B, T, Hq, D): the three backward
    kernels of ``csrc/flash_attention.cu`` on CUDA tensors (3xTF32 tensor
    cores; long causal tiles split over blocks through the shared
    workspace; one count of ``flash_attention_bwd`` per call),
    ``flash_attention_bwd_plain`` on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, q_pos, kv_pos, out, lse,
                                         dout, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    if q.shape[-1] not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention_bwd takes head_dim in {BWD_HEAD_DIMS}, got "
            f"{q.shape[-1]}: the backward kernels at head_dim 128 and 256 "
            f"wait for ROADMAP Queue 1 item 25")
    B, T, Hq, S, Hkv, D = _check_contiguous_args(q, k, v, q_pos, kv_pos)
    for name, t in (("out", out), ("dout", dout)):
        _need(t, name, torch.float32, q.device, 4)
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != q {tuple(q.shape)}")
    _need(lse, "lse", torch.float32, q.device, 3)
    if tuple(lse.shape) != (B, Hq, T):
        raise ValueError(f"lse {tuple(lse.shape)} != {(B, Hq, T)}")
    w, c = _flags(window, softcap)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, Hq, T), device=q.device, dtype=torch.float32)
    dev = q.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ws = WORKSPACES.pointers(_need_of((B, T, Hq, Hkv, S, D), bwd=True), dev)
    rc = kernels.call_on(
        _lib().flash_attention_bwd, dev, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *ws, B, T, Hq, S, Hkv, D, w, c, stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_bwd launch failed: CUDA error {rc}")
    kernels.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a backward: the forward kernel also writes
    ``lse``; the backward runs ``flash_attention_bwd`` on the saved
    (q, k, v, q_pos, kv_pos, out, lse). Plain versions on CPU tensors.
    Positions get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, window, softcap):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, q_pos, kv_pos,
                                             window=window, softcap=softcap,
                                             with_lse=True)
        else:
            out, lse = _launch(q, k, v, q_pos, kv_pos, window, softcap,
                               with_lse=True)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.flags = (window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        window, softcap = ctx.flags
        dq, dk, dv = flash_attention_bwd(q, k, v, q_pos, kv_pos, out, lse,
                                         dout.contiguous(), window=window,
                                         softcap=softcap)
        return dq, dk, dv, None, None, None, None


def paged_flash_attention(q, kp, vp, positions, block_table, lens,
                          chunk_lens, *, page_size, window=None,
                          softcap=None) -> torch.Tensor:
    """q (B, T, Hq, D) attends to one layer's pool kp/vp (P, Hkv, page, D)
    through ``block_table`` (B, nb); key s of row b is visible iff its
    block-table entry is >= 0, s < lens[b] + chunk_lens[b] and
    s <= positions[b, t]."""
    if q.device.type == "cpu":
        return paged_flash_attention_plain(
            q, kp, vp, positions, block_table, lens, chunk_lens,
            page_size=page_size, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_attention: no kernel for {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, kp, vp)):
        raise NotImplementedError(
            "paged_flash_attention has no backward (training never pages): "
            "run the step under torch.no_grad(), or train through "
            "flash_attention")
    B, T, Hq, D = q.shape
    _, Hkv, page, _ = kp.shape
    nb = block_table.shape[1]
    _need(q, "q", torch.float32, q.device, 4)
    for name, t in (("kp", kp), ("vp", vp)):
        _need(t, name, torch.float32, q.device, 4)
        if tuple(t.shape) != tuple(kp.shape) or t.shape[3] != D:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q")
    if page != page_size:
        raise ValueError(f"pool page {page} != page_size {page_size}")
    _need(positions, "positions", torch.int32, q.device, 2)
    _need(block_table, "block_table", torch.int32, q.device, 2)
    _need(lens, "lens", torch.int32, q.device, 1)
    _need(chunk_lens, "chunk_lens", torch.int32, q.device, 1)
    if (tuple(positions.shape) != (B, T) or block_table.shape[0] != B
            or lens.shape[0] != B or chunk_lens.shape[0] != B or nb == 0):
        raise ValueError("positions (B, T), block_table (B, nb>0), lens (B,) "
                         "and chunk_lens (B,) must match q")
    _check_heads(q, Hkv)
    w, c = _flags(window, softcap)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    dev = q.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ws = WORKSPACES.pointers(_need_of((B, T, Hq, Hkv, nb * page, D)), dev)
    rc = kernels.call_on(
        _lib().paged_flash_attention, dev, q.data_ptr(), kp.data_ptr(),
        vp.data_ptr(), positions.data_ptr(), block_table.data_ptr(),
        lens.data_ptr(), chunk_lens.data_ptr(), out.data_ptr(), *ws, B, T,
        Hq, Hkv, D, nb, page, w, c, stream)
    if rc != 0:
        raise RuntimeError(
            f"paged_flash_attention launch failed: CUDA error {rc}")
    kernels.LAUNCHES["paged_flash_attention"] += 1
    return out


def ring_flash_attention(q, k_ring, v_ring, k_chunk, v_chunk, positions,
                         lens, chunk_lens, *, window=None,
                         softcap=None) -> torch.Tensor:
    """q (B, T, Hq, D) attends to [one sliding layer's ring k_ring/v_ring
    (B, Hkv, W, D) ; the chunk's own k_chunk/v_chunk (B, T, Hkv, D)] with
    the keys' positions of ``ring_kv_pos``: the ring entry point of
    ``csrc/flash_attention.cu`` on CUDA tensors, which reads both in one
    launch with no concatenation, ``ring_flash_attention_plain`` on CPU
    tensors. The ring is read as it stands: the caller writes the chunk
    back after this call."""
    if q.device.type == "cpu":
        return ring_flash_attention_plain(
            q, k_ring, v_ring, k_chunk, v_chunk, positions, lens, chunk_lens,
            window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"ring_flash_attention: no kernel for {q.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_ring, v_ring, k_chunk, v_chunk)):
        raise NotImplementedError(
            "ring_flash_attention has no backward (training never reads a "
            "ring): run the step under torch.no_grad(), or train through "
            "flash_attention")
    B, T, Hq, D = q.shape
    _, Hkv, W, _ = k_ring.shape
    _need(q, "q", torch.float32, q.device, 4)
    for name, t, shape in (("k_ring", k_ring, (B, Hkv, W, D)),
                           ("v_ring", v_ring, (B, Hkv, W, D)),
                           ("k_chunk", k_chunk, (B, T, Hkv, D)),
                           ("v_chunk", v_chunk, (B, T, Hkv, D))):
        _need(t, name, torch.float32, q.device, 4)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
    _need(positions, "positions", torch.int32, q.device, 2)
    _need(lens, "lens", torch.int32, q.device, 1)
    _need(chunk_lens, "chunk_lens", torch.int32, q.device, 1)
    if (tuple(positions.shape) != (B, T) or lens.shape[0] != B
            or chunk_lens.shape[0] != B or W == 0):
        raise ValueError("positions (B, T), lens (B,), chunk_lens (B,) and a "
                         "ring of W > 0 slots must match q")
    _check_heads(q, Hkv)
    w, c = _flags(window, softcap)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    dev = q.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ws = WORKSPACES.pointers(_need_of((B, T, Hq, Hkv, W + T, D)), dev)
    rc = kernels.call_on(
        _lib().ring_flash_attention, dev, q.data_ptr(), k_ring.data_ptr(),
        v_ring.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
        positions.data_ptr(), lens.data_ptr(), chunk_lens.data_ptr(),
        out.data_ptr(), *ws, B, T, Hq, Hkv, D, W, w, c, stream)
    if rc != 0:
        raise RuntimeError(
            f"ring_flash_attention launch failed: CUDA error {rc}")
    kernels.LAUNCHES["ring_flash_attention"] += 1
    return out
