"""Routing, layout and dispatch, and the combine, of a mixture-of-experts
layer under dropless dispatch: the CUDA kernels' wrappers and their plain
versions.

``moe_route(logits, token_mask, x, ...)`` takes the router's f32 logits
(n, E) of n tokens and returns a ``Route``: each token's top-k experts
and gates (renormalised with ``norm_topk``), the routing margin, the aux
losses, and the compact buffer of the kept (token, slot) assignments that
``grouped_crossbar_matmul`` takes (each expert over ``tpe`` consecutive
slots; an assignment's row is its slot's base, the slots' counts padded to
``tile`` rows, plus its rank in the slot over the whole batch in (token,
k, slot) order, pads claiming none: the JAX package's cumsum rank).
``moe_combine(out, rows, weights, shared)`` sums each token's kept
assignments' rows of the experts' output, weighted by their gates, and
adds the shared expert's output.

On CUDA tensors they launch ``csrc/moe_route.cu`` (counted as
``moe_route`` and ``moe_combine`` in ``kernels.LAUNCHES``); on CPU tensors
they run ``moe_route_plain`` and ``moe_combine_plain``, the torch ops that
``models.moe.apply_moe`` ran before the kernels existed. Dropless only:
capacity dispatch (training, the capacity baseline) keeps its torch ops in
``apply_moe`` (ROADMAP Queue 1 item 26). Neither kernel has a backward: a
CUDA input that needs a gradient raises.

Above ``ROUTE_ALL_MAX`` tokens the route kernel deals the tokens out in
items of ``ROUTE_CHUNK`` and scans the items' slot counts on the card
through a workspace (``kernels.workspace``; ``reserve_workspace`` sizes it
before a CUDA graph captures a call). ``route_partition`` is that layout in
torch ops, for the tests.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels import build, workspace

MAX_SLOTS = 128     # csrc/moe_route.cu kMaxSlots: experts x tpe
MAX_TOP_K = 8       # kMaxTopK
MAX_ASSIGN = 16     # kMaxAssign: top_k x tpe
ROUTE_CHUNK = 32    # kChunk: tokens of a routing item
ROUTE_ALL_MAX = 32  # kRouteAllMax: up to this every block routes them all
_LIB = None
# the route kernel's item counts, offsets and tickets, one per device
WORKSPACES = workspace.Workspaces("moe_route")
_NEEDS: Dict[Tuple[int, int, int, int], Tuple[int, int]] = {}


class Route(NamedTuple):
    """``moe_route``'s outputs, for n tokens, A = n * top_k * tpe
    assignments and R buffer rows."""
    experts: torch.Tensor   # (n, k) int64: the top-k experts
    gate: torch.Tensor      # (n, k) f32: their gates
    margin: torch.Tensor    # (n,) f32: k-th minus (k+1)-th probability
    aux: torch.Tensor       # (3,) f32: lb_loss, router_z, dropped (0)
    rows: torch.Tensor      # (A,) int64: each assignment's row (0: not kept)
    weights: torch.Tensor   # (A,) f32: its gate where kept, else 0
    bases: torch.Tensor     # (slots + 1,) int32
    counts: torch.Tensor    # (slots,) int32
    xbuf: torch.Tensor      # (R, d): the kept assignments' x rows


def expert_layout(sidx: torch.Tensor, kept: torch.Tensor, slots: int,
                  tile: int):
    """The compact buffer of the kept assignments: (rows (A,) int64, each
    assignment's buffer row (0 where not kept), bases (slots + 1,) int32,
    counts (slots,) int32). ``sidx``/``kept``: (A,) slot ids and whether
    each assignment is placed, in the order that ranks them."""
    oh = (torch.nn.functional.one_hot(sidx.long(), slots).to(torch.int32)
          * kept.to(torch.int32)[:, None])                     # (A, slots)
    counts = oh.sum(0, dtype=torch.int32)
    rank = ((torch.cumsum(oh, 0) - oh) * oh).sum(-1)
    padded = (counts + (tile - 1)) // tile * tile
    bases = torch.cat([torch.zeros(1, dtype=torch.int32, device=sidx.device),
                       torch.cumsum(padded, 0).to(torch.int32)])
    rows = torch.where(kept, bases.long()[sidx.long()] + rank,
                       torch.zeros_like(rank)).long()
    return rows, bases, counts


def route_partition(sidx: torch.Tensor, kept: torch.Tensor, slots: int,
                    tile: int, chunk: int = ROUTE_CHUNK) -> dict:
    """The route kernel's layout of n tokens' assignments, step by step in
    torch ops (the tests hold it against the JAX package's cumsum rank).
    ``sidx``/``kept`` (n, K): each assignment's slot and whether it is
    placed. Item c takes tokens c * chunk .. (c + 1) * chunk - 1; each
    kept assignment sets its token's bit in its slot's mask of the item
    (a token takes a slot at most once); the item's count in a slot is
    the mask's popcount and an assignment's rank in the item the popcount
    of the bits before its own; an exclusive scan of the counts over the
    items gives each item's offset in each slot, their sum the slots'
    counts, and a scan of the counts padded to ``tile`` the bases. Returns
    "items" (each item's first and last token + 1), "item_counts" and
    "offsets" (items, slots), "counts" (slots,), "bases" (slots + 1,) and
    "rows" (n * K,): base + offset + rank where kept, else 0."""
    n, K = sidx.shape
    items = [(c, min(c + chunk, n)) for c in range(0, n, chunk)]
    masks = torch.zeros((len(items), slots), dtype=torch.int64)
    for c, (t0, t1) in enumerate(items):
        for t in range(t0, t1):
            for q in range(K):
                if kept[t, q]:
                    masks[c, int(sidx[t, q])] |= 1 << (t - t0)
    popc = torch.tensor([[bin(int(m)).count("1") for m in row]
                         for row in masks], dtype=torch.int64)
    offsets = torch.cumsum(popc, 0) - popc
    counts = popc.sum(0)
    bases = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(
        (counts + tile - 1) // tile * tile, 0)])
    rows = torch.zeros((n, K), dtype=torch.int64)
    for c, (t0, t1) in enumerate(items):
        for t in range(t0, t1):
            for q in range(K):
                if kept[t, q]:
                    s = int(sidx[t, q])
                    rank = bin(int(masks[c, s]) & ((1 << (t - t0)) - 1)).count(
                        "1")
                    rows[t, q] = bases[s] + offsets[c, s] + rank
    return {"items": items, "item_counts": popc, "offsets": offsets,
            "counts": counts.to(torch.int32), "bases": bases.to(torch.int32),
            "rows": rows.reshape(n * K)}


def topk_route(logits: torch.Tensor, token_mask: Optional[torch.Tensor], *,
               top_k: int, tpe: int, norm_topk: bool):
    """The routing of n tokens in f32 torch ops (``moe_route_plain``'s, and
    capacity dispatch's in ``models.moe``): softmax, top-k (ties to the
    lower expert), the margin,
    renormalisation, the Switch load-balance loss and the router z-loss
    over all n tokens (pads too, as the JAX package's). Returns (experts
    (n, k), gate (n, k), margin (n,), aux (3,): lb_loss, router_z, 0, slot
    ids (n, K), gate times mask (n, K)), K = top_k * tpe."""
    n, E = logits.shape
    k = top_k
    probs = torch.softmax(logits, dim=-1)                     # (n, E)
    # ties to the lower expert, as jax.lax.top_k's (torch.topk's order
    # among equal values is unspecified)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top = top[:, :min(k + 1, E)]
    gate, eidx = top[:, :k].contiguous(), order[:, :k].contiguous()
    margin = (top[:, k - 1] - top[:, k] if E > k
              else torch.full_like(top[:, 0], float("inf")))
    if norm_topk:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    me = torch.nn.functional.one_hot(eidx[:, 0], E).to(torch.float32).mean(0)
    ce = probs.mean(0)
    aux = torch.stack([E * torch.sum(me * ce),
                       torch.mean(torch.logsumexp(logits, -1) ** 2),
                       torch.zeros((), dtype=torch.float32,
                                   device=logits.device)])
    sidx = (eidx[..., None] * tpe
            + torch.arange(tpe, device=logits.device)).reshape(n, k * tpe)
    sgate = gate.repeat_interleave(tpe, dim=-1)               # (n, K)
    if token_mask is not None:              # pads claim no rank/capacity
        sgate = sgate * token_mask.reshape(n).to(sgate.dtype)[:, None]
    return eidx, gate, margin, aux, sidx, sgate


def moe_route_plain(logits: torch.Tensor, token_mask: Optional[torch.Tensor],
                    x: torch.Tensor, *, top_k: int, tpe: int, norm_topk: bool,
                    tile: int, R: int) -> Route:
    """``topk_route``, then ``expert_layout`` of the assignments whose gate
    times mask is > 0, and x scattered into a zeroed buffer."""
    n, E = logits.shape
    d = x.shape[-1]
    A = n * top_k * tpe
    eidx, gate, margin, aux, sidx, sgate = topk_route(
        logits, token_mask, top_k=top_k, tpe=tpe, norm_topk=norm_topk)
    kept = (sgate > 0).reshape(A)
    rows, bases, counts = expert_layout(sidx.reshape(A), kept, E * tpe, tile)
    # a row that is not kept writes the spare row R, which nothing reads
    xbuf = x.new_zeros((R + 1, d))
    xbuf[torch.where(kept, rows, R)] = (
        x.reshape(n, 1, d).expand(n, A // n, d).reshape(A, d))
    weights = torch.where(kept, sgate.reshape(A),
                          torch.zeros_like(sgate.reshape(A)))
    return Route(eidx, gate, margin, aux, rows, weights, bases, counts,
                 xbuf[:R])


def moe_combine_plain(out: torch.Tensor, rows: torch.Tensor,
                      weights: torch.Tensor,
                      shared: Optional[torch.Tensor]) -> torch.Tensor:
    """y (n, d): each token's kept assignments' rows of ``out`` (R, d)
    gathered (the others selected away, never multiplied), times their
    weights, summed over the token's K assignments; plus ``shared`` (n, d)
    where given. ``rows``/``weights`` (n, K): kept where weight > 0."""
    n, K = rows.shape
    keep = (weights > 0).reshape(n * K)
    sel = torch.where(keep[:, None], out[rows.reshape(n * K)],
                      torch.zeros_like(out[:1]))
    w = weights.to(out.dtype)
    y = torch.sum(sel.reshape(n, K, -1) * w[..., None], dim=1)
    if shared is not None:
        y = y + shared
    return y


ROUTE_TOL = 1e-6      # gates, weights, aux and y: relative, f32 sums
TIE_MARGIN = 1e-5     # expert ids are held where the margin is at least this


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (0 for empty tensors)."""
    if not want.numel():
        return 0.0
    err = float((got.double() - want.double()).abs().max())
    return err / max(float(want.double().abs().max()), 1e-30)


def compare_routes(got: Route, want: Route) -> dict:
    """``got`` (the kernel's) against ``want`` (the plain version's) on
    the same inputs: expert ids equal wherever ``want``'s margin is at
    least ``TIE_MARGIN``; where every id is equal, the rows, bases, counts
    and every kept assignment's buffer row bit-equal (the kernel writes no
    other row); gates, weights and aux within ``ROUTE_TOL`` relative.
    Returns the findings and "ok"."""
    dev = want.experts.device
    got = Route(*(t.to(dev) for t in got))
    near = want.margin < TIE_MARGIN
    ids_ok = bool(((got.experts == want.experts) | near[:, None]).all())
    same_ids = bool(torch.equal(got.experts, want.experts))
    out = {"ids_ok": ids_ok, "same_ids": same_ids,
           "near_ties": int(near.sum()),
           "gate_rel": _rel(got.gate, want.gate),
           "weights_rel": _rel(got.weights, want.weights),
           "aux_rel": max(_rel(got.aux[i:i + 1], want.aux[i:i + 1])
                          for i in range(3))}
    layout = None
    if same_ids:
        kept = want.weights > 0
        rk = want.rows[kept]
        layout = (torch.equal(got.rows, want.rows)
                  and torch.equal(got.bases, want.bases)
                  and torch.equal(got.counts, want.counts)
                  and torch.equal(got.xbuf[rk], want.xbuf[rk]))
    out["layout_equal"] = layout
    out["ok"] = (ids_ok and layout is not False
                 and max(out["gate_rel"], out["weights_rel"],
                         out["aux_rel"]) <= ROUTE_TOL)
    return out


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("moe_route")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.moe_route.argtypes = ([vp] * 13 + [ctypes.c_size_t, vp]
                                  + [ci] * 8 + [vp])
        lib.moe_route.restype = ci
        lib.moe_route_workspace.argtypes = [ci] * 4 + [ctypes.POINTER(ci)]
        lib.moe_route_workspace.restype = ctypes.c_size_t
        lib.moe_combine.argtypes = [vp] * 5 + [ci] * 3 + [vp]
        lib.moe_combine.restype = ci
        lib.moe_route_grid.argtypes = [ci, ci]
        lib.moe_route_grid.restype = ci
        _LIB = lib
    return _LIB


def _need(n: int, E: int, top_k: int, tpe: int) -> Tuple[int, int]:
    """(f32 partials, int32 tickets) of the route kernel's workspace for n
    tokens (none up to ``ROUTE_ALL_MAX``)."""
    key = (n, E, top_k, tpe)
    need = _NEEDS.get(key)
    if need is None:
        tickets = ctypes.c_int(0)
        partials = _lib().moe_route_workspace(n, E, top_k, tpe,
                                              ctypes.byref(tickets))
        need = _NEEDS[key] = (int(partials), tickets.value)
    return need


def reserve_workspace(device: torch.device, tokens, E: int, top_k: int,
                      tpe: int) -> None:
    """Size ``device``'s route workspace for a call over each number of
    tokens in ``tokens`` (E experts, top_k, tpe slots an expert), before a
    CUDA graph captures calls (``kernels.workspace``)."""
    most = (0, 0)
    for n in tokens:
        p, t = _need(n, E, top_k, tpe)
        most = (max(most[0], p), max(most[1], t))
    WORKSPACES.reserve(device.index, most)


def _check_cuda(name: str, dev: torch.device, **tensors) -> None:
    """Each given tensor on ``dev``, contiguous, of the dtype its name
    asks for (every float f32, the mask bool, rows int64)."""
    for arg, t in tensors.items():
        want = {"token_mask": torch.bool, "rows": torch.int64}.get(
            arg, torch.float32)
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, expected {dev}")
        if t.dtype != want:
            raise TypeError(f"{name} takes {want} {arg}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs a contiguous {arg}")


def _no_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel (ROADMAP Queue 1 item 26: MoE "
            f"training)")


def moe_route(logits: torch.Tensor, token_mask: Optional[torch.Tensor],
              x: torch.Tensor, *, top_k: int, tpe: int, norm_topk: bool,
              tile: int, R: int) -> Route:
    """logits (n, E) f32, token_mask (n,) bool or None, x (n, d) -> a
    ``Route`` whose buffer has R rows (``grouped_rows`` of n * top_k * tpe
    assignments over E * tpe slots at ``tile``). On CUDA tensors the
    kernel writes only the buffer rows of kept assignments; the plain
    version zeroes the rest."""
    n, E = logits.shape
    if x.ndim != 2 or x.shape[0] != n:
        raise ValueError(f"x {tuple(x.shape)} for {n} tokens: x must be "
                         f"(n, d)")
    if token_mask is not None and tuple(token_mask.shape) != (n,):
        raise ValueError(f"token_mask {tuple(token_mask.shape)} for {n} "
                         f"tokens")
    args = [t for t in (logits, token_mask, x) if t is not None]
    if all(t.device.type == "cpu" for t in args):
        return moe_route_plain(logits, token_mask, x, top_k=top_k, tpe=tpe,
                               norm_topk=norm_topk, tile=tile, R=R)
    if not logits.is_cuda:
        raise ValueError(f"moe_route: logits on {logits.device}")
    _no_grad("moe_route", logits, x)
    dev = logits.device
    _check_cuda("moe_route", dev, logits=logits, x=x,
                **({} if token_mask is None else {"token_mask": token_mask}))
    slots, K = E * tpe, top_k * tpe
    if (not 0 < top_k <= min(E, MAX_TOP_K) or tpe < 1 or slots > MAX_SLOTS
            or K > MAX_ASSIGN or tile < 1 or n < 1):
        raise ValueError(f"moe_route kernel takes 1 <= top_k <= min(E, "
                         f"{MAX_TOP_K}), E * tpe <= {MAX_SLOTS} and top_k * "
                         f"tpe <= {MAX_ASSIGN}; got n={n}, E={E}, "
                         f"top_k={top_k}, tpe={tpe}, tile={tile}")
    d = x.shape[1]
    f32, i64 = dict(dtype=torch.float32, device=dev), dict(
        dtype=torch.int64, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    r = Route(torch.empty((n, top_k), **i64), torch.empty((n, top_k), **f32),
              torch.empty((n,), **f32), torch.empty((3,), **f32),
              torch.empty((n * K,), **i64), torch.empty((n * K,), **f32),
              torch.empty((slots + 1,), **i32), torch.empty((slots,), **i32),
              torch.empty((R, d), **f32))
    idx = dev.index
    ws = WORKSPACES.pointers(_need(n, E, top_k, tpe), idx)
    rc = kernels.call_on(
        _lib().moe_route, idx, logits.data_ptr(),
        None if token_mask is None else token_mask.data_ptr(), x.data_ptr(),
        *(t.data_ptr() for t in r), *ws, n, E, top_k, tpe,
        int(bool(norm_topk)), tile, d, torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"moe_route launch failed: CUDA error {rc} (n={n}"
                           f", E={E}, top_k={top_k}, tpe={tpe}, d={d})")
    kernels.LAUNCHES["moe_route"] += 1
    return r


def moe_combine(out: torch.Tensor, rows: torch.Tensor, weights: torch.Tensor,
                shared: Optional[torch.Tensor]) -> torch.Tensor:
    """out (R, d), rows (n, K) int64, weights (n, K), shared (n, d) or
    None -> y (n, d) (see ``moe_combine_plain``)."""
    n, K = rows.shape
    if tuple(weights.shape) != (n, K) or out.ndim != 2 or (
            shared is not None and tuple(shared.shape) != (n, out.shape[1])):
        raise ValueError(f"moe_combine: out {tuple(out.shape)}, rows "
                         f"{tuple(rows.shape)}, weights "
                         f"{tuple(weights.shape)}, shared "
                         f"{None if shared is None else tuple(shared.shape)}")
    args = [t for t in (out, rows, weights, shared) if t is not None]
    if all(t.device.type == "cpu" for t in args):
        return moe_combine_plain(out, rows, weights, shared)
    if not out.is_cuda:
        raise ValueError(f"moe_combine: out on {out.device}")
    _no_grad("moe_combine", out, weights, shared)
    dev = out.device
    _check_cuda("moe_combine", dev, out=out, rows=rows, weights=weights,
                **({} if shared is None else {"shared": shared}))
    d = out.shape[1]
    y = torch.empty((n, d), dtype=torch.float32, device=dev)
    idx = dev.index
    rc = kernels.call_on(
        _lib().moe_combine, idx, out.data_ptr(), rows.data_ptr(),
        weights.data_ptr(), None if shared is None else shared.data_ptr(),
        y.data_ptr(), n, K, d, torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"moe_combine launch failed: CUDA error {rc} "
                           f"(n={n}, K={K}, d={d})")
    kernels.LAUNCHES["moe_combine"] += 1
    return y
