"""Mixture-of-Experts FF with the unified expert-parallel "slot" layout
(PyTorch port of ``repro.models.moe``).

Experts are laid out over ``n_slots = max(n_experts, moe_parallel)``
slots: with more slots than experts (``tpe = slots / E`` > 1) each expert's
FF dim is split across ``tpe`` consecutive slots, a routed token goes to
all of them, and the ``w2`` halves sum in the combine. ``slots`` is read
from the weights (``live_slots``), never from the config.

Routing is the JAX package's, in f32 with the frozen, unquantized router:
softmax, top-k, optional renormalisation of the k gates, the Switch
load-balance loss and the router z-loss. ``token_mask`` (B, T) keeps pads
out of every rank and every capacity bucket. Two dispatch modes:

  * ``"capacity"`` (training default): each group's tokens ranked past the
    capacity ``C = _capacity(...)`` in a slot are dropped (the residual
    passes through), counted in ``aux["dropped_tokens"]``;
  * ``"dropless"`` (forced by the serving engines): no token drops.

The buffer is the port's own and not the JAX package's (C rows per slot:
``C = T`` under dropless, which at a mixed serving tick holds 16 times the
routed rows of llama4-scout): the kept (token, slot) assignments lie
compactly in one buffer, grouped by slot. An assignment's row is its
slot's base (the exclusive prefix sum of the slots' counts, each padded to
the grouped kernel's row tile) plus its rank in the slot over the whole
batch (the JAX package's cumsum rank, with a compact base in place of
``slot * C``). The buffer holds at most ``B * T * k * tpe`` rows plus one
tile of padding for each slot that holds any; its size depends only on
the shapes, so a CUDA graph captures the layer whatever the routing, and
nothing reads a count on the host. The expert products run on
``hetero.static_grouped_matmul`` (the ``grouped_crossbar_matmul`` kernel
on a quantized stack), which writes 0 in every row it does not own; the
combine gathers each kept assignment's row back and selects (never
multiplies) away the rest. Both modes share the buffer: capacity mode only
keeps fewer assignments.

The FLOP tally counts what the JAX package's einsums count (its one-hot
dispatch and combine in capacity mode, its ``C``-row expert products), so
the two tallies agree; the port computes fewer products than that.
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hetero, quant
from repro_torch.core.noise import NoiseConfig
from repro_torch.kernels.crossbar_matmul import ops as cb_ops
from repro_torch.models import layers

# When a list, every ``apply_moe`` appends its routing to it: a dict of
# "experts" (B, T, k) (the top-k expert ids) and "margin" (B, T) (the k-th
# largest router probability minus the (k+1)-th: how near a tie the
# choice was). Inside a CUDA graph's capture the entries are the graph's
# own tensors, which each replay overwrites.
ROUTES: Optional[List[Dict[str, torch.Tensor]]] = None


def slot_layout(cfg: ModelConfig, moe_parallel: int) -> Tuple[int, int]:
    E = cfg.moe.n_experts
    slots = max(E, moe_parallel)
    assert slots % E == 0, (slots, E)
    tpe = slots // E
    assert cfg.d_ff % tpe == 0
    return slots, tpe


def init_moe(cfg: ModelConfig, generator: torch.Generator, *, device, dtype,
             lead=(), moe_parallel: int = 1) -> Dict:
    """``router`` (d, E) f32, ``w1`` (slots, d, ff / tpe), ``w2`` (slots,
    ff / tpe, d), ``w3`` for a gated MLP, ``shared`` (the always-on expert:
    an MLP), drawn from ``generator`` in that order."""
    d, ff = cfg.d_model, cfg.d_ff
    slots, tpe = slot_layout(cfg, moe_parallel)
    ffp = ff // tpe
    kw = dict(device=device, dtype=dtype)
    p = {"router": layers.dense_init(generator, (*lead, d, cfg.moe.n_experts),
                                     device=device, dtype=torch.float32),
         "w1": layers.dense_init(generator, (*lead, slots, d, ffp), **kw),
         "w2": layers.dense_init(generator, (*lead, slots, ffp, d),
                                 fan_in=ff, **kw)}
    if cfg.mlp.startswith("gated"):
        p["w3"] = layers.dense_init(generator, (*lead, slots, d, ffp), **kw)
    if cfg.moe.shared_expert:
        p["shared"] = layers.init_mlp(cfg, generator, lead=lead, **kw)
    return p


def live_slots(w) -> int:
    """Leading (slots) dim of one layer's expert weight."""
    return w.codes.shape[0] if quant.is_quantized(w) else w.shape[0]


def _capacity(cfg: ModelConfig, tokens_per_group: int, k_slots: int,
              slots: int, capacity_factor: Optional[float]) -> int:
    """The exact ceil of tokens * k_slots * cf / slots (``Fraction(cf)`` is
    the float's exact value), at least 1."""
    cf = (capacity_factor if capacity_factor is not None
          else cfg.moe.capacity_factor)
    q = Fraction(tokens_per_group * k_slots) * Fraction(cf) / slots
    return max(1, math.ceil(q))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(idx.long(), n).to(torch.int32)


def expert_layout(sidx: torch.Tensor, kept: torch.Tensor, slots: int,
                  tile: int):
    """The compact buffer of the kept assignments: (rows (A,) int64, each
    assignment's buffer row (0 where not kept), bases (slots + 1,) int32,
    counts (slots,) int32). ``sidx``/``kept``: (A,) slot ids and whether
    each assignment is placed, in the order that ranks them."""
    oh = _one_hot(sidx, slots) * kept.to(torch.int32)[:, None]   # (A, slots)
    counts = oh.sum(0, dtype=torch.int32)
    rank = ((torch.cumsum(oh, 0) - oh) * oh).sum(-1)
    padded = (counts + (tile - 1)) // tile * tile
    bases = torch.cat([torch.zeros(1, dtype=torch.int32, device=sidx.device),
                       torch.cumsum(padded, 0).to(torch.int32)])
    rows = torch.where(kept, bases.long()[sidx.long()] + rank,
                       torch.zeros_like(rank)).long()
    return rows, bases, counts


def apply_moe(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
              noise: Optional[NoiseConfig] = None,
              rng: Optional[torch.Generator] = None,
              capacity_factor: Optional[float] = None,
              group_size: Optional[int] = None,
              token_mask: Optional[torch.Tensor] = None,
              dispatch: str = "capacity"
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, T, d) -> (y (B, T, d), aux): ``aux`` holds "lb_loss",
    "router_z" and "dropped_tokens" ((token, expert) assignments dropped by
    capacity; 0 under dropless). ``group_size``: tokens are routed (and
    capacity bucketed) in groups of that many positions when it divides T.
    ``token_mask`` (B, T): real tokens; pads claim no rank or capacity."""
    if dispatch not in ("capacity", "dropless"):
        raise ValueError(f"unknown MoE dispatch mode {dispatch!r} "
                         "(expected 'capacity' or 'dropless')")
    B0, T0, d = x.shape
    gs = group_size or T0
    if gs < T0 and T0 % gs == 0:
        x = x.reshape(B0 * (T0 // gs), gs, d)
        if token_mask is not None:
            token_mask = token_mask.reshape(B0 * (T0 // gs), gs)
    B, T, d = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    slots = live_slots(p["w1"])
    tpe = slots // E
    K = k * tpe
    dev = x.device

    # ---- routing (f32, frozen router) ----
    logits = hetero.static_matmul(x.to(torch.float32), p["router"])
    probs = torch.softmax(logits, dim=-1)                     # (B, T, E)
    gate, eidx = torch.topk(probs, k, dim=-1)                 # (B, T, k)
    if ROUTES is not None:
        top = torch.topk(probs, min(k + 1, E), dim=-1).values
        margin = (top[..., k - 1] - top[..., k] if E > k
                  else torch.full_like(top[..., 0], float("inf")))
        ROUTES.append({"experts": eidx.reshape(B0, T0, k),
                       "margin": margin.reshape(B0, T0)})
    if cfg.moe.router_norm_topk:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # aux load-balance loss (Switch eq. 4), reported even when frozen
    me = _one_hot(eidx[..., 0], E).to(torch.float32).mean(dim=(0, 1))
    ce = probs.mean(dim=(0, 1))
    aux = {"lb_loss": E * torch.sum(me * ce),
           "router_z": torch.mean(torch.logsumexp(logits, -1) ** 2)}

    # ---- expand experts to slots; rank within (group, slot) ----
    sidx = (eidx[..., None] * tpe
            + torch.arange(tpe, device=dev)).reshape(B, T, K)
    sgate = gate.repeat_interleave(tpe, dim=-1)               # (B, T, K)
    if token_mask is not None:              # pads claim no rank/capacity
        sgate = sgate * token_mask.to(sgate.dtype)[:, :, None]
    routed = sgate > 0
    if dispatch == "dropless":
        C = T
        kept = routed
        aux["dropped_tokens"] = torch.zeros((), dtype=torch.float32,
                                            device=dev)
    else:
        C = _capacity(cfg, T, K, slots, capacity_factor)
        oh = _one_hot(sidx, slots) * routed.to(torch.int32)[..., None]
        pos = torch.cumsum(oh.reshape(B, T * K, slots), dim=1)
        pos = pos.reshape(B, T, K, slots) - oh
        pos_a = (pos * oh).sum(-1)                            # (B, T, K)
        kept = routed & (pos_a < C)
        aux["dropped_tokens"] = ((routed & ~kept).sum(dtype=torch.float32)
                                 / tpe)
        # the JAX package's one-hot dispatch and combine einsums
        # ("btsc,btd->sbcd", "btsc,sbcd->btd"): the port gathers instead
        hetero._record(hetero.DYNAMIC, 2 * 2.0 * B * T * slots * C * d)

    # ---- the compact buffer, grouped by slot ----
    A = B * T * K
    w1 = p["w1"]
    kernel, tile = None, 1                  # dense stacks: no row tile
    if quant.is_quantized(w1):
        kernel = cb_ops.grouped_kernel(A, w1)
        tile = cb_ops.GROUPED_TILE[kernel]
    R = cb_ops.grouped_rows(A, slots, tile)
    keep = kept.reshape(A)
    rows, bases, counts = expert_layout(sidx.reshape(A), keep, slots, tile)
    # a row that is not kept writes the spare row R, which nothing reads
    xbuf = x.new_zeros((R + 1, d))
    xbuf[torch.where(keep, rows, R)] = (
        x[:, :, None, :].expand(B, T, K, d).reshape(A, d))
    xin = xbuf[:R]

    # ---- expert products and the combine ----
    gk = dict(kernel=kernel, jax_rows=B * C, noise=noise, rng=rng)
    h = hetero.static_grouped_matmul(xin, w1, bases, counts, **gk)
    ffp = h.shape[-1]
    hetero.record_nonlinear(slots * B * C * ffp)
    if cfg.mlp.startswith("gated"):
        g = hetero.static_grouped_matmul(xin, p["w3"], bases, counts, **gk)
        h = layers.activation(cfg, h) * g
    else:
        h = layers.activation(cfg, h)
    out = hetero.static_grouped_matmul(h.contiguous(), p["w2"], bases,
                                       counts, **gk)
    sel = torch.where(keep[:, None], out[rows], torch.zeros_like(out[:1]))
    w = torch.where(kept, sgate, torch.zeros_like(sgate)).to(x.dtype)
    y = torch.sum(sel.reshape(B, T, K, d) * w[..., None], dim=2)

    if cfg.moe.shared_expert:
        y = y + layers.apply_mlp(cfg, p["shared"], x, noise=noise, rng=rng)
    y = y.to(x.dtype)
    if (B, T) != (B0, T0):
        y = y.reshape(B0, T0, d)
    return y, aux


# ---------------------------------------------------------------------------
# dense reference (oracle for tests)
# ---------------------------------------------------------------------------


def ref_moe(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Loop-over-experts oracle: exact top-k MoE with no capacity drops
    (a quantized stack is dequantized first)."""
    B, T, d = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    slots = live_slots(p["w1"])
    tpe = slots // E

    def dense(name):
        w = p[name]
        return quant.dequantize(w, x.dtype) if quant.is_quantized(w) else w

    w1s, w2s = dense("w1"), dense("w2")
    w3s = dense("w3") if cfg.mlp.startswith("gated") else None
    logits = torch.matmul(x.to(torch.float32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, k, dim=-1)
    if cfg.moe.router_norm_topk:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    def expert_ff(e, xi):
        # reassemble expert e from its tpe slots
        w1 = torch.cat([w1s[e * tpe + j] for j in range(tpe)], dim=-1)
        h = xi @ w1
        if w3s is not None:
            w3 = torch.cat([w3s[e * tpe + j] for j in range(tpe)], dim=-1)
            h = layers.activation(cfg, h) * (xi @ w3)
        else:
            h = layers.activation(cfg, h)
        w2 = torch.cat([w2s[e * tpe + j] for j in range(tpe)], dim=-2)
        return h @ w2

    y = torch.zeros_like(x)
    for e in range(E):
        fe = expert_ff(e, x)
        w = torch.sum(torch.where(eidx == e, gate, torch.zeros_like(gate)),
                      dim=-1)
        y = y + fe * w[..., None].to(x.dtype)
    if cfg.moe.shared_expert:
        y = y + layers.apply_mlp(cfg, p["shared"], x)
    return y
