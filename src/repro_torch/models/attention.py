"""Attention: the DYNAMIC-engine computation (Atleus MHA-2/MHA-3), PyTorch
port of the full- and sliding-window-attention part of
``repro.models.attention``, with chameleon/llama4-style qk-norm (an f32
RMS norm of each query and key head over head_dim, applied after the
projections and their LoRA deltas and before RoPE, so the cached K is
already normed and roped).

Two implementations of the fused score + softmax + V step:

  * ``ref``  — ``ref_attention``: materialized scores, the JAX package's
               oracle (a row that sees no key gives the mean of V).
  * ``auto`` — the flash wrappers of ``repro_torch.kernels.flash_attention``:
               the hand-written CUDA kernel on CUDA tensors, its plain
               version on CPU tensors (a row that sees no key gives 0).

Training (``mode="train"``) self-attends as prefill does and builds no
cache; on tensors that need a gradient ``auto`` runs the flash wrapper's
autograd Function: its CUDA backward on the card, the plain backward on
the CPU.

Paged decode scatters the chunk's K/V into the layer's page pool in place
(the JAX package returns a new pool and relies on buffer donation) and
attends through the block table: ``auto`` reads the pool directly in the
paged kernel, ``ref`` materializes the gather as the JAX package does.

Sliding-window layers (gemma2's local layers) attend with the window, by
the JAX package's rule: no window unless the kind is "sliding", and none
when it covers every key. Their cache is a ring of W slots, slot i holding
the latest position congruent to i mod W: prefill builds it from each
row's last W real tokens, dense decode writes token t at (cur + t) mod W,
and the paged ring branch attends over [ring history ; the chunk's own
K/V] (``auto``: the ring flash kernel reads both in one launch; ``ref``:
the concatenation, as the JAX package) and then writes the chunk back,
last wins. The JAX package's ``banded_attention`` and
``blocked_attention`` (its own lowerings of the same function) have no
counterpart: the flash kernels take every shape.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hetero
from repro_torch.core.lora import lora_delta, lora_scale
from repro_torch.core.noise import NoiseConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers

NEG_INF = -1e30
# cache leaves under the paged layout: the full-attention pool, addressed
# through block tables (rolled back by the host's cursor), and a sliding
# layer's per-slot ring (snapshot and restored by ``SlotStateArena``)
POOL_LEAVES = ("kp", "vp")
SLOT_STATE_LEAVES = ("k", "v")


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return scores
    hetero.record_nonlinear(scores.numel())
    return cap * torch.tanh(scores / cap)


def ref_attention(q, k, v, q_pos, kv_pos, *, window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """q (B,T,Hq,D); k/v (B,S,Hkv,D) -> (B,T,Hq,D). f32 softmax."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, D) * (D ** -0.5)
    s = hetero.dynamic_einsum("bthgd,bshd->bhgts", qg, k)
    s = _softcap(s.to(torch.float32), softcap)
    m = fa_ops.visible_mask(q_pos, kv_pos, window)[:, None, None, :, :]
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    hetero.record_nonlinear(s.numel())
    p = torch.softmax(s, dim=-1)
    o = hetero.dynamic_einsum("bhgts,bshd->bthgd", p.to(v.dtype), v)
    return o.reshape(B, T, Hq, D)


def _window(kind: str, window: Optional[int], S: int) -> Optional[int]:
    """The JAX package's rule: a window only on a sliding layer, and none
    when it covers all ``S`` keys (sliding degenerates to full causal)."""
    window = window if kind == "sliding" else None
    return None if window is not None and window >= S else window


def attend(q, k, v, q_pos, kv_pos, *, kind: str, window: Optional[int],
           softcap: Optional[float], impl: str) -> torch.Tensor:
    window = _window(kind, window, k.shape[1])
    if impl == "ref":
        return ref_attention(q, k, v, q_pos, kv_pos, window=window,
                             softcap=softcap)
    if impl != "auto":
        raise ValueError(f"attn impl {impl!r} (expected 'auto' or 'ref')")
    _record_attention(q, k.shape[1], softcap)
    i32 = torch.int32
    return fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), q_pos.to(i32).contiguous(),
                                  kv_pos.to(i32).contiguous(), window=window,
                                  softcap=softcap)


def _record_attention(q, S: int, softcap) -> None:
    """The fused kernels' share of the FLOP tally: QK^T and PV over all S
    keys, as the JAX package's ``ref_attention`` counts them (it also
    picks that path for every shape the tests compare; its banded path
    counts only the band)."""
    B, T, Hq, D = q.shape
    hetero._record(hetero.DYNAMIC, 4.0 * B * T * Hq * S * D)
    hetero.record_nonlinear(B * T * Hq * S * (2 if softcap else 1))


# ---------------------------------------------------------------------------
# Paged decode: scatter the chunk into pool pages, attend through the block
# table. The JAX package drops padded tail tokens of a ragged chunk and
# positions whose page is unmapped (``mode="drop"``); ``index_put_`` has no
# drop mode, and filtering the rows would wait for the device. So every such
# row repeats the write of the first valid row instead: the same value to
# the same place, which leaves the pool bit for bit as JAX's drop does, at a
# fixed shape and with no host work (a CUDA graph captures it). Prefix-shared
# pages need no handling: a page mapped by several tables is read by each,
# visibility (`gpos < lens + clens`) masks resident tokens beyond a sharer's
# length, and writes never target a co-held page (the scheduler forks it
# first).
# ---------------------------------------------------------------------------


def paged_write_targets(positions: torch.Tensor, block_table: torch.Tensor,
                        chunk_lens: torch.Tensor, page_size: int):
    """Where each of the chunk's B*T rows goes in the pool: (src, page_ids,
    within), each (B*T,) int64. Row r writes new[src[r]] to
    pool[page_ids[r], :, within[r]]. A valid row (t < chunk_lens[b], its
    column inside the table and mapped) writes itself; every other row
    repeats the first valid row's write. Needs at least one valid row (every
    active engine tick has one)."""
    B, T = positions.shape
    nb = block_table.shape[1]
    t_idx = torch.arange(T, device=positions.device)
    valid = t_idx[None, :] < chunk_lens[:, None]             # (B, T)
    col = torch.div(positions, page_size, rounding_mode="floor")
    pid = torch.gather(block_table, 1, col.clamp(0, nb - 1).long())
    ok = (valid & (col < nb) & (pid >= 0)).reshape(-1)
    first = torch.argmax(ok.to(torch.int32))                 # a valid row
    src = torch.where(ok, torch.arange(B * T, device=positions.device),
                      first)
    within = (positions % page_size).reshape(-1).long()
    return src, pid.reshape(-1).long()[src], within[src]


def paged_pool_update(pool: torch.Tensor, new: torch.Tensor,
                      src: torch.Tensor, page_ids: torch.Tensor,
                      within: torch.Tensor) -> None:
    """In place: pool (P, Hkv, page, D)[page_ids[r], :, within[r]] =
    new (B*T, Hkv, D)[src[r]] for every row r (``paged_write_targets``)."""
    pool[page_ids, :, within, :] = new[src].to(pool.dtype)


def ring_write_targets(positions: torch.Tensor, chunk_lens: torch.Tensor,
                       W: int):
    """Where the chunk's B*T rows go in a ring (B, Hkv, W, D): (src, rows,
    slots), each (B*T,) int64; row r writes new[src[r]] to
    ring[rows[r], :, slots[r]]. Of the chunk's tokens that share a slot
    (t and t + W) only the latest valid one writes (the JAX package's
    last-wins mask: t < chunk_lens and t + W >= chunk_lens); every other
    row repeats the first writing row's write, as in
    ``paged_write_targets``, so duplicate indices always carry the same
    value. Needs a writing row (every active engine tick has one)."""
    B, T = positions.shape
    dev = positions.device
    t_idx = torch.arange(T, device=dev)[None, :]
    write = ((t_idx < chunk_lens[:, None])
             & (t_idx + W >= chunk_lens[:, None])).reshape(-1)
    first = torch.argmax(write.to(torch.int32))
    src = torch.where(write, torch.arange(B * T, device=dev), first)
    rows = torch.arange(B, device=dev).repeat_interleave(T)
    slots = torch.remainder(positions, W).reshape(-1).long()
    return src, rows[src], slots[src]


def _ring_attend(cfg: ModelConfig, q, k, v, positions, ring: Dict, paged, *,
                 kind, softcap, impl):
    """Chunked-prefill / decode attention of a sliding layer against its
    per-slot ring ``{"k", "v"}`` (each (B, Hkv, W, D), updated in place):
    attend over [ring history ; the chunk's own K/V] (a chunk longer than
    the ring is legal: its tokens attend each other directly), then write
    the chunk into the ring, last wins."""
    B, T = q.shape[0], q.shape[1]
    lens, clens = paged["lens"], paged["chunk_lens"]
    kc, vc = ring["k"], ring["v"]
    W = kc.shape[2]
    window = _window(kind, cfg.attn.window, W + T)
    if impl == "ref":
        kg = torch.cat([kc.transpose(1, 2).to(q.dtype), k], dim=1)
        vg = torch.cat([vc.transpose(1, 2).to(q.dtype), v], dim=1)
        kv_pos = fa_ops.ring_kv_pos(lens, clens, positions, W)
        out = ref_attention(q, kg, vg, positions, kv_pos, window=window,
                            softcap=softcap)
    elif impl == "auto":
        _record_attention(q, W + T, softcap)
        i32 = torch.int32
        out = fa_ops.ring_flash_attention(
            q.contiguous(), kc, vc, k.contiguous(), v.contiguous(),
            positions.to(i32).contiguous(), lens.to(i32).contiguous(),
            clens.to(i32).contiguous(), window=window, softcap=softcap)
    else:
        raise ValueError(f"attn impl {impl!r} (expected 'auto' or 'ref')")
    src, rows, slots = ring_write_targets(positions, clens, W)
    for leaf, new in ((kc, k), (vc, v)):
        leaf[rows, :, slots, :] = new.reshape(
            B * T, *new.shape[2:])[src].to(leaf.dtype)
    return out


def paged_attend(cfg: ModelConfig, q, k, v, positions, pool: Dict, paged, *,
                 kind, softcap, impl):
    """Chunked-prefill / decode attention against one layer's page pool
    ``{"kp", "vp"}`` (each (P, Hkv, page, D), updated in place), or a
    sliding layer's ring ``{"k", "v"}`` (``_ring_attend``).
    ``paged``: block_table (B, nb), lens (B,), chunk_lens (B,), page_size."""
    if "kp" not in pool:
        return _ring_attend(cfg, q, k, v, positions, pool, paged, kind=kind,
                            softcap=softcap, impl=impl)
    B, T = q.shape[0], q.shape[1]
    lens, clens = paged["lens"], paged["chunk_lens"]
    page = paged["page_size"]
    bt = paged["block_table"]                                # (B, nb)
    nb = bt.shape[1]
    targets = paged_write_targets(positions, bt, clens, page)
    for name, new in (("kp", k), ("vp", v)):
        paged_pool_update(pool[name], new.reshape(B * T, *new.shape[2:]),
                          *targets)
    if impl == "ref":
        kg = fa_ops.gather_pages(pool["kp"], bt).to(q.dtype)
        vg = fa_ops.gather_pages(pool["vp"], bt).to(q.dtype)
        kv_pos = fa_ops.paged_kv_pos(bt, lens, clens, page)
        return ref_attention(q, kg, vg, positions, kv_pos, softcap=softcap)
    if impl != "auto":
        raise ValueError(f"attn impl {impl!r} (expected 'auto' or 'ref')")
    _record_attention(q, nb * page, softcap)
    i32 = torch.int32
    return fa_ops.paged_flash_attention(
        q.contiguous(), pool["kp"], pool["vp"],
        positions.to(i32).contiguous(), bt.to(i32).contiguous(),
        lens.to(i32).contiguous(), clens.to(i32).contiguous(),
        page_size=page, softcap=softcap)


# ---------------------------------------------------------------------------
# Attention block (projections + cache plumbing)
# ---------------------------------------------------------------------------


def init_attn(cfg: ModelConfig, generator: torch.Generator, *, device, dtype,
              lead=()) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    kw = dict(device=device, dtype=dtype)
    p = {
        "wq": layers.dense_init(generator, (*lead, d, cfg.q_dim), name="wq",
                                **kw),
        "wk": layers.dense_init(generator, (*lead, d, cfg.kv_dim), name="wk",
                                **kw),
        "wv": layers.dense_init(generator, (*lead, d, cfg.kv_dim), name="wv",
                                **kw),
        "wo": layers.dense_init(generator, (*lead, cfg.q_dim, d),
                                fan_in=cfg.q_dim, name="wo", **kw),
    }
    if cfg.attn.qk_norm:
        p["q_norm"] = torch.ones((*lead, cfg.hd), **kw)
        p["k_norm"] = torch.ones((*lead, cfg.hd), **kw)
    return p


def _qk_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm of each head over head_dim in f32, times ``scale`` (hd,)."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(x.dtype)


def apply_attention_block(
    cfg: ModelConfig, p: Dict, x: torch.Tensor, positions: torch.Tensor, *,
    kind: str, mode: str = "prefill", cache: Optional[Dict] = None,
    prefill_cache_len: Optional[int] = None, lora: Optional[Dict] = None,
    adapter_idx: Optional[torch.Tensor] = None, impl: str = "auto",
    paged: Optional[Dict] = None, chunk_lens: Optional[torch.Tensor] = None,
    noise: Optional[NoiseConfig] = None, rng: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """MHA-1..MHA-4 for one layer. Returns (out, new_cache).

    mode: "train" (self-attend, no cache: new_cache is None), "prefill"
    (self-attend + emit a cache of ``prefill_cache_len``),
    "decode" (append to a dense cache {"k", "v" (B, Hkv, S, D), "len" (B,)}
    in place and attend over it). ``paged`` switches decode to the page
    pool ``{"kp", "vp"}`` of this layer (see ``paged_attend``).
    ``chunk_lens`` (B,) makes PREFILL ragged: row b holds chunk_lens[b]
    real tokens followed by padding that is invisible as keys. ``noise``
    (noise-aware fine-tuning) perturbs the frozen projections with noise
    drawn from ``rng``. A sliding layer's dense cache is a ring (module
    docstring)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    B, T, _ = x.shape
    scale = lora_scale(cfg)

    def proj(name):
        y = hetero.static_matmul(x, p[name], noise=noise, rng=rng)
        if lora is not None and name in lora:
            y = y + lora_delta(x, lora[name], scale, adapter_idx)
        return y

    q = proj("wq").reshape(B, T, cfg.n_heads, cfg.hd)
    k = proj("wk").reshape(B, T, cfg.n_kv_heads, cfg.hd)
    v = proj("wv").reshape(B, T, cfg.n_kv_heads, cfg.hd)
    if cfg.attn.qk_norm:
        q = _qk_norm(q, p["q_norm"], cfg.norm_eps)
        k = _qk_norm(k, p["k_norm"], cfg.norm_eps)

    sin, cos = layers.rope_sincos(positions, cfg.hd, cfg.attn.rope_theta)
    q = layers.apply_rope(q, sin, cos)
    k = layers.apply_rope(k, sin, cos)
    softcap = cfg.attn.logit_softcap

    new_cache = None
    if mode == "decode" and paged is not None:
        out = paged_attend(cfg, q, k, v, positions, cache, paged, kind=kind,
                           softcap=softcap, impl=impl)
        new_cache = cache
    elif mode == "decode":
        if cache is None:
            raise ValueError("decode without a cache")
        cur = cache["len"]
        kc, vc = cache["k"], cache["v"]                      # (B, Hkv, S, D)
        S_cache = kc.shape[2]
        if T > S_cache:
            raise ValueError(f"{T} tokens into a dense cache of {S_cache}")
        rows = torch.arange(B, device=x.device)[:, None]
        t_idx = torch.arange(T, device=x.device)[None]
        if kind == "sliding":
            # the ring: token t at (cur + t) mod W. Exact for T = 1, as every
            # engine decodes here; a T > 1 chunk that passes the ring's end
            # evicts keys its own earlier tokens still see (the JAX package
            # also clamps such a write; the paged ring branch attends to
            # the chunk before it writes)
            slots = torch.remainder(cur.long()[:, None] + t_idx, S_cache)
            kv_pos = fa_ops.ring_slot_pos(cur.long()[:, None] + T - 1,
                                          S_cache)
        else:
            if not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
                # eagerly, a row past its cache is the caller's error; a
                # CUDA graph's capture cannot wait for the device to check
                if int(cur.max()) + T > S_cache:
                    raise ValueError(f"dense cache of {S_cache} positions "
                                     f"is full")
            # in a graph, a full row writes its last T positions, as JAX's
            # dynamic_update_slice clamps its start
            start = torch.clamp(cur.long(), 0, S_cache - T)
            slots = start[:, None] + t_idx
            i = torch.arange(S_cache, device=x.device)[None, :]
            kv_pos = torch.where(i < (cur[:, None] + T), i,
                                 torch.full_like(i, -1))
        # in place: kc[b, :, slots[b, t]] = k[b, t]
        kc[rows, :, slots] = k.to(kc.dtype)
        vc[rows, :, slots] = v.to(vc.dtype)
        new_cache = {"k": kc, "v": vc, "len": cur + T}
        out = attend(q, kc.transpose(1, 2).to(q.dtype),
                     vc.transpose(1, 2).to(q.dtype), positions, kv_pos,
                     kind=kind, window=cfg.attn.window, softcap=softcap,
                     impl=impl)
    elif mode == "train":
        out = attend(q, k, v, positions, positions, kind=kind,
                     window=cfg.attn.window, softcap=softcap, impl=impl)
    else:
        kv_pos = positions
        if chunk_lens is not None:
            t_idx = torch.arange(T, device=x.device)[None, :]
            kv_pos = torch.where(t_idx < chunk_lens[:, None], kv_pos,
                                 torch.full_like(kv_pos, -1))
        out = attend(q, k, v, positions, kv_pos, kind=kind,
                     window=cfg.attn.window, softcap=softcap, impl=impl)
        S_cache = prefill_cache_len if prefill_cache_len is not None else T
        k_t = k.transpose(1, 2)                              # (B, Hkv, T, D)
        v_t = v.transpose(1, 2)
        lens_out = (torch.full((B,), T, dtype=torch.int32, device=x.device)
                    if chunk_lens is None else chunk_lens.to(torch.int32))
        if kind == "sliding":
            # the ring from each row's last W real tokens (a slot not yet
            # written takes token 0, as JAX's clip: its position is
            # negative, so it is never seen)
            W = min(cfg.attn.window, S_cache)
            src = torch.clamp(fa_ops.ring_slot_pos(
                lens_out.long()[:, None] - 1, W), 0, max(T - 1, 0))
            idx = src[:, None, :, None].expand(B, k_t.shape[1], W, cfg.hd)
            kc = torch.gather(k_t, 2, idx)
            vc = torch.gather(v_t, 2, idx)
        else:
            pad = S_cache - T
            kc = torch.nn.functional.pad(k_t, (0, 0, 0, pad))
            vc = torch.nn.functional.pad(v_t, (0, 0, 0, pad))
        new_cache = {"k": kc.to(q.dtype).contiguous(),
                     "v": vc.to(q.dtype).contiguous(), "len": lens_out}

    out = out.reshape(B, T, cfg.q_dim)
    y = hetero.static_matmul(out, p["wo"], noise=noise, rng=rng)
    if lora is not None and "wo" in lora:
        y = y + lora_delta(out, lora["wo"], scale, adapter_idx)
    return y, new_cache
