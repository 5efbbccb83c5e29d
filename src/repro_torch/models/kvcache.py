"""Decode-time state: dense KV caches, the paged KV pool and per-slot RWKV
state (PyTorch port of ``repro.models.kvcache`` for full attention and
RWKV).

Cache layout mirrors the parameter scan layout: ``cache["layers"]`` is a
tuple (one entry per scan-period position) of dicts whose leaves are
stacked over scan periods. Dense KV is (n_sp, B, H_kv, S, D); the paged
pool is (n_sp, pages, H_kv, page, D); RWKV keeps per-row token-shift
buffers (n_sp, B, d) and the wkv state (n_sp, B, H, N, N) f32. The port
updates all of them in place (the JAX package returns new arrays and
donates the old buffers).

Sliding-window rings and Mamba state wait for ROADMAP Queue 1 items 11
and 13.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import scan_period
from repro_torch.models import rwkv
from repro_torch.models.attention import POOL_LEAVES


def _check_ported(cfg: ModelConfig, pos: int) -> None:
    kind = cfg.block_kind(pos)
    if kind == "rwkv" or (kind == "attn" and cfg.attn_kind(pos) == "full"):
        return
    raise NotImplementedError(
        "sliding-window and Mamba state are not ported yet (ROADMAP Queue 1 "
        "items 11 and 13)")


def position_cache_spec(cfg: ModelConfig, pos: int, batch: int, max_len: int,
                        kv_dtype=torch.float32):
    """{leaf: (shape, dtype)} for one scan position's cache (no stacking)."""
    _check_ported(cfg, pos)
    if cfg.block_kind(pos) == "rwkv":
        rc = cfg.rwkv
        H = cfg.d_model // rc.head_dim
        return {
            "shift_t": ((batch, cfg.d_model), kv_dtype),
            "shift_c": ((batch, cfg.d_model), kv_dtype),
            "wkv": ((batch, H, rc.head_dim, rc.head_dim), torch.float32),
        }
    return {
        "k": ((batch, cfg.n_kv_heads, max_len, cfg.hd), kv_dtype),
        "v": ((batch, cfg.n_kv_heads, max_len, cfg.hd), kv_dtype),
        "len": ((batch,), torch.int32),
    }


def zeros_from_spec(spec, lead, device):
    """Zero tensors for a {leaf: (shape, dtype)} spec, stacked along
    ``lead``."""
    return {name: torch.zeros((*lead, *shape), device=device, dtype=dt)
            for name, (shape, dt) in spec.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               kv_dtype=torch.float32):
    """Zero-initialized dense cache tree for decode (len == 0)."""
    p = scan_period(cfg)
    n_sp = cfg.n_layers // p
    return {"layers": tuple(
        zeros_from_spec(position_cache_spec(cfg, pos, batch, max_len,
                                            kv_dtype), (n_sp,), device)
        for pos in range(p))}


# ---------------------------------------------------------------------------
# Paged layout (serving): full-attention KV lives in fixed-size pages drawn
# from a shared pool; per-request block tables map positions -> pages.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PagedLayout:
    """Geometry of the shared page pool.

    ``num_pages * page_size`` is the total token capacity across all
    concurrent requests; ``max_slots`` bounds the decode batch width."""

    page_size: int = 16
    num_pages: int = 256
    max_slots: int = 16

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)


def position_paged_spec(cfg: ModelConfig, pos: int, layout: PagedLayout,
                        max_len: int, kv_dtype=torch.float32):
    """{leaf: (shape, dtype)} for one scan position under the paged layout:
    full attention reads the shared page pool, recurrent state keeps the
    dense per-slot layout at batch = max_slots."""
    if cfg.block_kind(pos) == "attn":
        _check_ported(cfg, pos)
        shape = (layout.num_pages, cfg.n_kv_heads, layout.page_size, cfg.hd)
        return {"kp": (shape, kv_dtype), "vp": (shape, kv_dtype)}
    return position_cache_spec(cfg, pos, layout.max_slots, max_len, kv_dtype)


def init_paged_cache(cfg: ModelConfig, layout: PagedLayout, max_len: int, *,
                     device, kv_dtype=torch.float32):
    """Zero-initialized paged cache tree (leaves stacked over scan periods)."""
    p = scan_period(cfg)
    n_sp = cfg.n_layers // p
    return {"layers": tuple(
        zeros_from_spec(position_paged_spec(cfg, pos, layout, max_len,
                                            kv_dtype), (n_sp,), device)
        for pos in range(p))}


def reset_slots(cache, slots: Sequence[int]):
    """Zero the per-slot rows (recurrent state) of reused slots, in place.
    Page-pool leaves need no reset: a recycled page is only readable below
    the owning request's length, and every position below it is rewritten
    before it becomes visible."""
    if not slots:
        return cache
    for entry in cache["layers"]:
        for name, leaf in entry.items():
            if name not in POOL_LEAVES:
                leaf[:, list(slots)] = 0
    return cache


class SlotStateArena:
    """Reset of the per-slot decode state of recycled slots.

    Under the paged layout full-attention KV is pool-addressed; everything
    else is per slot: here the RWKV token-shift and wkv state
    (``rwkv.SLOT_STATE_LEAVES``), cumulative over the whole stream. A slot
    that a new (or preempted and readmitted) request takes must start from
    zero state, so the engine resets it at admission. ``tracked`` is False
    for full-attention-only models, and ``reset`` is then a no-op. The
    JAX package's ``snapshot``/``restore`` serve speculative decoding and
    wait for it (ROADMAP Queue 1 item 10)."""

    def __init__(self, cfg: ModelConfig):
        per_pos: List[Tuple[str, ...]] = []
        for pos in range(scan_period(cfg)):
            _check_ported(cfg, pos)
            per_pos.append(tuple(rwkv.SLOT_STATE_LEAVES)
                           if cfg.block_kind(pos) == "rwkv" else ())
        self.leaves: Tuple[Tuple[str, ...], ...] = tuple(per_pos)
        self.tracked: bool = any(self.leaves)

    def reset(self, cache, slots: Sequence[int]):
        """Zero the tracked rows of ``slots`` in every layer, in place."""
        if not (self.tracked and slots):
            return cache
        idx = list(slots)
        for entry, names in zip(cache["layers"], self.leaves):
            for n in names:
                entry[n][:, idx] = 0
        return cache


class PageAllocator:
    """Host-side refcounted free-list allocator over the shared pool.

    All-or-nothing allocation, LIFO recycling. Pages carry refcounts so
    prefix-sharing requests (and the prefix index) can hold the same page:
    ``alloc`` hands out pages at refcount 1, ``incref`` adds a holder, and
    ``decref``/``free`` release one — the page returns to the free list
    only when its count reaches zero (copy-on-write forking, not in-place
    mutation, is the only legal way to diverge)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._refs: List[int] = [0] * num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages with more than one holder (slot or prefix-index refs)."""
        return sum(1 for r in self._refs if r > 1)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def alloc(self, n: int) -> Optional[List[int]]:
        if n < 0 or n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def incref(self, page: int) -> None:
        assert self._refs[page] > 0, f"incref of free page {page}"
        self._refs[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one holder; returns True iff the page actually freed."""
        assert 0 <= page < self.num_pages, page
        assert self._refs[page] > 0, f"double free of page {page}"
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)
            return True
        return False

    def free(self, pages: Sequence[int]) -> int:
        """Decref every page; returns how many were ACTUALLY reclaimed."""
        return sum(1 for p in pages if self.decref(p))

    def check_invariants(self) -> None:
        assert len(set(self._free)) == len(self._free), "free-list dup"
        assert all(0 <= p < self.num_pages for p in self._free)
        for p in range(self.num_pages):
            in_free = p in self._free
            assert (self._refs[p] == 0) == in_free, \
                f"page {p}: refs={self._refs[p]} free={in_free}"


def fork_pages(cache, src: torch.Tensor, dst: torch.Tensor):
    """Copy-on-write fork, in place: copy pool pages ``src[i] -> dst[i]`` in
    every kp/vp leaf. All sources are read (gathered into a temporary)
    before any write, so a page may be a source and another pair's
    destination within one call."""
    for entry in cache["layers"]:
        for name in POOL_LEAVES:
            if name in entry:
                leaf = entry[name]
                leaf[:, dst] = leaf[:, src]
    return cache


def cache_len(cache) -> Optional[torch.Tensor]:
    """Per-batch-row lengths (B,) of a dense cache."""
    for entry in cache["layers"]:
        if "len" in entry:
            return entry["len"][0]
    return None
