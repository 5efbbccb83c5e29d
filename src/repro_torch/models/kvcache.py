"""Decode-time state: dense KV caches and the paged KV pool (PyTorch port of
the full-attention part of ``repro.models.kvcache``).

Cache layout mirrors the parameter scan layout: ``cache["layers"]`` is a
tuple (one entry per scan-period position) of dicts whose leaves are
stacked over scan periods. Dense KV is (n_sp, B, H_kv, S, D); the paged
pool is (n_sp, pages, H_kv, page, D). The port updates both in place
(the JAX package returns new arrays and donates the old buffers).

``SlotStateArena`` (per-slot ring / recurrent state) waits for ROADMAP
Queue 1 items 11-14: it is a no-op on full-attention models.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import scan_period

_NOT_FULL = ("only full-attention layers are ported (ROADMAP Queue 1 items "
             "11-14 port sliding, Mamba and RWKV state)")


def _check_full_attention(cfg: ModelConfig, pos: int) -> None:
    if cfg.block_kind(pos) != "attn" or cfg.attn_kind(pos) != "full":
        raise NotImplementedError(_NOT_FULL)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               kv_dtype=torch.float32):
    """Zero-initialized dense cache tree for decode (len == 0)."""
    p = scan_period(cfg)
    n_sp = cfg.n_layers // p
    layers = []
    for pos in range(p):
        _check_full_attention(cfg, pos)
        shape = (n_sp, batch, cfg.n_kv_heads, max_len, cfg.hd)
        layers.append({
            "k": torch.zeros(shape, device=device, dtype=kv_dtype),
            "v": torch.zeros(shape, device=device, dtype=kv_dtype),
            "len": torch.zeros((n_sp, batch), device=device,
                               dtype=torch.int32)})
    return {"layers": tuple(layers)}


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


def init_paged_cache(cfg: ModelConfig, layout: PagedLayout, max_len: int, *,
                     device, kv_dtype=torch.float32):
    """Zero-initialized paged cache tree (leaves stacked over scan periods)."""
    p = scan_period(cfg)
    n_sp = cfg.n_layers // p
    layers = []
    for pos in range(p):
        _check_full_attention(cfg, pos)
        shape = (n_sp, layout.num_pages, cfg.n_kv_heads, layout.page_size,
                 cfg.hd)
        layers.append({
            "kp": torch.zeros(shape, device=device, dtype=kv_dtype),
            "vp": torch.zeros(shape, device=device, dtype=kv_dtype)})
    return {"layers": tuple(layers)}


def reset_slots(cache, slots: Sequence[int]):
    """Zero the per-slot rows for reused slots. Page-pool leaves need no
    reset (a recycled page is only readable below the owning request's
    length, and every position below it is rewritten before it becomes
    visible), and full-attention models keep no other per-slot state."""
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
        for name in ("kp", "vp"):
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
