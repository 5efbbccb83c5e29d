"""Radix prefix index over submitted prompt tokens -> resident KV pages
(port of ``repro.serve.prefix``; host-side, as in the JAX package).

The paged engine never recomputes KV for a prompt prefix two requests
share: a per-adapter radix trie whose edges are FULL pages of tokens maps
token streams onto pages that already hold their K/V. Partial last pages
are indexed too (``tails``): a later request matching part of a donated
tail shares the page mid-way and forks it copy-on-write at its first write.

Refcounting: the index holds exactly ONE allocator ref per node/tail page,
so a page whose refcount is 1 is held only by the index — those are the
evictable ones, leaf-only and youngest-first.

``save``/``load`` persistence waits for ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from repro_torch.models.kvcache import PageAllocator

Key = Tuple[int, ...]


@dataclass
class _Tail:
    """A partial last page: ``tokens`` (fewer than page_size of them) whose
    K/V occupy the first ``len(tokens)`` rows of ``page``."""
    tokens: Key
    page: int
    tick: int


@dataclass
class _Node:
    """One full page of tokens; ``page`` holds their K/V."""
    key: Key
    page: int
    tick: int
    children: Dict[Key, "_Node"] = field(default_factory=dict)
    tails: List[_Tail] = field(default_factory=list)


@dataclass
class _Root:
    """Per-adapter synthetic root (no page of its own)."""
    children: Dict[Key, _Node] = field(default_factory=dict)
    tails: List[_Tail] = field(default_factory=list)


class PrefixIndex:
    """Host-side prefix cache over the shared page pool."""

    def __init__(self, alloc: PageAllocator, page_size: int,
                 max_tails: int = 4):
        self.alloc = alloc
        self.page_size = page_size
        self.max_tails = max_tails
        self._roots: Dict[int, _Root] = {}
        self.nodes = 0
        self.tail_entries = 0
        self.evictions = 0

    def _root(self, adapter_id: int) -> _Root:
        return self._roots.setdefault(adapter_id, _Root())

    @staticmethod
    def _common(a: Key, b: Sequence[int]) -> int:
        n = 0
        for x, y in zip(a, b):
            if x != int(y):
                break
            n += 1
        return n

    @property
    def pages_held(self) -> int:
        return self.nodes + self.tail_entries

    # ------------------------------------------------------------------
    def lookup(self, adapter_id: int,
               tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest indexed prefix of ``tokens``: (matched_tokens, pages).
        Pure — takes no refs."""
        root = self._roots.get(adapter_id)
        if root is None:
            return 0, []
        P = self.page_size
        node: object = root
        pages: List[int] = []
        matched = 0
        while len(tokens) - matched >= P:
            key = tuple(int(t) for t in tokens[matched:matched + P])
            child = node.children.get(key)
            if child is None:
                break
            pages.append(child.page)
            matched += P
            node = child
        best_m, best_page = 0, -1
        for t in node.tails:
            m = self._common(t.tokens, tokens[matched:])
            if m > best_m:
                best_m, best_page = m, t.page
        if best_m:
            pages.append(best_page)
            matched += best_m
        return matched, pages

    # ------------------------------------------------------------------
    def register(self, adapter_id: int, tokens: Sequence[int],
                 pages: Sequence[int], tick: int) -> int:
        """Insert the FULL pages of ``tokens`` (covered by ``pages[i]``).
        Existing nodes are kept (first writer wins). Returns the number of
        newly indexed pages (each takes one allocator ref)."""
        node: object = self._root(adapter_id)
        P = self.page_size
        added = 0
        for i in range(len(tokens) // P):
            key = tuple(int(t) for t in tokens[i * P:(i + 1) * P])
            child = node.children.get(key)
            if child is None:
                child = _Node(key=key, page=pages[i], tick=tick)
                node.children[key] = child
                self.alloc.incref(pages[i])
                self.nodes += 1
                added += 1
            else:
                child.tick = tick
            node = child
        return added

    def register_tail(self, adapter_id: int, tokens: Sequence[int],
                      page: int, tick: int) -> bool:
        """Donate a partial prompt-tail page. Requires the full-page chain
        to still be indexed; skipped when an existing tail already covers
        these tokens."""
        P = self.page_size
        n_full = len(tokens) // P
        rem = tuple(int(t) for t in tokens[n_full * P:])
        if not rem:
            return False
        node: object = self._root(adapter_id)
        for i in range(n_full):
            key = tuple(int(t) for t in tokens[i * P:(i + 1) * P])
            node = node.children.get(key)
            if node is None:
                return False
        for t in node.tails:
            if t.tokens[:len(rem)] == rem:
                return False
        if len(node.tails) >= self.max_tails:
            return False
        node.tails.append(_Tail(tokens=rem, page=page, tick=tick))
        self.alloc.incref(page)
        self.tail_entries += 1
        return True

    # ------------------------------------------------------------------
    def _evictable(self):
        """(tick, kind, container, item) for every leaf whose page is held
        ONLY by the index (allocator refcount == 1)."""
        out = []

        def walk(node):
            for t in node.tails:
                if self.alloc.refcount(t.page) == 1:
                    out.append((t.tick, "tail", node, t))
            for child in node.children.values():
                if (not child.children and not child.tails
                        and self.alloc.refcount(child.page) == 1):
                    out.append((child.tick, "node", node, child))
                walk(child)

        for root in self._roots.values():
            walk(root)
        return out

    def evict(self, need: int) -> int:
        """Free up to ``need`` pages, youngest leaves first; only refcount-1
        pages. Returns pages actually freed."""
        freed = 0
        while freed < max(need, 1):
            cands = self._evictable()
            if not cands:
                break
            cands.sort(key=lambda c: -c[0])
            for _, kind, container, item in cands:
                if freed >= max(need, 1):
                    break
                if kind == "tail":
                    container.tails.remove(item)
                    self.tail_entries -= 1
                else:
                    del container.children[item.key]
                    self.nodes -= 1
                freed += 1 if self.alloc.decref(item.page) else 0
                self.evictions += 1
        return freed

    def clear(self) -> int:
        """Drop every index ref. Returns pages actually freed."""
        freed = 0

        def walk(node):
            nonlocal freed
            for t in node.tails:
                freed += 1 if self.alloc.decref(t.page) else 0
            for child in node.children.values():
                freed += 1 if self.alloc.decref(child.page) else 0
                walk(child)

        for root in self._roots.values():
            walk(root)
        self._roots = {}
        self.nodes = 0
        self.tail_entries = 0
        return freed

    def stats(self) -> Dict[str, int]:
        return {"index_nodes": self.nodes, "index_tails": self.tail_entries,
                "index_pages": self.pages_held,
                "index_evictions": self.evictions}
