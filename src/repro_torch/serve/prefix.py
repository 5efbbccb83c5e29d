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

``save``/``load`` persist the index and its pages' K/V in the JAX
package's npz format, key for key, so either package loads the other's
file.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.models import kvcache
from repro_torch.models.attention import POOL_LEAVES
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

    # ------------------------------------------------------------------
    # Persistence: the trie and the page contents it references, so a new
    # engine starts with a warm prefix cache (``prefix_cache_path=``). Page
    # ids are not stable across restarts: the loader allocates pages from
    # the new pool and remaps.
    # ------------------------------------------------------------------

    def _records(self):
        """(nodes, tails), each a list of (adapter, parent node's record
        index or -1, tokens, page, tick), nodes in depth-first order (a
        parent before its children): the order ``save`` writes."""
        nodes: List[Tuple[int, int, Key, int, int]] = []
        tails: List[Tuple[int, int, Key, int, int]] = []

        def walk(node, parent: int, aid: int) -> None:
            for t in node.tails:
                tails.append((aid, parent, t.tokens, t.page, t.tick))
            for child in node.children.values():
                idx = len(nodes)
                nodes.append((aid, parent, child.key, child.page, child.tick))
                walk(child, idx, aid)

        for aid, root in self._roots.items():
            walk(root, -1, aid)
        return nodes, tails

    def pages(self) -> List[int]:
        """The pages the index holds, in the order ``save`` writes them."""
        nodes, tails = self._records()
        return [r[3] for r in nodes + tails]

    def save(self, path: str, cache) -> int:
        """Write the whole index (trie and K/V page contents) to ``path``
        (npz). Returns the number of pages written. The pages are read by
        ``kvcache.gather_pages``: index-held pages never change (a writer
        forks first)."""
        P = self.page_size
        nodes, tails = self._records()
        n, m = len(nodes), len(tails)
        node_tokens = np.zeros((n, P), np.int64)
        node_meta = np.zeros((n, 3), np.int64)             # adapter,parent,tick
        tail_tokens = np.zeros((m, P), np.int64)
        tail_meta = np.zeros((m, 4), np.int64)             # adapter,parent,len,tick
        pages: List[int] = []
        for i, (aid, parent, key, page, tick) in enumerate(nodes):
            node_tokens[i] = key
            node_meta[i] = (aid, parent, tick)
            pages.append(page)
        for i, (aid, parent, key, page, tick) in enumerate(tails):
            tail_tokens[i, :len(key)] = key
            tail_meta[i] = (aid, parent, len(key), tick)
            pages.append(page)
        data = kvcache.gather_pages(cache, pages)
        arrs = {f"pool_{li}_{name}": arr
                for li, entry in enumerate(data)
                for name, arr in entry.items()}
        with open(path, "wb") as f:
            np.savez(f, page_size=np.int64(P), n_positions=np.int64(len(data)),
                     node_tokens=node_tokens, node_meta=node_meta,
                     tail_tokens=tail_tokens, tail_meta=tail_meta, **arrs)
        return n + m

    def load(self, path: str, cache):
        """Rebuild a saved index into this engine's pool, in place.

        Allocates fresh pages (one index ref each, as the index holds one
        ref per page), scatters the saved K/V into them and rebuilds the
        trie with the new page ids. Entries that do not fit (a pool smaller
        than the file's, orphaned children) are skipped: loading is
        best-effort. A geometry that does not match (page size, the pool
        leaves' shapes) raises ``ValueError``.

        Returns ``(cache, pages_loaded)``; the cache is the one given,
        written in place."""
        z = np.load(path)
        if int(z["page_size"]) != self.page_size:
            raise ValueError(
                f"prefix cache at {path!r} was saved with page_size="
                f"{int(z['page_size'])}, engine uses {self.page_size}")
        n_pos = int(z["n_positions"])
        saved = [{name: z[f"pool_{li}_{name}"]
                  for name in POOL_LEAVES if f"pool_{li}_{name}" in z}
                 for li in range(n_pos)]
        live = [{name: leaf for name, leaf in entry.items()
                 if name in POOL_LEAVES} for entry in cache["layers"]]
        if len(saved) != len(live) or any(
                set(s) != set(lv) for s, lv in zip(saved, live)):
            raise ValueError(f"prefix cache at {path!r} does not match this "
                             f"model's paged layer structure")
        for s, lv in zip(saved, live):
            for name in s:
                a, b = s[name].shape, tuple(lv[name].shape)
                if (a[0],) + a[2:] != (b[0],) + b[2:]:
                    raise ValueError(
                        f"prefix cache at {path!r}: pool leaf {name} shape "
                        f"{a} incompatible with engine pool {b}")

        node_tokens, node_meta = z["node_tokens"], z["node_meta"]
        tail_tokens, tail_meta = z["tail_tokens"], z["tail_meta"]
        n = len(node_meta)
        # records are in DFS order, so a node's parent precedes it
        new_nodes: List[Optional[_Node]] = [None] * n
        rows: List[int] = []            # row in the saved page snapshot
        new_pages: List[int] = []
        for i in range(n):
            aid, parent, tick = (int(v) for v in node_meta[i])
            holder = self._root(aid) if parent < 0 else new_nodes[parent]
            if holder is None:          # its parent did not fit: orphan
                continue
            key = tuple(int(t) for t in node_tokens[i])
            if key in holder.children:  # already indexed by live traffic
                new_nodes[i] = holder.children[key]
                continue
            got = self.alloc.alloc(1)
            if got is None:
                continue
            node = _Node(key=key, page=got[0], tick=tick)
            holder.children[key] = node
            new_nodes[i] = node
            self.nodes += 1
            rows.append(i)
            new_pages.append(got[0])
        for i in range(len(tail_meta)):
            aid, parent, tlen, tick = (int(v) for v in tail_meta[i])
            holder = self._root(aid) if parent < 0 else new_nodes[parent]
            if holder is None or len(holder.tails) >= self.max_tails:
                continue
            toks = tuple(int(t) for t in tail_tokens[i, :tlen])
            if any(t.tokens[:tlen] == toks for t in holder.tails):
                continue
            got = self.alloc.alloc(1)
            if got is None:
                continue
            holder.tails.append(_Tail(tokens=toks, page=got[0], tick=tick))
            self.tail_entries += 1
            rows.append(n + i)
            new_pages.append(got[0])
        if new_pages:
            subset = [{name: arr[:, rows] for name, arr in entry.items()}
                      for entry in saved]
            kvcache.scatter_pages(cache, new_pages, subset)
        return cache, len(new_pages)
