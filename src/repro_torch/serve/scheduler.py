"""Page-occupancy scheduler for the paged serving engine (port of
``repro.serve.scheduler``; host-side numpy, as in the JAX package).

Admission, growth, and preemption are all decided by page availability —
not slot count. A request is admitted when the pool can hold its prompt
plus one decode token; it grows page-by-page as it decodes; when the pool
runs dry the scheduler first reclaims prefix-cache pages (via the
``reclaim`` hook — only refcount-1 pages nobody is actively serving from),
then preempts the youngest running request (pages decref'd, request
requeued for recompute-style resume), which keeps the oldest requests
making progress.

Prefix sharing: a slot's block table may map pages co-held by other slots
and/or the prefix index, so ``release`` decrefs rather than frees,
preemption accounting reports pages ACTUALLY reclaimed, and any page a
slot is about to write while others still hold it is forked copy-on-write:
``ensure`` swaps in a fresh page and queues a device-side copy
(``pending_forks``) that the engine executes before its next mixed step.

Speculative-decode rollback: ``rollback`` sets a slot's write cursor
after a verify chunk and releases the pages wholly past it
(``PageAllocator.release_tail``); on models with per-slot recurrent state
the engine rewinds to the pre-chunk length in lockstep with the state's
restore (``recurrent=True``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.models.kvcache import PageAllocator, PagedLayout


@dataclass
class SlotState:
    """Engine-side bookkeeping for one occupied decode slot."""
    req: object                       # serve.api.Request
    pages: List[int] = field(default_factory=list)
    admitted_tick: int = 0            # for youngest-first preemption
    shared_tokens: int = 0            # prefix-cache tokens mapped at admit


class PageScheduler:
    """Tracks the shared pool, per-slot block tables, and request lengths."""

    def __init__(self, layout: PagedLayout, max_len: int,
                 reclaim: Optional[Callable[[int], int]] = None):
        self.layout = layout
        self.max_len = max_len
        self.max_blocks = layout.blocks_for(max_len)
        self.alloc = PageAllocator(layout.num_pages)
        self.tables = np.full((layout.max_slots, self.max_blocks), -1,
                              np.int32)
        self.lens = np.zeros(layout.max_slots, np.int32)
        self.slots: List[Optional[SlotState]] = [None] * layout.max_slots
        self.reclaim = reclaim            # prefix-index eviction hook
        self.preemptions = 0
        self.peak_pages = 0
        self.reclaimed_pages = 0          # pages ACTUALLY freed by preemption
        self.cow_forks = 0
        self.rolled_back_pages = 0        # pages freed by spec rollbacks
        self.recurrent_rollbacks = 0      # rewinds with a state restore
        self.pending_forks: List[Tuple[int, int, int]] = []  # (slot, src, dst)
        self.evicted: List[object] = []   # preempted requests to requeue

    # ------------------------------------------------------------------
    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Pool alloc with one prefix-cache reclaim retry when dry."""
        pages = self.alloc.alloc(n)
        if pages is None and self.reclaim is not None:
            self.reclaim(n - self.alloc.free_pages)
            pages = self.alloc.alloc(n)
        if pages is not None:
            self.peak_pages = max(self.peak_pages, self.alloc.used_pages)
        return pages

    def _grow(self, slot: int, new_len: int) -> bool:
        """Ensure the slot's table covers ``new_len`` tokens (all-or-nothing)."""
        st = self.slots[slot]
        need = self.layout.blocks_for(new_len) - len(st.pages)
        if need <= 0:
            return True
        pages = self._alloc(need)
        if pages is None:
            return False
        base = len(st.pages)
        st.pages.extend(pages)
        self.tables[slot, base:base + len(pages)] = pages
        return True

    def admit(self, req, prompt_len: int, tick: int,
              shared: Optional[Tuple[int, List[int]]] = None) -> Optional[int]:
        """Place a request if a slot and its prompt's pages are available.

        ``shared`` = (matched_tokens, pages) from the prefix index: the
        matched pages are mapped (and incref'd) into the head of the block
        table, the slot's length starts at ``matched_tokens`` so prefill
        resumes at the first unshared token, and only the remainder is
        allocated fresh (all-or-nothing)."""
        slot = self.free_slot()
        if slot is None:
            return None
        if prompt_len + 1 > self.max_len:
            raise ValueError(
                f"prompt of {prompt_len} tokens exceeds max_len={self.max_len}")
        matched, spages = shared if shared else (0, [])
        st = SlotState(req=req, admitted_tick=tick, shared_tokens=matched)
        self.slots[slot] = st
        for p in spages:
            self.alloc.incref(p)           # before any reclaim can run
        st.pages = list(spages)
        self.tables[slot, :len(spages)] = spages
        self.lens[slot] = matched
        if not self._grow(slot, prompt_len + 1):
            self.release(slot)
            return None
        return slot

    def ensure(self, slot: int, new_len: int,
               protect: Sequence[int] = ()) -> bool:
        """Grow a slot and fork any shared page it is about to write,
        preempting younger slots if the pool is dry.

        Write range is [lens[slot], new_len): a page there with refcount
        > 1 is co-held, so the slot gets a fresh page, a device copy is
        queued in ``pending_forks``, and the old page is decref'd.

        Returns False when the slot itself had to be preempted."""
        if self.layout.blocks_for(new_len) > self.layout.num_pages:
            self.preempt(slot)
            return False
        while not self._grow(slot, new_len):
            victim = self.youngest(exclude=protect)
            if victim is None or victim == slot:
                self.preempt(slot)
                return False
            self.preempt(victim)
        st = self.slots[slot]
        P = self.layout.page_size
        for col in range(int(self.lens[slot]) // P,
                         self.layout.blocks_for(new_len)):
            pg = st.pages[col]
            if self.alloc.refcount(pg) <= 1:
                continue
            got = self._alloc(1)
            while got is None:
                victim = self.youngest(exclude=protect)
                if victim is None or victim == slot:
                    self.preempt(slot)
                    return False
                self.preempt(victim)
                got = self._alloc(1)
            new = got[0]
            st.pages[col] = new
            self.tables[slot, col] = new
            self.alloc.decref(pg)
            self.cow_forks += 1
            self.pending_forks.append((slot, pg, new))
        return True

    def rollback(self, slot: int, new_len: int, *,
                 recurrent: bool = False) -> int:
        """Set a slot's write cursor to ``new_len`` tokens and release the
        pages now wholly past it: one call settles a speculative-decode
        tick (the cursor advances over accepted tokens and rolls back over
        rejected ones; it stays within the pages already granted).

        ``recurrent=True`` marks a rewind made in lockstep with a per-slot
        recurrent-state restore (``SlotStateArena``): the engine rewinds to
        the pre-chunk length and replays the accepted tokens as a resumed
        prefill chunk. Counted apart, so stats can attribute that prefill.

        Pages in the rejected range were allocated this tick or forked
        copy-on-write before the speculative write, so dropping this
        slot's ref never corrupts a co-holder. Returns pages ACTUALLY
        freed."""
        st = self.slots[slot]
        assert st is not None, f"rollback of empty slot {slot}"
        assert new_len > 0, new_len
        keep = self.layout.blocks_for(new_len)
        freed = self.alloc.release_tail(st.pages, keep)
        self.tables[slot, keep:] = -1
        self.lens[slot] = new_len
        self.rolled_back_pages += freed
        if recurrent:
            self.recurrent_rollbacks += 1
        return freed

    def take_forks(self) -> List[Tuple[int, int, int]]:
        """Drain queued CoW copies (slot, src, dst)."""
        out, self.pending_forks = self.pending_forks, []
        return out

    def youngest(self, exclude: Sequence[int] = ()) -> Optional[int]:
        cands = [i for i in self.active() if i not in exclude]
        if not cands:
            return None
        return max(cands, key=lambda i: self.slots[i].admitted_tick)

    def preempt(self, slot: int) -> int:
        """Recycle the slot's pages; the request resumes by recompute.
        Returns pages ACTUALLY freed."""
        req = self.slots[slot].req
        freed = self.release(slot)
        self.preemptions += 1
        self.reclaimed_pages += freed
        self.evicted.append(req)
        return freed

    def drain_evicted(self) -> List[object]:
        out, self.evicted = self.evicted, []
        return out

    def release(self, slot: int) -> int:
        """Decref the slot's pages (freeing refcount-1 ones); returns the
        count actually freed."""
        st = self.slots[slot]
        freed = 0
        if st is not None and st.pages:
            freed = self.alloc.free(st.pages)
        if st is not None and self.pending_forks:
            self.pending_forks = [f for f in self.pending_forks
                                  if f[0] != slot]
        self.tables[slot, :] = -1
        self.lens[slot] = 0
        self.slots[slot] = None
        return freed

    # ------------------------------------------------------------------
    def blocks_in_use(self, slots: Sequence[int], chunk: np.ndarray) -> int:
        """Widest block-table prefix any of ``slots`` needs this tick."""
        nb = 1
        for i in slots:
            nb = max(nb, self.layout.blocks_for(int(self.lens[i] + chunk[i])))
        return nb

    def occupancy(self) -> Dict[str, int]:
        return {"used_pages": self.alloc.used_pages,
                "free_pages": self.alloc.free_pages,
                "shared_pages": self.alloc.shared_pages,
                "peak_pages": self.peak_pages,
                "preemptions": self.preemptions,
                "reclaimed_pages": self.reclaimed_pages,
                "rolled_back_pages": self.rolled_back_pages,
                "recurrent_rollbacks": self.recurrent_rollbacks,
                "cow_forks": self.cow_forks}


def bucketize(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= n (buckets sorted ascending; last is the cap)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def power_buckets(cap: int, floor: int = 1) -> Tuple[int, ...]:
    """(floor, ..., powers of two, ..., cap) — O(log cap) distinct widths."""
    out = {floor, cap}
    b = floor
    while b < cap:
        b *= 2
        out.add(min(b, cap))
    return tuple(sorted(out))
