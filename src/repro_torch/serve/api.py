"""The serving surface (PyTorch port of ``repro.serve.api``): one
Request/Completion pair, one Engine protocol, one factory, typed stats.

    eng = make_engine(cfg, params, adapters, mode="paged", max_slots=16)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=32))
    completions = eng.drain()          # {uid: Completion}
    st = eng.stats()                   # EngineStats (typed, frozen)

The port serves through the paged engine only. On a CUDA device it runs
its mixed step as one CUDA graph per (chunk, table) signature, captured at
the signature's first tick and replayed after that (``CompileStats``); on
the CPU the step runs eagerly. The dense oracle engine is replaced by
``tests/oracle.replay_greedy``; speculative decoding, tensor parallelism,
prefix-cache persistence and MoE wait for later slices (ROADMAP Queue 1
items 8, 10, 12 and 16).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Tuple, runtime_checkable

import numpy as np


@dataclass
class Request:
    """One generation request. ``generated``/``done``/``finish_reason`` are
    filled by the engine as it serves the request."""
    uid: int
    prompt: np.ndarray                  # (T,) int32
    max_new_tokens: int = 16
    adapter_id: int = 0
    temperature: float = 0.0
    eos_id: Optional[int] = None
    # filled by the engine
    generated: List[int] = field(default_factory=list)
    done: bool = False
    finish_reason: str = ""             # "length" | "eos" | "capacity"


@dataclass(frozen=True)
class Completion:
    """Immutable result of one finished request."""
    uid: int
    prompt: Tuple[int, ...]
    tokens: Tuple[int, ...]             # generated tokens
    adapter_id: int
    finish_reason: str

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)


def completion_of(req: Request) -> Completion:
    return Completion(uid=req.uid,
                      prompt=tuple(int(t) for t in req.prompt),
                      tokens=tuple(req.generated),
                      adapter_id=req.adapter_id,
                      finish_reason=req.finish_reason or "length")


@dataclass(frozen=True)
class CompileStats:
    """The engine's compiled steps, the port's counterpart of the JAX
    engine's jitted step signatures. ``step_signatures``: the distinct
    (chunk bucket, table-width bucket) step shapes the engine ran.
    ``compiled_steps``: CUDA graphs captured, one per signature on a CUDA
    device (0 on the CPU, which runs the step eagerly). ``replays``: ticks
    that replayed a graph (each signature's first tick runs eagerly and
    then captures). ``capture_ms``: host time spent capturing.
    ``graph_pool_bytes``: device memory the graphs' shared pool reserved."""
    step_signatures: Tuple[Tuple[int, int], ...] = ()
    compiled_steps: int = 0
    replays: int = 0
    capture_ms: float = 0.0
    graph_pool_bytes: int = 0


@dataclass(frozen=True)
class SchedulerStats:
    """Page-pool occupancy + preemption/CoW counters (host-side state)."""
    used_pages: int = 0
    free_pages: int = 0
    shared_pages: int = 0
    peak_pages: int = 0
    preemptions: int = 0
    reclaimed_pages: int = 0
    cow_forks: int = 0


@dataclass(frozen=True)
class PrefixCacheStats:
    enabled: bool = False
    hit_tokens: int = 0
    hits: int = 0
    index_nodes: int = 0
    index_tails: int = 0
    index_pages: int = 0
    index_evictions: int = 0


@dataclass(frozen=True)
class EngineStats:
    """Typed engine counters (``Engine.stats()``); ``as_dict()`` flattens
    them to the JAX package's key names for JSON output."""
    engine: str
    ticks: int
    decode_tokens: int
    prefill_tokens: int
    compile: CompileStats = CompileStats()
    scheduler: SchedulerStats = SchedulerStats()
    prefix_cache: PrefixCacheStats = PrefixCacheStats()

    def as_dict(self) -> Dict[str, object]:
        s, pc = self.scheduler, self.prefix_cache
        d: Dict[str, object] = {
            "engine": self.engine,
            "ticks": self.ticks,
            "decode_tokens": self.decode_tokens,
            "prefill_tokens": self.prefill_tokens,
            "prefix_hit_tokens": pc.hit_tokens,
            "prefix_hits": pc.hits,
            "prefix_cache_enabled": pc.enabled,
            "step_signatures": [tuple(sig) for sig
                                in self.compile.step_signatures],
            "compiled_steps": self.compile.compiled_steps,
            "graph_replays": self.compile.replays,
            "capture_ms": self.compile.capture_ms,
            "graph_pool_bytes": self.compile.graph_pool_bytes,
            "used_pages": s.used_pages,
            "free_pages": s.free_pages,
            "shared_pages": s.shared_pages,
            "peak_pages": s.peak_pages,
            "preemptions": s.preemptions,
            "reclaimed_pages": s.reclaimed_pages,
            "cow_forks": s.cow_forks,
        }
        if pc.enabled:
            d.update({"index_nodes": pc.index_nodes,
                      "index_tails": pc.index_tails,
                      "index_pages": pc.index_pages,
                      "index_evictions": pc.index_evictions})
        return d


@runtime_checkable
class Engine(Protocol):
    """What every serving engine exposes — nothing else is public API."""

    def submit(self, req: Request) -> None: ...
    def step(self) -> None: ...
    def drain(self, max_ticks: int = 100_000) -> Dict[int, Completion]: ...
    def stats(self) -> EngineStats: ...


def make_engine(cfg, params, adapters=(), *, mode: str = "paged",
                device=None, **kwargs) -> Engine:
    """Single construction point for serving engines.

    ``mode="paged"`` — paged KV arena, chunked bucketed prefill,
    copy-on-write prefix sharing (``enable_prefix_cache=False`` disables
    it) and page-occupancy scheduling with preemption. Keyword args:
    max_slots, max_len, page_size, num_pages, prefill_chunk,
    enable_prefix_cache, exec_cfg, seed, record_logits. ``device``: None
    means the CUDA card (raises without one); "cpu" runs the kernels' plain
    versions. ``spec``, ``parallel`` with tp > 1, ``prefix_cache_path`` and
    ``moe_dispatch="capacity"`` are not ported yet and raise."""
    from repro_torch.serve.engine import PagedServeEngine
    if mode == "dense":
        raise NotImplementedError(
            "the dense oracle engine is not ported: tests/oracle.py "
            "replay_greedy replaced it as the serving oracle")
    if mode != "paged":
        raise ValueError(f"unknown engine mode {mode!r} (expected 'paged')")
    return PagedServeEngine(cfg, params, adapters, device=device, **kwargs)
