"""The serving surface (PyTorch port of ``repro.serve.api``): one
Request/Completion pair, one Engine protocol, one factory, typed stats.

    eng = make_engine(cfg, params, adapters, mode="paged", max_slots=16)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=32))
    completions = eng.drain()          # {uid: Completion}
    st = eng.stats()                   # EngineStats (typed, frozen)

Two engines: ``mode="paged"`` (the serving engine: paged KV, chunked
prefill, prefix sharing, optional speculative decoding and prefix-cache
persistence) and ``mode="dense"`` (the dense oracle: a fixed ``max_batch x
max_len`` arena, kept for equivalence checks and as the throughput
benchmark's baseline). On a CUDA device the paged engine runs its mixed
step (and, with ``spec``, its verify step) as one CUDA graph per (chunk,
table) signature and the dense engine its decode step as one CUDA graph,
each captured at its first tick and replayed after that
(``CompileStats``); on the CPU the steps run eagerly. Tensor parallelism
and MoE wait for later slices (ROADMAP Queue 1 items 12 and 16).
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
    (chunk bucket, table-width bucket) step shapes the paged engine ran.
    ``compiled_steps``: CUDA graphs captured, one per signature on a CUDA
    device (the dense engine: its one decode graph; 0 on the CPU, which
    runs the step eagerly). ``replays``: ticks that replayed a graph (each
    signature's first tick runs eagerly and then captures). ``capture_ms``:
    host time spent capturing. ``graph_pool_bytes``: device memory the
    graphs' pool reserved. ``prefill_signatures``: the dense engine's
    prompt-width buckets, each prefilled eagerly (JAX compiles one prefill
    per bucket: ``prefill_compiles``)."""
    step_signatures: Tuple[Tuple[int, int], ...] = ()
    compiled_steps: int = 0
    replays: int = 0
    capture_ms: float = 0.0
    graph_pool_bytes: int = 0
    prefill_signatures: Tuple[int, ...] = ()

    @property
    def prefill_compiles(self) -> int:
        return len(self.prefill_signatures)


@dataclass(frozen=True)
class SchedulerStats:
    """Page-pool occupancy + preemption/CoW counters (host-side state)."""
    used_pages: int = 0
    free_pages: int = 0
    shared_pages: int = 0
    peak_pages: int = 0
    preemptions: int = 0
    reclaimed_pages: int = 0
    rolled_back_pages: int = 0
    recurrent_rollbacks: int = 0
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
    loaded_pages: int = 0              # pages restored via prefix_cache_path


@dataclass(frozen=True)
class SpecStats:
    """Speculative decoding's counters. ``recurrent_rollbacks`` counts
    verify chunks whose rejection was settled by restoring per-slot
    recurrent state (``SlotStateArena``) and replaying the accepted
    prefix: nonzero only on models with per-slot state (rwkv6-7b here).
    ``disabled_reason`` is kept for the JAX package's key set (no engine
    sets it). ``draft_signatures``/``draft_compiles``: only a drafter with
    steps of its own (``QuantSelfDrafter``) reports them: its (context
    bucket, k) signatures, one CUDA graph each on a CUDA device."""
    enabled: bool = False
    disabled_reason: Optional[str] = None
    k: int = 0
    drafter: str = ""
    steps: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    rolled_back_tokens: int = 0
    recurrent_rollbacks: int = 0
    accept_rate: float = 0.0
    draft_signatures: Tuple[Tuple[int, int], ...] = ()
    draft_compiles: Optional[int] = None


@dataclass(frozen=True)
class MoEStats:
    """MoE routing accounting. ``dispatch`` is the mode the engine forces
    ("dropless" for every serving row: prefill chunks, decode rows,
    spec-verify tails; "capacity" only when asked for as a benchmark
    baseline). ``dropped_tokens`` counts (token, expert) assignments
    dropped by capacity: 0 under dropless, and the engines raise if it
    ever is not."""
    enabled: bool = False               # does the model have MoE layers?
    dispatch: str = "dropless"
    dropped_tokens: int = 0


@dataclass(frozen=True)
class EngineStats:
    """Typed engine counters (``Engine.stats()``); ``as_dict()`` flattens
    them to the JAX package's key names for JSON output. ``scheduler`` and
    ``prefix_cache`` are None on the dense oracle (it has no page pool),
    ``kv_bytes`` is set on it only."""
    engine: str
    ticks: int
    decode_tokens: int
    prefill_tokens: int
    compile: CompileStats = CompileStats()
    scheduler: Optional[SchedulerStats] = None
    prefix_cache: Optional[PrefixCacheStats] = None
    spec: Optional[SpecStats] = None
    moe: MoEStats = MoEStats()
    kv_bytes: Optional[int] = None

    def as_dict(self) -> Dict[str, object]:
        d: Dict[str, object] = {
            "engine": self.engine,
            "ticks": self.ticks,
            "decode_tokens": self.decode_tokens,
            "prefill_tokens": self.prefill_tokens,
            "moe_dispatch": self.moe.dispatch,
            "moe_dropped_tokens": self.moe.dropped_tokens,
        }
        c = self.compile
        if self.scheduler is None:                      # dense oracle
            d.update({
                "prefill_signatures": list(c.prefill_signatures),
                "prefill_compiles": c.prefill_compiles,
                "kv_bytes": self.kv_bytes,
                "compiled_steps": c.compiled_steps,
                "graph_replays": c.replays,
                "capture_ms": c.capture_ms,
                "graph_pool_bytes": c.graph_pool_bytes,
            })
            return d
        s = self.scheduler
        pc = self.prefix_cache or PrefixCacheStats()
        sp = self.spec or SpecStats()
        d.update({
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
            "rolled_back_pages": s.rolled_back_pages,
            "recurrent_rollbacks": s.recurrent_rollbacks,
            "cow_forks": s.cow_forks,
            "spec_enabled": sp.enabled,
        })
        if sp.disabled_reason is not None:
            d["spec_disabled_reason"] = sp.disabled_reason
        if sp.enabled:
            d.update({
                "spec_k": sp.k,
                "spec_drafter": sp.drafter,
                "spec_steps": sp.steps,
                "drafted_tokens": sp.drafted_tokens,
                "accepted_tokens": sp.accepted_tokens,
                "rolled_back_tokens": sp.rolled_back_tokens,
                "spec_recurrent_rollbacks": sp.recurrent_rollbacks,
                "spec_accept_rate": sp.accept_rate,
            })
            if sp.draft_compiles is not None:
                d["draft_signatures"] = [tuple(sig) for sig
                                         in sp.draft_signatures]
                d["draft_compiles"] = sp.draft_compiles
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
                device=None, parallel=None, prefix_cache_path=None,
                **kwargs) -> Engine:
    """Single construction point for serving engines.

    ``mode="paged"`` — paged KV arena, chunked bucketed prefill,
    copy-on-write prefix sharing (``enable_prefix_cache=False`` disables
    it) and page-occupancy scheduling with preemption. Keyword args:
    max_slots, max_len, page_size, num_pages, prefill_chunk,
    enable_prefix_cache, spec, moe_dispatch, exec_cfg, seed,
    record_logits. MoE models route dropless unless
    ``moe_dispatch="capacity"`` asks for the benchmark baseline. ``parallel``
    with tp > 1 is not ported yet and raises.

    ``spec`` enables draft-and-verify decoding: a ``serve.spec.SpecConfig``
    or a drafter name (``"ngram"`` / ``"selfdraft"``) for the defaults.
    ``spec=None`` leaves the engine exactly as without it. On rwkv6-7b the
    per-slot state is checkpointed around each verify chunk and a
    rejection replays the accepted prefix
    (``stats().spec.recurrent_rollbacks``).

    ``prefix_cache_path`` persists the prefix index across restarts: if
    the file exists its trie and page contents load into the new engine's
    pool at construction (a missing file is a cold start);
    ``engine.save_prefix_cache()`` writes it. The file format is the JAX
    package's, so either package loads the other's.

    ``mode="dense"`` — the dense ``max_batch x max_len`` oracle, kept for
    equivalence checks and as the benchmark baseline. Keyword args:
    max_batch, max_len, exec_cfg, seed, record_logits. Tensor parallelism,
    ``prefix_cache_path`` and ``spec`` raise ``ValueError`` there, as in
    the JAX package.

    ``device``: None means the CUDA card (raises without one); "cpu" runs
    the kernels' plain versions."""
    from repro_torch.serve.engine import DenseServeEngine, PagedServeEngine
    if mode == "paged":
        return PagedServeEngine(cfg, params, adapters, device=device,
                                parallel=parallel,
                                prefix_cache_path=prefix_cache_path, **kwargs)
    if mode == "dense":
        if parallel is not None and getattr(parallel, "tp", 1) > 1:
            raise ValueError("tensor parallelism requires mode='paged' (the "
                             "dense oracle is a single-device baseline)")
        if prefix_cache_path is not None:
            raise ValueError("prefix_cache_path requires mode='paged' (the "
                             "dense oracle has no prefix index)")
        if kwargs.get("spec") is not None:
            raise ValueError("spec decoding requires mode='paged' (the "
                             "dense oracle has no rollback support)")
        kwargs.pop("spec", None)
        return DenseServeEngine(cfg, params, adapters, device=device,
                                **kwargs)
    raise ValueError(f"unknown engine mode {mode!r} (expected 'paged' or "
                     f"'dense')")
