"""Serving engines: continuous batching + multi-adapter LoRA decode
(PyTorch port of ``repro.serve.engine``).

The paper's inference story (SS V.G): the frozen base lives on the device
(crossbar-quantized); switching tasks means swapping only LoRA adapters.
Here that becomes multi-tenant serving: adapters are stacked along axis 1
and every request carries an adapter id; one batched step serves a batch
of requests of different tasks. Two engines implement the ``serve.api``
surface; construct them through ``serve.api.make_engine``:

  * ``DenseServeEngine`` — the dense oracle: per-slot KV rows in a fixed
    ``max_batch x max_len`` arena (``kvcache.init_cache``), one whole-
    prompt prefill per request, padded to a power-of-two bucket, then one
    batched decode step over every slot per tick. Kept for equivalence
    checks and as the throughput benchmark's baseline.
  * ``PagedServeEngine`` — the serving engine, below.

Paged engine: full-attention KV lives in a shared page pool addressed by
per-request block tables; RWKV state lives in per-slot rows. Prefill runs
in chunks padded to a small set of bucket widths; prefill chunks and
decode rows run through ONE mixed step per tick. Admission and eviction
are decided by page occupancy (``serve.scheduler``). ``forward`` updates
the pool and the per-slot state in place, so they carry across ticks in
``self.cache`` (the JAX package donates them to its jitted step and takes
the new ones back). A slot is zeroed through ``SlotStateArena.reset``
whenever a request is admitted to it. A radix prefix index
(``serve.prefix``) maps new requests onto already-resident pages; shared
pages are forked copy-on-write before their first divergent write. It
serves full-attention models only: RWKV state is relative to the whole
stream and cannot be grafted across requests.

On a CUDA device both engines run their fixed-shape step as CUDA graphs,
the port's counterpart of the JAX package's ``jax.jit`` of the step: the
paged engine one graph per (chunk bucket, table bucket) signature, the
dense engine one graph of its decode step (its prefill runs eagerly, once
per request, as JAX compiles it once per bucket). A graph's first tick
runs eagerly (it is also the first use of each kernel at that shape),
then the step is captured without running it; every later tick copies its
inputs into the graph's own (from pinned host memory, without a wait) and
replays it. The graph ends at the logits, and sampling runs eagerly after
it. The graphs share one memory pool per engine; the kernels' split
workspaces are reserved for the largest step before any capture, and the
cache is written in place, into the tensors the graph captured. A capture
that fails raises: nothing falls back to the eager step. On the CPU (the
tests) the steps run eagerly. The paged engine's copy-on-write forks and
slot resets run eagerly between ticks, as they are rare (the JAX package
jits its forks by fork bucket).

Speculative decoding (``spec=``, ``serve.spec``) replaces the paged
engine's step by a verify step, one CUDA graph per (chunk, table)
signature as well: it copies the per-slot recurrent state into the
engine's snapshot buffers (rwkv only), runs the same mixed forward, and
returns the logits at the positions the tick reads (a decode row's verify
chunk, a prefill row's last position), never all of (B, C, V). After the
replay, eagerly: the acceptance rule (``verify_accept``), the per-slot
restore of the recurrent state in place, then the host's settling
(``_advance_spec``). The self-drafter's draft runs as CUDA graphs of its
own. Prefix-cache persistence (``prefix_cache_path=``,
``save_prefix_cache``) loads the index into the pool in place at
construction. Tensor parallelism raises ``NotImplementedError`` in the
paged engine (ROADMAP Queue 1 item 16).

Mixture-of-experts models route drop-free in both engines
(``moe_dispatch="dropless"``, as the JAX package forces it): capacity
drops would make a request's greedy tokens depend on how its prompt was
chunked, preempted or batched. The paged engine takes
``moe_dispatch="capacity"`` as a baseline for benchmarking. Each step
writes its drop count into a device buffer of the engine, which reaches
the host in the tick's one existing read (the sampled tokens'); a nonzero
count under dropless raises.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, kernels, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lora as lora_lib
from repro_torch.core.lora import scan_period
from repro_torch.models import kvcache, transformer as tfm
from repro_torch.models.kvcache import PagedLayout
from repro_torch.models.transformer import ExecConfig
from repro_torch.serve import spec as spec_mod
from repro_torch.serve.api import (Completion, CompileStats, EngineStats,
                                   MoEStats, PrefixCacheStats, Request,
                                   SchedulerStats, SpecStats, completion_of)
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.sampling import sample_tokens
from repro_torch.serve.spec import SpecConfig
from repro_torch.serve.scheduler import PageScheduler, bucketize, power_buckets


def _ring_len(cfg: ModelConfig, max_len: int) -> Optional[int]:
    """Slots of the model's sliding-window rings (None: it has none)."""
    sliding = any(cfg.block_kind(pos) == "attn"
                  and cfg.attn_kind(pos) == "sliding"
                  for pos in range(scan_period(cfg)))
    return kvcache.ring_len(cfg, max_len) if sliding else None


def _validate_request(req: Request, max_len: int) -> None:
    if len(req.prompt) == 0:
        raise ValueError(f"request uid={req.uid}: empty prompt")
    if len(req.prompt) + 1 > max_len:
        raise ValueError(f"request uid={req.uid}: prompt of "
                         f"{len(req.prompt)} tokens exceeds "
                         f"max_len={max_len}")


def _force_moe_dispatch(exec_cfg: ExecConfig, dispatch: str) -> ExecConfig:
    """Serving routes MoE tokens drop-free: capacity drops would make a
    request's greedy tokens depend on how its prompt was chunked,
    preempted, or batched. ``dispatch="capacity"`` is allowed only as an
    explicit baseline for benchmarking the dropless overhead."""
    if dispatch not in ("dropless", "capacity"):
        raise ValueError(f"unknown moe_dispatch {dispatch!r} "
                         "(expected 'dropless' or 'capacity')")
    return dataclasses.replace(exec_cfg, moe_dispatch=dispatch)


def _track_drops(engine, dropped: int) -> None:
    """Accumulate a step's MoE drop count; under dropless dispatch any
    nonzero count is an invariant violation, not a statistic."""
    engine.moe_dropped_tokens += dropped
    if dropped and engine.ec.moe_dispatch == "dropless":
        raise RuntimeError(
            f"dropless MoE dispatch dropped {dropped} (token, expert) "
            "assignments — the drop-free invariant is broken")


def _has_moe(cfg: ModelConfig) -> bool:
    return any(cfg.is_moe_layer(i) for i in range(cfg.n_layers))


def _stream(req: Request) -> np.ndarray:
    """Tokens that belong in the cache: the prompt plus every generated
    token except the newest (which is the next decode input)."""
    if len(req.generated) <= 1:
        return np.asarray(req.prompt, np.int32)
    return np.concatenate([np.asarray(req.prompt, np.int32),
                           np.asarray(req.generated[:-1], np.int32)])


def _stream_len(req: Request) -> int:
    return len(req.prompt) + max(0, len(req.generated) - 1)


# A step's int32 inputs travel packed in one buffer, each part starting on
# 16 bytes (the alignment the flash kernels take): one copy a tick. The
# verify step of speculative decoding adds the rows' draft lengths.
_PARTS = ("tokens", "lens", "clens", "table", "adapter")
_SPEC_PARTS = _PARTS + ("dlens",)


def _segments(B: int, C: int, nb: int, spec: bool = False
              ) -> Tuple[Dict[str, Tuple[int, int]], int]:
    """(offset, length) of each part of the packed inputs (``spec``: the
    verify step's), and their end."""
    out, o = {}, 0
    sizes = (B * C, B, B, B * nb, B, B)
    for name, n in zip(_SPEC_PARTS if spec else _PARTS, sizes):
        out[name] = (o, n)
        o += -(-n // 4) * 4
    return out, o


@dataclass
class _Graph:
    """One captured step: the packed inputs it reads, what it returns (the
    logits, or a tuple of outputs), and the kernel launches that one
    replay makes."""
    graph: "torch.cuda.CUDAGraph"
    inputs: torch.Tensor
    out: object
    launches: Dict[str, int]


def _capture(device: torch.device, pool, step_fn, n: int,
             what: str) -> Tuple[_Graph, float, int]:
    """Capture ``step_fn(inputs)`` over ``n`` packed int32 inputs into the
    memory ``pool``: (the graph, host seconds, pool bytes it reserved).
    Capture records without running, so the cache is not written; the
    launch counts its wrappers made are taken back and kept as the graph's
    count per replay."""
    inputs = torch.zeros(n, dtype=torch.int32, device=device)
    graph = torch.cuda.CUDAGraph()
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    stream = torch.cuda.current_stream(device)
    t = time.perf_counter()
    try:
        with torch.cuda.graph(graph, pool=pool):
            out = step_fn(inputs)
    except Exception as e:
        # a capture that fails to end leaves its side stream current
        torch.cuda.set_stream(stream)
        e.add_note(f"while capturing {what}")
        raise
    finally:
        launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        for k, m in launches.items():
            kernels.LAUNCHES[k] -= m
    seconds = time.perf_counter() - t
    pool_bytes = torch.cuda.memory_reserved(device) - reserved
    return (_Graph(graph, inputs, out,
                   {k: m for k, m in launches.items() if m}),
            seconds, pool_bytes)


def _replay(g: _Graph, staged: torch.Tensor):
    """Copy the staged inputs into the graph's own, replay it and count
    its launches."""
    g.inputs.copy_(staged, non_blocking=True)
    g.graph.replay()
    for name, n in g.launches.items():
        kernels.LAUNCHES[name] += n
    return g.out


def _ceil4(n: int) -> int:
    return -(-n // 4) * 4


def _device_temps(eng, temps: np.ndarray):
    """(``temps`` on the device, whether any row samples): the temperatures
    go through ``eng._host_temps`` (pinned on a CUDA device) only when some
    row samples, else None."""
    if not (temps > 0).any():
        return None, False
    n = len(temps)
    eng._host_temps.numpy()[:n] = temps
    return eng._host_temps[:n].to(eng.device, non_blocking=True), True


def _sample(eng, lg: torch.Tensor, temps: np.ndarray,
            drops: Optional[torch.Tensor] = None) -> np.ndarray:
    """Tokens (host) sampled from the logits rows ``lg`` at ``temps``;
    ``eng._gen`` draws only when some row samples. ``drops`` (1,): the
    step's MoE drop count on the device, read in the same copy to the host
    and tracked (``_track_drops``)."""
    temps_t, any_sampled = _device_temps(eng, temps)
    toks = sample_tokens(lg, temps_t, eng._gen, any_sampled=any_sampled)
    if drops is None:
        return toks.cpu().numpy()
    host = torch.cat([toks, drops.to(toks.dtype)]).cpu().numpy()
    _track_drops(eng, int(host[-1]))
    return host[:-1]


def _emit(eng, req: Request, tok: int, lg_row: torch.Tensor) -> None:
    """Append a sampled token; keep its logits row with ``record_logits``."""
    req.generated.append(tok)
    if eng.record_logits:
        eng.sampled_logits.setdefault(req.uid, []).append(lg_row.clone())


# ---------------------------------------------------------------------------
# Dense oracle
# ---------------------------------------------------------------------------


class DenseServeEngine:
    """Slot-based continuous batching over a fixed dense decode arena.

    The equivalence oracle and the benchmark baseline: each request's
    prompt is prefilled whole (padded to a ``power_buckets`` width, pad
    tokens masked through ``chunk_lens``) and its cache row is copied into
    the arena at its slot; every tick then runs one decode step over all
    ``max_batch`` slots. KV takes ``max_batch x max_len`` whatever the live
    context. With ``record_logits=True`` the engine keeps, per request uid,
    the logits row each generated token was sampled from
    (``sampled_logits``). ``prefill_s``: host seconds spent in prefills,
    each ending in its first token's host read, so they hold the prefills'
    device time. On a CUDA device the decode step is one CUDA graph
    (module docstring)."""

    def __init__(self, cfg: ModelConfig, params, adapters: Sequence = (), *,
                 device: DeviceLike = None, max_batch: int = 8,
                 max_len: int = 512, exec_cfg: ExecConfig = ExecConfig(),
                 seed: int = 0, record_logits: bool = False):
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device != self.device:
            raise ValueError(f"params on {table.device}, engine on "
                             f"{self.device}")
        self.cfg, self.params = cfg, params
        # the oracle decodes one token per row and prefills whole prompts:
        # dropless makes the whole-prompt pass routing-identical to any
        # chunking of it
        self.ec = _force_moe_dispatch(exec_cfg, "dropless")
        self._has_moe = _has_moe(cfg)
        self.moe_dropped_tokens = 0
        # the last step's drop count, written on the device by the step
        self._drops = torch.zeros(1, device=self.device)
        self.max_batch, self.max_len = max_batch, max_len
        self.adapters = (lora_lib.stack_adapters(list(adapters))
                         if adapters else None)
        self.cache = kvcache.init_cache(cfg, max_batch, max_len,
                                        device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)
        # every slot's cache length as the arena holds it: an idle slot's
        # row keeps decoding (its tokens are dropped), a position a tick
        self._cache_len = np.zeros(max_batch, np.int64)
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.prefill_buckets = power_buckets(max_len)
        self._prefill_sigs: Set[int] = set()
        self._graph: Optional[_Graph] = None
        self.replays = 0
        self.capture_s = 0.0
        self.graph_pool_bytes = 0
        # the decode step's packed int32 inputs (tokens, positions, adapter
        # ids; each part on 16 bytes) and the temperatures, staged in
        # pinned host memory on a CUDA device
        pin = self.device.type == "cuda"
        self._host = torch.zeros(3 * _ceil4(max_batch), dtype=torch.int32,
                                 pin_memory=pin)
        self._host_temps = torch.zeros(max_batch, dtype=torch.float32,
                                       pin_memory=pin)
        if pin:
            self._graph_pool = torch.cuda.graph_pool_handle()
            # a sliding layer's ring (at most max_len slots) needs no
            # more than the full layers' cache: a split grows with S
            tfm.reserve_workspaces(cfg, params, self.ec, self.device,
                                   rows=max_batch, chunks=(1,),
                                   kv_lens=(max_len,))
        self._tick = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self.prefill_s = 0.0
        self.record_logits = record_logits
        self.sampled_logits: Dict[int, List[torch.Tensor]] = {}

    # ------------------------------------------------------------------
    def _prefill(self, slot: int, req: Request
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Whole-prompt forward of ``req``, padded to its bucket; its cache
        row is copied into the arena at ``slot``, in place. Returns the
        last real position's logits (1, V) and the MoE drop count (1,)."""
        plen = len(req.prompt)
        padded = bucketize(plen, self.prefill_buckets)
        self._prefill_sigs.add(padded)
        toks = np.zeros((1, padded), np.int32)
        toks[0, :plen] = np.asarray(req.prompt, np.int32)
        dev = self.device
        idx = (torch.tensor([req.adapter_id], device=dev)
               if self.adapters is not None else None)
        logits, row, aux = tfm.forward(
            self.cfg, self.params, {"tokens": torch.from_numpy(toks).to(dev)},
            lora=self.adapters,
            positions=torch.arange(padded, dtype=torch.int32,
                                   device=dev)[None],
            mode="prefill", prefill_cache_len=self.max_len, exec_cfg=self.ec,
            adapter_idx=idx,
            chunk_lens=torch.tensor([plen], dtype=torch.int32, device=dev),
            last_idx=torch.tensor([plen - 1], device=dev))
        # every leaf is (n_sp, B, ...): the request's row (B = 1) goes to
        # the arena's row ``slot``
        for entry, new in zip(self.cache["layers"], row["layers"]):
            for name, leaf in entry.items():
                leaf[:, slot].copy_(new[name][:, 0])
        self.prefill_tokens += plen
        return logits[:, 0], aux["moe_dropped_tokens"].reshape(1)

    def _decode_fn(self, inputs: torch.Tensor) -> torch.Tensor:
        """One decode step of every slot over packed ``inputs``: writes the
        arena in place and returns the logits (B, V). No host work depends
        on the values, so a CUDA graph captures it whole."""
        B, o = self.max_batch, _ceil4(self.max_batch)
        tokens = inputs[:B].view(B, 1)
        positions = inputs[o:o + B].view(B, 1)
        adapter_idx = (inputs[2 * o:2 * o + B].long()
                       if self.adapters is not None else None)
        logits, _, aux = tfm.forward(
            self.cfg, self.params, {"tokens": tokens}, lora=self.adapters,
            cache=self.cache, positions=positions, mode="decode",
            exec_cfg=self.ec, adapter_idx=adapter_idx)
        if self._has_moe:
            self._drops.copy_(aux["moe_dropped_tokens"].reshape(1))
        return logits[:, -1]

    def _eager(self, staged: torch.Tensor) -> torch.Tensor:
        return self._decode_fn(staged.to(self.device, non_blocking=True))

    def _replay(self, staged: torch.Tensor) -> torch.Tensor:
        """The decode step by its CUDA graph; the first decode tick runs
        eagerly and then captures the graph."""
        if self._graph is None:
            lg = self._eager(staged)
            self._graph, sec, nbytes = _capture(
                self.device, self._graph_pool, self._decode_fn,
                staged.numel(), "the dense decode step")
            self.capture_s += sec
            self.graph_pool_bytes += nbytes
            return lg
        self.replays += 1
        return _replay(self._graph, staged)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        _validate_request(req, self.max_len)
        self.queue.append(req)

    def _admit(self) -> None:
        for i in range(self.max_batch):
            if self.slot_req[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[i] = req
                t = time.perf_counter()
                lg, drops = self._prefill(i, req)
                tok = int(_sample(
                    self, lg, np.asarray([req.temperature], np.float32),
                    drops if self._has_moe else None)[0])
                self.prefill_s += time.perf_counter() - t
                _emit(self, req, tok, lg[0])
                self.slot_pos[i] = self._cache_len[i] = len(req.prompt)

    def step(self) -> None:
        """One engine tick: admit queued requests, run one batched decode
        step for every slot (a graph replay on a CUDA device), retire
        finished requests."""
        self._tick += 1
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return
        B, o = self.max_batch, _ceil4(self.max_batch)
        host = self._host.numpy()
        host[:B] = [r.generated[-1] if r is not None and r.generated else 0
                    for r in self.slot_req]
        host[o:o + B] = self.slot_pos
        host[2 * o:2 * o + B] = [r.adapter_id if r is not None else 0
                                 for r in self.slot_req]
        temps = np.asarray([r.temperature if r is not None else 0.0
                            for r in self.slot_req], np.float32)
        # an idle row about to pass the arena's end starts again at 0 (in
        # place, between ticks), so a full row stays a caller's error
        full = [i for i in range(B) if self.slot_req[i] is None
                and self._cache_len[i] >= self.max_len]
        if full:
            for entry in self.cache["layers"]:
                if "len" in entry:
                    entry["len"][:, full] = 0
            self._cache_len[full] = 0
        run = self._replay if self.device.type == "cuda" else self._eager
        lg = run(self._host)
        self._cache_len += 1
        toks_np = _sample(self, lg, temps,
                          self._drops if self._has_moe else None)
        for i in active:
            req = self.slot_req[i]
            self.slot_pos[i] += 1
            self.decode_tokens += 1
            tok = int(toks_np[i])
            _emit(self, req, tok, lg[i])
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if (len(req.generated) >= req.max_new_tokens or hit_eos
                    or self.slot_pos[i] >= self.max_len - 1):
                req.done = True
                req.finish_reason = "eos" if hit_eos else "length"
                self.finished[req.uid] = req
                self.slot_req[i] = None
                self.slot_pos[i] = 0

    def run_until_done(self, max_ticks: int = 10_000) -> Dict[int, Request]:
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.step()
        return self.finished

    def drain(self, max_ticks: int = 10_000) -> Dict[int, Completion]:
        self.run_until_done(max_ticks)
        return {uid: completion_of(r) for uid, r in self.finished.items()}

    def stats(self) -> EngineStats:
        return EngineStats(
            engine="dense", ticks=self._tick,
            decode_tokens=self.decode_tokens,
            prefill_tokens=self.prefill_tokens,
            compile=CompileStats(
                prefill_signatures=tuple(sorted(self._prefill_sigs)),
                compiled_steps=int(self._graph is not None),
                replays=self.replays, capture_ms=1e3 * self.capture_s,
                graph_pool_bytes=self.graph_pool_bytes),
            moe=MoEStats(enabled=self._has_moe, dispatch=self.ec.moe_dispatch,
                         dropped_tokens=self.moe_dropped_tokens),
            kv_bytes=kvcache.cache_bytes(self.cache))


# ---------------------------------------------------------------------------
# Paged engine
# ---------------------------------------------------------------------------


class PagedServeEngine:
    """Continuous batching over a paged, prefix-shared KV arena with
    chunked prefill.

    Every tick runs ONE mixed step over all ``max_slots`` rows: rows
    mid-prompt consume a chunk of up to ``prefill_chunk`` tokens, decoding
    rows consume their last sampled token, idle rows are masked out via
    ``chunk_lens == 0``. With ``record_logits=True`` the engine keeps, per
    request uid, the logits row each generated token was sampled from
    (``sampled_logits``), so a caller can hold them against a reference.
    On a CUDA device each tick replays the graph of its (chunk, table)
    signature (module docstring).

    Speculative decoding (``spec``: a ``SpecConfig`` or a drafter name)
    widens each decoding row to ``[t0, d1..dm]`` with up to ``k`` drafts;
    the verify step scores them and the rejected suffix rolls back. On
    rwkv6-7b the per-slot state is snapshotted inside the verify step and
    restored per slot on a rejection; the cursor then rewinds to the
    pre-chunk length and the accepted tokens replay as a resumed prefill
    chunk next tick, which rebuilds the state token-exactly.
    Full-attention models roll back by the cursor alone."""

    def __init__(self, cfg: ModelConfig, params, adapters: Sequence = (), *,
                 device: DeviceLike = None, max_slots: int = 16,
                 max_len: int = 512, page_size: int = 16,
                 num_pages: Optional[int] = None, prefill_chunk: int = 32,
                 enable_prefix_cache: bool = True, spec=None, parallel=None,
                 prefix_cache_path: Optional[str] = None,
                 moe_dispatch: str = "dropless",
                 exec_cfg: ExecConfig = ExecConfig(), seed: int = 0,
                 record_logits: bool = False):
        if parallel is not None and getattr(parallel, "tp", 1) > 1:
            raise NotImplementedError("tensor-parallel serving is not ported "
                                      "yet (ROADMAP Queue 1 item 16)")
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device != self.device:
            raise ValueError(f"params on {table.device}, engine on "
                             f"{self.device}")
        self.cfg, self.params = cfg, params
        # dropless (default): every serving row (prefill chunk, decode row,
        # spec-verify tail) routes MoE tokens drop-free; "capacity" only as
        # a benchmark baseline
        self.ec = exec_cfg = _force_moe_dispatch(exec_cfg, moe_dispatch)
        self._has_moe = _has_moe(cfg)
        self.moe_dropped_tokens = 0
        self._drops = torch.zeros(1, device=self.device)
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        if num_pages is None:
            # default: half of a dense max_slots x max_len arena
            num_pages = max(max_slots * (-(-max_len // page_size)) // 2,
                            -(-max_len // page_size) + 1)
        self.layout = PagedLayout(page_size=page_size, num_pages=num_pages,
                                  max_slots=max_slots)
        self.adapters = (lora_lib.stack_adapters(list(adapters))
                         if adapters else None)
        self.cache = kvcache.init_paged_cache(cfg, self.layout, max_len,
                                              device=self.device)
        self.arena = kvcache.SlotStateArena(cfg)
        self.sched = PageScheduler(self.layout, max_len)
        full_attn_only = all(
            cfg.block_kind(pos) == "attn" and cfg.attn_kind(pos) == "full"
            for pos in range(scan_period(cfg)))
        self.prefix: Optional[PrefixIndex] = (
            PrefixIndex(self.sched.alloc, page_size)
            if enable_prefix_cache and full_attn_only else None)
        if self.prefix is not None:
            self.sched.reclaim = self.prefix.evict
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        pin = self.device.type == "cuda"
        if pin:
            self._graph_pool = torch.cuda.graph_pool_handle()
        # ---- speculative decoding (spec=None keeps the plain step) ----
        if isinstance(spec, str):
            spec = SpecConfig(drafter=spec)
        self.spec: Optional[SpecConfig] = spec
        self.drafter = None
        self._ckpt = None
        if spec is not None:
            self.drafter = spec_mod.make_drafter(
                cfg, params, self.adapters, spec, exec_cfg, max_slots,
                pool=self._graph_pool if pin else None)
            # the verify step's snapshot of the per-slot state: one set of
            # buffers that every verify graph copies into
            self._ckpt = self.arena.snapshot(self.cache)
        # verify chunks are 1 + k tokens wide: the chunk ladder takes them
        self.chunk_buckets = power_buckets(
            max(prefill_chunk, spec.k + 1 if spec is not None else 1))
        self.block_buckets = power_buckets(self.sched.max_blocks)
        self._signatures: Set[Tuple[int, int]] = set()
        self._graphs: Dict[Tuple[int, int], _Graph] = {}
        self.replays = 0
        self.capture_s = 0.0
        self.graph_pool_bytes = 0
        # pinned host staging of the packed inputs and of the temperatures
        _, most = _segments(max_slots, self.chunk_buckets[-1],
                            self.block_buckets[-1], spec is not None)
        self._host = torch.zeros(most, dtype=torch.int32, pin_memory=pin)
        self._host_temps = torch.zeros(max_slots, dtype=torch.float32,
                                       pin_memory=pin)
        if pin:
            # every signature's split workspaces, before any capture
            tfm.reserve_workspaces(
                cfg, params, exec_cfg, self.device, rows=max_slots,
                chunks=self.chunk_buckets,
                kv_lens=[nb * page_size for nb in self.block_buckets],
                ring_len=_ring_len(cfg, max_len))
        self._tick = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self.prefix_hit_tokens = 0
        self.prefix_hits = 0
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.rolled_back_tokens = 0
        self.spec_steps = 0
        self.record_logits = record_logits
        self.sampled_logits: Dict[int, List[torch.Tensor]] = {}
        # ---- prefix-cache persistence: load a saved index into the fresh
        # pool, in place (a missing file is a cold start)
        self.prefix_cache_path = prefix_cache_path
        self.prefix_loaded_pages = 0
        if prefix_cache_path is not None and self.prefix is None:
            warnings.warn("prefix_cache_path ignored: the prefix cache is "
                          "disabled on this engine", stacklevel=2)
        elif (prefix_cache_path is not None
                and os.path.exists(prefix_cache_path)):
            _, self.prefix_loaded_pages = self.prefix.load(
                prefix_cache_path, self.cache)

    # ------------------------------------------------------------------
    def _step_fn(self, inputs: torch.Tensor, C: int, nb: int) -> torch.Tensor:
        """The mixed forward over packed ``inputs`` (``_segments``): writes
        the pool and the per-slot state in place and returns the last
        position's logits (B, V). No host work depends on the values, so a
        CUDA graph captures it whole."""
        B = self.layout.max_slots
        seg, _ = _segments(B, C, nb)
        part = {k: inputs[o:o + n] for k, (o, n) in seg.items()}
        tokens = part["tokens"].view(B, C)
        block_table = part["table"].view(B, nb)
        lens, clens = part["lens"], part["clens"]
        adapter_idx = (part["adapter"].long() if self.adapters is not None
                       else None)
        positions = lens[:, None] + torch.arange(
            C, dtype=torch.int32, device=inputs.device)[None, :]
        paged = {"block_table": block_table, "lens": lens,
                 "chunk_lens": clens, "page_size": self.layout.page_size}
        last = torch.clamp(clens.long() - 1, 0, C - 1)
        logits, _, aux = tfm.forward(
            self.cfg, self.params, {"tokens": tokens}, lora=self.adapters,
            cache=self.cache, positions=positions, mode="decode",
            exec_cfg=self.ec, adapter_idx=adapter_idx, paged=paged,
            chunk_lens=clens, last_idx=last)
        if self._has_moe:
            self._drops.copy_(aux["moe_dropped_tokens"].reshape(1))
        return logits[:, 0]                                       # (B, V)

    def _spec_step_fn(self, inputs: torch.Tensor, C: int, nb: int):
        """The speculative verify step over packed ``inputs``: the same
        mixed forward as ``_step_fn`` (draft tokens ride in as the ragged
        tail of a decode row's chunk), preceded by a copy of the per-slot
        recurrent state into the engine's snapshot buffers (rwkv only),
        and ending at the logits of the positions the tick reads: a verify
        row's 0..J-1 (J = min(C, k + 1)), any other row's last position in
        column 0. Returns (logits (B, J, V), tokens (B, J), draft lengths
        (B,)), the latter two views of ``inputs``. No host work depends on
        the values, so a CUDA graph captures it whole.

        Pool KV needs no snapshot: a write at position j depends only on
        inputs <= j, so the cursor alone hides a rejected suffix."""
        B = self.layout.max_slots
        J = min(C, self.spec.k + 1)
        seg, _ = _segments(B, C, nb, spec=True)
        part = {k: inputs[o:o + n] for k, (o, n) in seg.items()}
        tokens = part["tokens"].view(B, C)
        block_table = part["table"].view(B, nb)
        lens, clens, dlens = part["lens"], part["clens"], part["dlens"]
        adapter_idx = (part["adapter"].long() if self.adapters is not None
                       else None)
        if self.arena.tracked:
            self.arena.snapshot(self.cache, self._ckpt)
        dev = inputs.device
        positions = lens[:, None] + torch.arange(
            C, dtype=torch.int32, device=dev)[None, :]
        paged = {"block_table": block_table, "lens": lens,
                 "chunk_lens": clens, "page_size": self.layout.page_size}
        first = torch.where(dlens > 0, torch.zeros_like(clens),
                            torch.clamp(clens - 1, min=0)).long()
        idx = torch.clamp(first[:, None] + torch.arange(J, device=dev)[None],
                          max=C - 1)
        logits, _, aux = tfm.forward(
            self.cfg, self.params, {"tokens": tokens}, lora=self.adapters,
            cache=self.cache, positions=positions, mode="decode",
            exec_cfg=self.ec, adapter_idx=adapter_idx, paged=paged,
            chunk_lens=clens, last_idx=idx)
        if self._has_moe:
            self._drops.copy_(aux["moe_dropped_tokens"].reshape(1))
        return logits, tokens[:, :J], dlens                  # (B, J, V)

    def _eager(self, sig: Tuple[int, int], staged: torch.Tensor):
        """Run the step of signature ``sig`` eagerly on the staged inputs."""
        return self._fn(staged.to(self.device, non_blocking=True), *sig)

    @property
    def _fn(self):
        """The step this engine runs: the verify step with ``spec``."""
        return self._step_fn if self.spec is None else self._spec_step_fn

    def _replay(self, sig: Tuple[int, int], staged: torch.Tensor):
        """Run the step of signature ``sig`` by its CUDA graph; its first
        tick runs eagerly and then captures the graph."""
        g = self._graphs.get(sig)
        if g is None:
            lg = self._eager(sig, staged)
            self._graphs[sig], sec, nbytes = _capture(
                self.device, self._graph_pool,
                lambda inputs: self._fn(inputs, *sig), staged.numel(),
                f"the {'verify' if self.spec else 'mixed'} step of "
                f"signature (C={sig[0]}, nb={sig[1]})")
            self.capture_s += sec
            self.graph_pool_bytes += nbytes
            return lg
        self.replays += 1
        return _replay(g, staged)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        _validate_request(req, self.max_len)
        if (self.layout.blocks_for(len(req.prompt) + 1)
                > self.layout.num_pages):
            raise ValueError(
                f"request uid={req.uid}: prompt of {len(req.prompt)} tokens "
                f"needs more pages than the pool holds "
                f"({self.layout.num_pages} pages of {self.layout.page_size})")
        self.queue.append(req)

    def _pending_donor(self, req: Request, matched: int) -> bool:
        """True when an active slot still mid-prefill shares more full
        pages of this prompt than the index resolves yet — admitting now
        would duplicate prefill the donor is about to register."""
        P = self.layout.page_size
        sched = self.sched
        for i in sched.active():
            st = sched.slots[i]
            if st.req.adapter_id != req.adapter_id:
                continue
            if int(sched.lens[i]) >= _stream_len(st.req):
                continue                      # donor already decoding
            common = 0
            for a, b in zip(req.prompt, st.req.prompt):
                if int(a) != int(b):
                    break
                common += 1
            if (common // P) * P > matched:
                return True
        return False

    def _admit(self) -> None:
        fresh = []
        while self.queue:
            req = self.queue[0]
            shared = None
            if self.prefix is not None:
                stream = _stream(req)
                # always leave >= 1 token to prefill: the last stream
                # token's logits seed the next sample
                matched, spages = self.prefix.lookup(
                    req.adapter_id, stream[:_stream_len(req) - 1])
                if matched:
                    shared = (matched, spages)
                if self._pending_donor(req, matched):
                    break
            slot = self.sched.admit(req, _stream_len(req), self._tick,
                                    shared=shared)
            if slot is None:
                if not self.sched.active():
                    raise RuntimeError(
                        f"request uid={req.uid} needs more pages than the "
                        f"pool holds ({self.layout.num_pages} pages of "
                        f"{self.layout.page_size})")
                break
            self.queue.pop(0)
            fresh.append(slot)
            if shared:
                self.prefix_hit_tokens += shared[0]
                self.prefix_hits += 1
        # a recycled slot carries the last request's recurrent state: zero
        # it so nothing leaks into the fresh (or readmitted) request
        self.arena.reset(self.cache, fresh)

    def _run_forks(self) -> None:
        """Execute queued copy-on-write page copies on the device before
        the mixed step writes into the forked pages."""
        forks = [(s, d) for _, s, d in self.sched.take_forks()]
        if not forks:
            return
        src = torch.as_tensor([f[0] for f in forks], device=self.device)
        dst = torch.as_tensor([f[1] for f in forks], device=self.device)
        kvcache.fork_pages(self.cache, src, dst)

    def _register_progress(self, slot: int) -> None:
        """Index every COMPLETED full prompt page of a mid-prefill slot so
        same-prefix requests admitted next tick share them immediately."""
        st = self.sched.slots[slot]
        req = st.req
        n_done = min(int(self.sched.lens[slot]), len(req.prompt)) \
            // self.layout.page_size
        if n_done:
            self.prefix.register(req.adapter_id,
                                 req.prompt[:n_done * self.layout.page_size],
                                 st.pages[:n_done], self._tick)

    def _propose_drafts(self, active: Sequence[int],
                        phase: Dict[int, str]) -> Dict[int, np.ndarray]:
        """Ask the drafter for up to k tokens per decoding slot.

        Per-slot caps keep the verified run inside both budgets: appending
        ``accepted + 1 <= cap + 1`` tokens can neither exceed the request's
        ``max_new_tokens`` nor push the cache past ``max_len - 1``, so a
        request finishes on the token it would under plain decode. The
        drafter is always called with the full ``spec.k`` (one signature);
        the caps truncate here."""
        sched = self.sched
        cand, streams, aids, caps = [], [], [], []
        for i in active:
            if phase[i] != "decode":
                continue
            req = sched.slots[i].req
            cap = min(self.spec.k,
                      req.max_new_tokens - len(req.generated) - 1,
                      self.max_len - 2 - int(sched.lens[i]))
            if cap <= 0:
                continue
            cand.append(i)
            caps.append(cap)
            streams.append(np.concatenate([
                np.asarray(req.prompt, np.int32),
                np.asarray(req.generated, np.int32)]))
            aids.append(req.adapter_id)
        if not cand:
            return {}
        props = self.drafter.propose(streams, aids, self.spec.k)
        return {i: np.asarray(d, np.int32)[:cap]
                for i, cap, d in zip(cand, caps, props)
                if np.asarray(d).size}

    def _retire(self, i: int, reason: str) -> None:
        """Finish slot ``i``'s request; donate its partial prompt-tail page
        to the index (later sharers fork it copy-on-write at divergence)."""
        st = self.sched.slots[i]
        req = st.req
        req.done = True
        req.finish_reason = reason
        self.finished[req.uid] = req
        if (self.prefix is not None
                and len(req.prompt) % self.layout.page_size):
            self.prefix.register_tail(
                req.adapter_id, req.prompt,
                st.pages[len(req.prompt) // self.layout.page_size],
                self._tick)
        self.sched.release(i)

    def _advance_spec(self, i: int, m: int, emit_row: np.ndarray, n: int,
                      lg_rows: torch.Tensor) -> None:
        """Settle one decode slot after a verified tick: move the write
        cursor to ``L + accepted + 1``, free pages past it (rejected
        drafts), and append the emitted tokens in order (``lg_rows[t]`` is
        token t's logits row): eos / max_new / length-cap checks fire on
        the token they would under one-at-a-time decode.

        With per-slot recurrent state a rejection cannot be settled by a
        partial rewind: the state was restored to the pre-chunk snapshot,
        so the cursor rewinds to ``L`` and the ``n`` accepted tokens
        re-enter next tick as a resumed prefill chunk (they are in the
        stream already: ``[generated[-1], emit_0..emit_{n-2}]``)."""
        sched = self.sched
        req = sched.slots[i].req
        L = int(sched.lens[i])
        self.accepted_tokens += n - 1
        self.rolled_back_tokens += m - (n - 1)
        if m and n <= m and self.arena.tracked:
            sched.rollback(i, L, recurrent=True)
        elif m:
            sched.rollback(i, L + n)
        else:
            sched.lens[i] = L + n           # plain decode row: n == 1
        done = None
        for t in range(n):
            tok = int(emit_row[t])
            _emit(self, req, tok, lg_rows[t])
            self.decode_tokens += 1
            if req.eos_id is not None and tok == req.eos_id:
                done = "eos"
                break
            if len(req.generated) >= req.max_new_tokens:
                done = "length"
                break
        # cap on the SETTLED position L + n: a recurrent rollback rewinds
        # lens to L for the replay, but the request has used L + n
        if done is None and L + n >= self.max_len - 1:
            done = "length"
        if done is not None:
            self._retire(i, done)

    def step(self) -> None:
        """One tick: admit, resolve CoW forks, build a mixed ragged chunk,
        run the step (a graph replay on a CUDA device), advance lengths,
        sample/retire."""
        self._advance(self._replay if self.device.type == "cuda"
                      else self._eager)

    def _advance(self, run) -> None:
        """One tick, with ``run(signature, staged_inputs) -> logits`` as
        the step (``_replay`` or ``_eager``)."""
        self._tick += 1
        self._admit()
        sched = self.sched
        active = sched.active()
        if not active:
            return
        B = self.layout.max_slots

        # ---- per-slot chunk widths
        want = np.zeros(B, np.int32)
        phase: Dict[int, str] = {}
        for i in active:
            st = sched.slots[i]
            remaining = _stream_len(st.req) - int(sched.lens[i])
            if remaining > 0:
                want[i] = min(remaining, self.prefill_chunk)
                phase[i] = "prefill"
            else:
                want[i] = 1
                phase[i] = "decode"

        # ---- speculative drafts widen decode rows to 1 + m tokens
        drafts: Dict[int, np.ndarray] = {}
        if self.spec is not None:
            drafts = self._propose_drafts(active, phase)
            for i, d in drafts.items():
                want[i] = 1 + d.size

        # ---- page capacity (oldest slots are protected; pool pressure
        # reclaims prefix-cache pages first, then preempts the youngest,
        # which requeues for recompute). ensure() also forks any shared
        # page inside this tick's write range (copy-on-write).
        protected: List[int] = []
        for i in sorted(active, key=lambda j: sched.slots[j].admitted_tick):
            if sched.slots[i] is None:      # preempted as someone's victim
                continue
            sched.ensure(i, int(sched.lens[i]) + int(want[i]),
                         protect=protected + [i])
            if sched.slots[i] is not None:
                protected.append(i)
        for req in reversed(sched.drain_evicted()):
            if (self.layout.blocks_for(_stream_len(req) + 1)
                    > self.layout.num_pages):
                # the stream has outgrown the entire pool — retire at
                # capacity, mirroring a dense engine's max_len cut-off
                req.done = True
                req.finish_reason = "capacity"
                self.finished[req.uid] = req
            else:
                self.queue.insert(0, req)
        active = sched.active()
        if not active:
            return
        self._run_forks()

        # ---- assemble the mixed batch
        C = bucketize(int(max(want[i] for i in active)), self.chunk_buckets)
        tokens = np.zeros((B, C), np.int32)
        clens = np.zeros(B, np.int32)
        dlens = np.zeros(B, np.int32)
        for i in active:
            st = sched.slots[i]
            if phase[i] == "prefill":
                stream = _stream(st.req)
                L = int(sched.lens[i])
                chunk = stream[L:L + int(want[i])]
                tokens[i, :len(chunk)] = chunk
                clens[i] = len(chunk)
            else:
                tokens[i, 0] = st.req.generated[-1]
                clens[i] = 1
                d = drafts.get(i)
                if d is not None:
                    # verify chunk [t0, d1..dm]: the distribution at index
                    # j scores the draft at j + 1
                    tokens[i, 1:1 + d.size] = d
                    clens[i] = 1 + d.size
                    dlens[i] = d.size
                    self.drafted_tokens += int(d.size)
        assert clens.any(), "an active tick writes at least one token"
        nb = bucketize(sched.blocks_in_use(active, clens), self.block_buckets)
        adapter = [(sched.slots[i].req.adapter_id if sched.slots[i] else 0)
                   for i in range(B)]
        spec = self.spec is not None
        seg, n = _segments(B, C, nb, spec)
        host = self._host.numpy()
        for name, arr in (("tokens", tokens), ("lens", sched.lens),
                          ("clens", clens), ("table", sched.tables[:, :nb]),
                          ("adapter", adapter), ("dlens", dlens)):
            if name in seg:
                o, m = seg[name]
                host[o:o + m] = np.asarray(arr).reshape(-1)
        temps = np.asarray([(sched.slots[i].req.temperature
                             if sched.slots[i] else 0.0) for i in range(B)],
                           np.float32)
        self._signatures.add((C, nb))
        out = run((C, nb), self._host[:n])
        emit_np = n_emit_np = None
        drops = self._drops if self._has_moe else None
        if not spec:
            lg = out
            toks_np = _sample(self, lg, temps, drops)
        else:
            # acceptance, then the per-slot restore in place (a slot keeps
            # its post-chunk state only without drafts or with all of them
            # accepted), then one read of the results
            self.spec_steps += 1
            lg_v, tok_v, dl_v = out
            temps_t, any_sampled = _device_temps(self, temps)
            emit, n_emit = spec_mod.verify_accept(
                lg_v, tok_v, dl_v, temps_t, self._gen,
                any_sampled=any_sampled)
            if self.arena.tracked:
                self.arena.restore(self.cache, self._ckpt,
                                   (dl_v == 0) | (n_emit > dl_v))
            both = torch.cat([emit, n_emit[:, None]], dim=1)
            flat = both.reshape(-1)
            if drops is not None:
                flat = torch.cat([flat, drops.to(flat.dtype)])
            host = flat.cpu().numpy()
            if drops is not None:
                _track_drops(self, int(host[-1]))
            host = host[:both.numel()].reshape(both.shape)
            emit_np, n_emit_np = host[:, :-1], host[:, -1]
            toks_np = emit_np[:, 0]         # rows without drafts: column 0
            lg = lg_v[:, 0]

        # ---- advance + sample + retire
        for i in active:
            st = sched.slots[i]
            req = st.req
            if phase[i] == "decode" and spec:
                self._advance_spec(i, int(dlens[i]), emit_np[i],
                                   int(n_emit_np[i]), lg_v[i])
                continue
            sched.lens[i] += int(clens[i])
            if phase[i] == "decode":
                self.decode_tokens += 1
                _emit(self, req, int(toks_np[i]), lg[i])
            else:
                self.prefill_tokens += int(clens[i])
                if self.prefix is not None:
                    self._register_progress(i)
                if sched.lens[i] < _stream_len(req):
                    continue                    # mid-prompt
                if not req.generated:           # fresh prefill done
                    _emit(self, req, int(toks_np[i]), lg[i])
                # else: resumed prefill done — next tick decodes generated[-1]
            tok = req.generated[-1]
            hit_eos = req.eos_id is not None and tok == req.eos_id
            # the length cut-off only applies after a decode write
            len_cap = (phase[i] == "decode"
                       and int(sched.lens[i]) >= self.max_len - 1)
            if len(req.generated) >= req.max_new_tokens or hit_eos or len_cap:
                self._retire(i, "eos" if hit_eos else "length")

    def run_until_done(self, max_ticks: int = 100_000) -> Dict[int, Request]:
        for _ in range(max_ticks):
            if not self.queue and not self.sched.active():
                break
            self.step()
        return self.finished

    def drain(self, max_ticks: int = 100_000) -> Dict[int, Completion]:
        self.run_until_done(max_ticks)
        return {uid: completion_of(r) for uid, r in self.finished.items()}

    def release_prefix_cache(self) -> int:
        """Drop every prefix-index page ref. Returns pages freed."""
        return self.prefix.clear() if self.prefix is not None else 0

    def save_prefix_cache(self, path: Optional[str] = None) -> int:
        """Write the prefix index (trie and page contents) so a later
        engine starts warm from it (``prefix_cache_path=``). Returns the
        number of pages written."""
        if self.prefix is None:
            raise ValueError("prefix cache is disabled on this engine")
        path = path or self.prefix_cache_path
        if path is None:
            raise ValueError("no path: pass save_prefix_cache(path) or "
                             "construct with prefix_cache_path=")
        return self.prefix.save(path, self.cache)

    def _spec_stats(self) -> SpecStats:
        if self.spec is None:
            return SpecStats(enabled=False)
        sigs = (self.drafter.stats() if hasattr(self.drafter, "stats")
                else None)
        return SpecStats(
            enabled=True, k=self.spec.k, drafter=self.spec.drafter,
            steps=self.spec_steps, drafted_tokens=self.drafted_tokens,
            accepted_tokens=self.accepted_tokens,
            rolled_back_tokens=self.rolled_back_tokens,
            recurrent_rollbacks=self.sched.recurrent_rollbacks,
            accept_rate=self.accepted_tokens / max(self.drafted_tokens, 1),
            draft_signatures=(tuple(tuple(g) for g in sigs["draft_signatures"])
                              if sigs else ()),
            draft_compiles=sigs["draft_compiles"] if sigs else None)

    def stats(self) -> EngineStats:
        occ = self.sched.occupancy()
        return EngineStats(
            engine="paged",
            ticks=self._tick,
            decode_tokens=self.decode_tokens,
            prefill_tokens=self.prefill_tokens,
            compile=CompileStats(
                step_signatures=tuple(sorted(self._signatures)),
                compiled_steps=len(self._graphs), replays=self.replays,
                capture_ms=1e3 * self.capture_s,
                graph_pool_bytes=self.graph_pool_bytes),
            scheduler=SchedulerStats(**occ),
            prefix_cache=PrefixCacheStats(
                enabled=self.prefix is not None,
                hit_tokens=self.prefix_hit_tokens,
                hits=self.prefix_hits,
                loaded_pages=self.prefix_loaded_pages,
                **(self.prefix.stats() if self.prefix is not None else {})),
            spec=self._spec_stats(),
            moe=MoEStats(enabled=self._has_moe, dispatch=self.ec.moe_dispatch,
                         dropped_tokens=self.moe_dropped_tokens))
