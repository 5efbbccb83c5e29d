"""Paged serving engine: continuous batching + multi-adapter LoRA decode
(PyTorch port of ``repro.serve.engine.PagedServeEngine``).

The paper's inference story (SS V.G): the frozen base lives on the device
(crossbar-quantized); switching tasks means swapping only LoRA adapters.
Here that becomes multi-tenant serving: adapters are stacked along axis 1
and every request carries an adapter id; one mixed step serves a batch of
prefill chunks and decode rows of different tasks.

Full-attention KV lives in a shared page pool addressed by per-request
block tables; RWKV state lives in per-slot rows. Prefill runs in chunks
padded to a small set of bucket widths; prefill chunks and decode rows run
through ONE mixed step per tick. Admission and eviction are decided by
page occupancy (``serve.scheduler``). ``forward`` updates the pool and the
per-slot state in place, so they carry across ticks in ``self.cache`` (the
JAX package donates them to its jitted step and takes the new ones back).
A slot is zeroed through ``SlotStateArena.reset`` whenever a request is
admitted to it. A radix prefix index (``serve.prefix``) maps new requests
onto already-resident pages; shared pages are forked copy-on-write before
their first divergent write. It serves full-attention models only: RWKV
state is relative to the whole stream and cannot be grafted across
requests.

On a CUDA device the mixed step runs as CUDA graphs, the port's
counterpart of the JAX package's ``jax.jit`` of the step: one graph per
(chunk bucket, table bucket) signature. A signature's first tick runs
eagerly (it is also the first use of each kernel at that shape), then the
step is captured without running it; every later tick with that signature
copies its inputs into the graph's own (from pinned host memory, without a
wait) and replays it. The graph ends at the last position's logits, and
sampling runs eagerly after it. All graphs share one memory pool; the
kernels' split workspaces are reserved for the largest step before any
capture. A capture that fails raises: nothing falls back to the eager
step. On the CPU (the tests) the step runs eagerly. Copy-on-write forks
and slot resets run eagerly between ticks, as they are rare (the JAX
package jits its forks by fork bucket). Speculative decoding, tensor
parallelism and prefix-cache persistence raise ``NotImplementedError``
(ROADMAP Queue 1 items 8, 10 and 16).
"""
from __future__ import annotations

import time
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
from repro_torch.serve.api import (Completion, CompileStats, EngineStats,
                                   PrefixCacheStats, Request, SchedulerStats,
                                   completion_of)
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.sampling import sample_tokens
from repro_torch.serve.scheduler import PageScheduler, bucketize, power_buckets


def _validate_request(req: Request, max_len: int) -> None:
    if len(req.prompt) == 0:
        raise ValueError(f"request uid={req.uid}: empty prompt")
    if len(req.prompt) + 1 > max_len:
        raise ValueError(f"request uid={req.uid}: prompt of "
                         f"{len(req.prompt)} tokens exceeds "
                         f"max_len={max_len}")


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
# 16 bytes (the alignment the flash kernels take): one copy a tick.
_PARTS = ("tokens", "lens", "clens", "table", "adapter")


def _segments(B: int, C: int, nb: int) -> Tuple[Dict[str, Tuple[int, int]],
                                                 int]:
    """(offset, length) of each part of the packed inputs, and their end."""
    out, o = {}, 0
    for name, n in zip(_PARTS, (B * C, B, B, B * nb, B)):
        out[name] = (o, n)
        o += -(-n // 4) * 4
    return out, o


@dataclass
class _Graph:
    """One captured mixed step: the packed inputs it reads, the logits it
    writes, and the kernel launches that one replay makes."""
    graph: "torch.cuda.CUDAGraph"
    inputs: torch.Tensor
    logits: torch.Tensor
    launches: Dict[str, int]


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
    signature (module docstring)."""

    def __init__(self, cfg: ModelConfig, params, adapters: Sequence = (), *,
                 device: DeviceLike = None, max_slots: int = 16,
                 max_len: int = 512, page_size: int = 16,
                 num_pages: Optional[int] = None, prefill_chunk: int = 32,
                 enable_prefix_cache: bool = True, spec=None, parallel=None,
                 prefix_cache_path: Optional[str] = None,
                 moe_dispatch: str = "dropless",
                 exec_cfg: ExecConfig = ExecConfig(), seed: int = 0,
                 record_logits: bool = False):
        if spec is not None:
            raise NotImplementedError("speculative decoding is not ported "
                                      "yet (ROADMAP Queue 1 item 10)")
        if parallel is not None and getattr(parallel, "tp", 1) > 1:
            raise NotImplementedError("tensor-parallel serving is not ported "
                                      "yet (ROADMAP Queue 1 item 16)")
        if prefix_cache_path is not None:
            raise NotImplementedError("prefix-cache persistence is not "
                                      "ported yet (ROADMAP Queue 1 item 8)")
        if moe_dispatch != "dropless":
            raise NotImplementedError("MoE dispatch modes are not ported yet "
                                      "(ROADMAP Queue 1 item 12)")
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device != self.device:
            raise ValueError(f"params on {table.device}, engine on "
                             f"{self.device}")
        self.cfg, self.params, self.ec = cfg, params, exec_cfg
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
        self.chunk_buckets = power_buckets(prefill_chunk)
        self.block_buckets = power_buckets(self.sched.max_blocks)
        self._signatures: Set[Tuple[int, int]] = set()
        self._graphs: Dict[Tuple[int, int], _Graph] = {}
        self.replays = 0
        self.capture_s = 0.0
        self.graph_pool_bytes = 0
        # pinned host staging of the packed inputs and of the temperatures
        pin = self.device.type == "cuda"
        _, most = _segments(max_slots, self.chunk_buckets[-1],
                            self.block_buckets[-1])
        self._host = torch.zeros(most, dtype=torch.int32, pin_memory=pin)
        self._host_temps = torch.zeros(max_slots, dtype=torch.float32,
                                       pin_memory=pin)
        if pin:
            self._graph_pool = torch.cuda.graph_pool_handle()
            # every signature's split workspaces, before any capture
            tfm.reserve_workspaces(
                cfg, params, exec_cfg, self.device, rows=max_slots,
                chunks=self.chunk_buckets, tables=self.block_buckets,
                page_size=page_size)
        self._tick = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self.prefix_hit_tokens = 0
        self.prefix_hits = 0
        self.record_logits = record_logits
        self.sampled_logits: Dict[int, List[torch.Tensor]] = {}

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
        logits, _, _ = tfm.forward(
            self.cfg, self.params, {"tokens": tokens}, lora=self.adapters,
            cache=self.cache, positions=positions, mode="decode",
            exec_cfg=self.ec, adapter_idx=adapter_idx, paged=paged,
            chunk_lens=clens, last_idx=last)
        return logits[:, 0]                                       # (B, V)

    def _eager(self, sig: Tuple[int, int], staged: torch.Tensor):
        """Run the step of signature ``sig`` eagerly on the staged inputs."""
        return self._step_fn(staged.to(self.device, non_blocking=True), *sig)

    def _replay(self, sig: Tuple[int, int], staged: torch.Tensor):
        """Run the step of signature ``sig`` by its CUDA graph; its first
        tick runs eagerly and then captures the graph."""
        g = self._graphs.get(sig)
        if g is None:
            lg = self._eager(sig, staged)
            self._graphs[sig] = self._capture(sig, staged.numel())
            return lg
        g.inputs.copy_(staged, non_blocking=True)
        g.graph.replay()
        self.replays += 1
        for name, n in g.launches.items():
            kernels.LAUNCHES[name] += n
        return g.logits

    def _capture(self, sig: Tuple[int, int], n: int) -> _Graph:
        """Capture the step of ``sig`` into the shared pool. Capture records
        without running, so the pool and the state are not written; the
        launch counts its wrappers made are taken back and kept as the
        graph's count per replay."""
        inputs = torch.zeros(n, dtype=torch.int32, device=self.device)
        graph = torch.cuda.CUDAGraph()
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        stream = torch.cuda.current_stream(self.device)
        t = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self._graph_pool):
                logits = self._step_fn(inputs, *sig)
        except Exception as e:
            # a capture that fails to end leaves its side stream current
            torch.cuda.set_stream(stream)
            e.add_note(f"while capturing the mixed step of signature "
                       f"(C={sig[0]}, nb={sig[1]})")
            raise
        finally:
            launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
            for k, m in launches.items():
                kernels.LAUNCHES[k] -= m
        self.capture_s += time.perf_counter() - t
        self.graph_pool_bytes += (torch.cuda.memory_reserved(self.device)
                                  - reserved)
        return _Graph(graph, inputs, logits,
                      {k: m for k, m in launches.items() if m})

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

    def _emit(self, req: Request, tok: int, lg_row: torch.Tensor) -> None:
        req.generated.append(tok)
        if self.record_logits:
            self.sampled_logits.setdefault(req.uid, []).append(lg_row.clone())

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
        assert clens.any(), "an active tick writes at least one token"
        nb = bucketize(sched.blocks_in_use(active, clens), self.block_buckets)
        adapter = [(sched.slots[i].req.adapter_id if sched.slots[i] else 0)
                   for i in range(B)]
        seg, n = _segments(B, C, nb)
        host = self._host.numpy()
        for name, arr in (("tokens", tokens), ("lens", sched.lens),
                          ("clens", clens), ("table", sched.tables[:, :nb]),
                          ("adapter", adapter)):
            o, m = seg[name]
            host[o:o + m] = np.asarray(arr).reshape(-1)
        temps = np.asarray([(sched.slots[i].req.temperature
                             if sched.slots[i] else 0.0) for i in range(B)],
                           np.float32)
        self._signatures.add((C, nb))
        lg = run((C, nb), self._host[:n])
        any_sampled = bool((temps > 0).any())
        temps_t = None
        if any_sampled:
            self._host_temps.numpy()[:] = temps
            temps_t = self._host_temps.to(self.device, non_blocking=True)
        toks_np = sample_tokens(lg, temps_t, self._gen,
                                any_sampled=any_sampled).cpu().numpy()

        # ---- advance + sample + retire
        for i in active:
            st = sched.slots[i]
            req = st.req
            sched.lens[i] += int(clens[i])
            if phase[i] == "decode":
                self.decode_tokens += 1
                self._emit(req, int(toks_np[i]), lg[i])
            else:
                self.prefill_tokens += int(clens[i])
                if self.prefix is not None:
                    self._register_progress(i)
                if sched.lens[i] < _stream_len(req):
                    continue                    # mid-prompt
                if not req.generated:           # fresh prefill done
                    self._emit(req, int(toks_np[i]), lg[i])
                # else: resumed prefill done — next tick decodes generated[-1]
            tok = req.generated[-1]
            hit_eos = req.eos_id is not None and tok == req.eos_id
            # the length cut-off only applies after a decode write
            len_cap = (phase[i] == "decode"
                       and int(sched.lens[i]) >= self.max_len - 1)
            if len(req.generated) >= req.max_new_tokens or hit_eos or len_cap:
                req.done = True
                req.finish_reason = "eos" if hit_eos else "length"
                self.finished[req.uid] = req
                if (self.prefix is not None
                        and len(req.prompt) % self.layout.page_size):
                    # donate the partial prompt-tail page to the index —
                    # future sharers fork it copy-on-write at divergence
                    self.prefix.register_tail(
                        req.adapter_id, req.prompt,
                        st.pages[len(req.prompt) // self.layout.page_size],
                        self._tick)
                sched.release(i)

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
                **(self.prefix.stats() if self.prefix is not None else {})))
