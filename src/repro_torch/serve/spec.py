"""Speculative decoding over the paged mixed step (PyTorch port of
``repro.serve.spec``).

Draft-and-verify decoding turns memory-bound decode steps into
compute-dense verification: a cheap drafter guesses up to ``k`` tokens per
slot per tick, the target model scores all of them in ONE mixed step (the
draft enters as a ragged decode chunk ``[t0, d1..dm]``, so the step's
signatures stay (chunk bucket, table bucket) pairs), and rejected
positions rewind the slot's paged-KV write cursor
(``PageScheduler.rollback``).

Two drafters, both deterministic:

  * ``NGramDrafter`` — model-free prompt lookup: propose the continuation
    of the most recent earlier occurrence of the stream's longest matching
    suffix n-gram (host numpy, as in the JAX package).
  * ``QuantSelfDrafter`` — the target model with its weights quantized to
    ``draft_bits`` by ``core.quant.quantize_params`` (the paper's crossbar
    MnFm scheme as the draft model: its products run ``crossbar_matmul``
    in int4) over a short context window with relative positions, greedy
    for ``k`` steps. On a CUDA device each (context bucket, k) signature
    is one CUDA graph, captured after an eager first call (the JAX package
    jits it once per signature).

A deterministic drafter is a point-mass proposal ``q = delta_d``, so
rejection sampling accepts ``d`` with probability ``min(1, p(d))`` and on
rejection draws the correction from ``p`` with ``d`` masked out: the
emitted stream is distributed as the target model's. At temperature 0 it
is greedy exact match with an argmax correction, so spec-on tokens equal
plain greedy decoding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Protocol, Sequence, Set, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.serve.sampling import sample_tokens

_EMPTY = np.empty(0, np.int32)


@dataclass(frozen=True)
class SpecConfig:
    """Knobs for speculative decoding (``make_engine(..., spec=...)``).

    ``k`` trades drafter cost and verify width against steps saved: the
    expected tokens a tick is ``E[accepted] + 1``."""
    k: int = 4                     # max draft tokens per slot per tick
    drafter: str = "ngram"         # "ngram" | "selfdraft"
    # n-gram drafter: longest..shortest suffix length to look up
    ngram_max: int = 3
    ngram_min: int = 1
    # quantized self-draft: MnFm bits, crossbar block, context window
    draft_bits: int = 4
    draft_block: int = 128
    draft_ctx: int = 64
    draft_min_size: int = 1        # quantize every >=2D weight by default


# ---------------------------------------------------------------------------
# Acceptance rule
# ---------------------------------------------------------------------------


def _shift_right(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def verify_accept(logits: torch.Tensor, tokens: torch.Tensor,
                  draft_lens: torch.Tensor, temps,
                  generator=None, *, any_sampled: bool):
    """Score one verified chunk per row; decide accepts and the final token.

    logits (B, C, V) — target logits at the row's chunk positions 0..C-1
    tokens (B, C)    — the chunk ``[t0, d1..dm, pad]``: the last emitted
                       token followed by ``draft_lens[b] == m`` drafts
    draft_lens (B,)  — m (0 = a plain row: no drafts, just sample)
    temps (B,)       — per-row temperature (0 = greedy); not read when
                       ``any_sampled`` is False (the host knows it, as
                       for ``sample_tokens``), and then ``generator`` is
                       not drawn from

    The distribution at index ``j`` scores the draft at ``j+1``: greedy
    rows accept ``d_{j+1}`` iff it equals ``argmax(logits[:, j])``;
    temperature rows accept with probability ``p_j(d_{j+1})``. After the
    first rejection, or once all m drafts survive, ONE more token is drawn
    from the target distribution at that index (the rejected draft masked
    out, a no-op at temperature 0).

    Returns (emit (B, C) int32, n_emit (B,) int32): row b's first
    ``n_emit[b] == accepted + 1`` entries of ``emit`` are its new tokens,
    in order; rows without drafts emit the sample at index 0."""
    B, C, V = logits.shape
    lf = logits.to(torch.float32)
    dev = lf.device
    j = torch.arange(C, device=dev)[None, :]
    tokens = tokens.long()
    dl = draft_lens.long()
    greedy = torch.argmax(lf, dim=-1)                         # (B, C)
    # tok_next[b, t] = tokens[b, t+1]: the draft scored by index t's dist
    tok_next = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    # acceptance of the chunk token AT index t (a draft for t >= 1),
    # judged by the distribution at index t-1
    acc = tokens == _shift_right(greedy)
    if any_sampled:
        tl = torch.where(temps > 0, temps, torch.ones_like(temps))
        logp = torch.log_softmax(lf / tl[:, None, None], dim=-1)
        lp_next = torch.gather(logp, -1, tok_next[..., None])[..., 0]
        u = torch.rand((B, C), generator=generator, device=dev)
        u = u * (1.0 - 1e-30) + 1e-30
        acc_stoch = torch.log(u) < _shift_right(lp_next)
        acc = torch.where(temps[:, None] > 0, acc_stoch, acc)
    is_draft = (j >= 1) & (j <= dl[:, None])
    ok = torch.where(is_draft, acc, j == 0)   # col 0 free; past drafts: stop
    run = torch.cumprod(ok.to(torch.int32), dim=1)
    n_acc = run.sum(dim=1) - 1                # leading accepts, in [0, m]

    # final token at index n_acc: a bonus sample when every draft survived,
    # the masked-residual correction at the first rejection
    rows = torch.arange(B, device=dev)
    lg_fin = lf[rows, n_acc]                                  # (B, V)
    d_rej = tok_next[rows, n_acc]
    forbid = torch.where(n_acc < dl, d_rej, torch.full_like(d_rej, -1))
    fin = sample_tokens(lg_fin, temps, generator, any_sampled=any_sampled,
                        forbid=forbid)
    emit = torch.where(j < n_acc[:, None], tok_next,
                       torch.where(j == n_acc[:, None], fin[:, None],
                                   torch.zeros_like(tok_next)))
    return emit.to(torch.int32), (n_acc + 1).to(torch.int32)


# ---------------------------------------------------------------------------
# Drafters
# ---------------------------------------------------------------------------


@runtime_checkable
class Drafter(Protocol):
    """Pluggable draft-token source. MUST be deterministic (a point-mass
    proposal): the acceptance rule in ``verify_accept`` relies on it."""

    def propose(self, streams: Sequence[np.ndarray],
                adapter_ids: Sequence[int], k: int) -> List[np.ndarray]:
        """Per-slot draft continuations. ``streams[i]`` is the slot's full
        token stream (prompt + generated); returns one int32 array of up
        to ``k`` proposed next tokens per slot (possibly empty)."""
        ...


class NGramDrafter:
    """Model-free prompt-lookup drafting.

    Finds the longest suffix n-gram (``max_n`` down to ``min_n``) of the
    stream that also occurs earlier, takes the MOST RECENT earlier
    occurrence, and proposes the tokens that followed it."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        assert 1 <= min_n <= max_n
        self.max_n, self.min_n = max_n, min_n

    def propose(self, streams, adapter_ids, k):
        """Vectorized across slots: the streams are right-aligned into one
        left-padded (B, W) matrix (pad = -1, outside any vocabulary) and
        each suffix length ``n`` is resolved for the whole batch by one
        sliding-window comparison. Equals ``propose_ref`` (longest n
        first; the most recent hit wins)."""
        k = int(k)
        B = len(streams)
        if B == 0:
            return []
        lens = np.asarray([np.asarray(s).size for s in streams], np.int64)
        W = int(lens.max())
        if W < 2 or k <= 0:
            return [_EMPTY] * B
        pad = np.full((B, W), -1, np.int64)
        for b, s in enumerate(streams):
            if lens[b]:
                pad[b, W - lens[b]:] = np.asarray(s, np.int64)
        off = W - lens                       # padded index of token 0
        starts = np.full(B, -1, np.int64)    # continuation start, padded
        for n in range(min(self.max_n, W - 1), self.min_n - 1, -1):
            todo = (starts < 0) & (lens - 1 >= n)
            if not todo.any():
                if (starts >= 0).all():
                    break                    # every row resolved
                continue                     # shorter rows qualify lower
            wins = np.lib.stride_tricks.sliding_window_view(pad, n, axis=1)
            patt = pad[:, W - n:]            # the suffix n-gram per row
            eq = (wins == patt[:, None, :]).all(axis=-1)   # (B, W-n+1)
            j = np.arange(W - n + 1, dtype=np.int64)[None, :]
            # the window lies inside the row's real tokens minus the last
            # one (the reference searches s[:T-1])
            eq &= (j >= off[:, None]) & (j + n <= W - 1)
            hit = todo & eq.any(axis=1)
            if hit.any():
                last = (W - n) - np.argmax(eq[:, ::-1], axis=1)
                starts[hit] = last[hit] + n
        return [pad[b, starts[b]:starts[b] + k].astype(np.int32)
                if starts[b] >= 0 else _EMPTY for b in range(B)]

    def propose_ref(self, streams, adapter_ids, k):
        """The per-slot host loop, kept as the vectorization's oracle."""
        return [self._one(np.asarray(s, np.int64), int(k)) for s in streams]

    def _one(self, s: np.ndarray, k: int) -> np.ndarray:
        T = s.size
        if T < 2 or k <= 0:
            return _EMPTY
        for n in range(min(self.max_n, T - 1), self.min_n - 1, -1):
            pat = s[T - n:]
            wins = np.lib.stride_tricks.sliding_window_view(s[:T - 1], n)
            hits = np.nonzero((wins == pat[None, :]).all(axis=1))[0]
            if hits.size:
                start = int(hits[-1]) + n
                return s[start:start + k].astype(np.int32)
        return _EMPTY


class QuantSelfDrafter:
    """Self-drafting with the paper's compression scheme as the drafter.

    The TARGET model's weights are quantized to ``draft_bits`` by
    ``core.quant.quantize_params`` (crossbar MnFm blocks; the LoRA adapters
    ride on top unquantized) and run greedily over the last ``draft_ctx``
    tokens with RELATIVE positions: one draft call a tick drafts ``k``
    tokens for every decoding slot at once, a prefill forward of the
    context into a dense cache of ``W + k`` positions and then ``k - 1``
    decode forwards. The batch is pinned to ``max_rows`` rows and the
    context width bucketed, so the signatures are (context bucket, k),
    O(log draft_ctx) of them. On a CUDA device each signature is one CUDA
    graph in ``pool`` (or a pool of its own), captured after its eager
    first call; on the CPU the draft runs eagerly.

    The base must be unquantized: the JAX package's ``quantize_params``
    fails on ``QuantizedTensor`` leaves, and the port's would leave them
    as they are (a drafter at the base's bits), so the port raises
    ``ValueError`` instead."""

    def __init__(self, cfg, params, adapters, spec: SpecConfig, exec_cfg,
                 max_rows: int, *, pool=None):
        from repro_torch.configs.base import QuantConfig
        from repro_torch.core.quant import quantize_params
        from repro_torch.models import transformer as tfm
        from repro_torch.serve.engine import _ceil4
        from repro_torch.serve.scheduler import power_buckets
        if any(True for _ in tfm._quantized(params)):
            raise ValueError(
                "QuantSelfDrafter quantizes the target's weights to "
                f"draft_bits={spec.draft_bits} itself and cannot take a "
                "base that already holds QuantizedTensor leaves (the JAX "
                "package's quantize_params fails on one); serve the "
                "self-drafter over an unquantized base, or use "
                "drafter='ngram'")
        qc = QuantConfig(mha_bits=spec.draft_bits, ff_bits=spec.draft_bits,
                         block=spec.draft_block)
        self.qparams = quantize_params(params, qc,
                                       min_size=spec.draft_min_size)
        self.cfg, self.ec = cfg, exec_cfg
        self.adapters = adapters            # stacked, or None
        self.draft_ctx = spec.draft_ctx
        self.max_rows = max_rows
        self.ctx_buckets = power_buckets(spec.draft_ctx)
        self.device = params["embed"]["table"].device
        self._sigs: Set[Tuple[int, int]] = set()
        self._graphs: Dict[Tuple[int, int], object] = {}
        self.calls = 0
        self.replays = 0
        self.capture_s = 0.0
        self.graph_pool_bytes = 0
        pin = self.device.type == "cuda"
        # packed int32 inputs: contexts (B, W), then their lengths, then
        # the adapter ids, each part on 16 bytes
        self._o = _ceil4(max_rows)
        self._lens_at = {W: _ceil4(max_rows * W) for W in self.ctx_buckets}
        self._host = torch.zeros(
            self._lens_at[self.ctx_buckets[-1]] + 2 * self._o,
            dtype=torch.int32, pin_memory=pin)
        if pin:
            self._pool = (pool if pool is not None
                          else torch.cuda.graph_pool_handle())
            # the split workspaces of every signature at k = spec.k, before
            # any capture: prefill chunks of each bucket over themselves,
            # decode rows over each bucket + k
            tfm.reserve_workspaces(
                cfg, self.qparams, exec_cfg, self.device, rows=max_rows,
                chunks=sorted(set(self.ctx_buckets) | {1}),
                kv_lens=sorted(set(self.ctx_buckets)
                               | {W + spec.k for W in self.ctx_buckets}))

    def _draft_fn(self, inputs: torch.Tensor, W: int, k: int) -> torch.Tensor:
        """k greedy tokens (B, k) for the packed ``inputs`` (contexts
        (B, W), their lengths, adapter ids): no host work depends on the
        values, so a CUDA graph captures it whole."""
        from repro_torch.models import transformer as tfm
        B, o = self.max_rows, self._lens_at[W]
        ctx = inputs[:B * W].view(B, W)
        lens = inputs[o:o + B]
        aidx = (inputs[o + self._o:o + self._o + B].long()
                if self.adapters is not None else None)
        dev = inputs.device
        positions = torch.arange(W, dtype=torch.int32,
                                 device=dev)[None].expand(B, W)
        last = torch.clamp(lens.long() - 1, 0, W - 1)
        lg, cache, _ = tfm.forward(
            self.cfg, self.qparams, {"tokens": ctx}, lora=self.adapters,
            positions=positions, mode="prefill", prefill_cache_len=W + k,
            exec_cfg=self.ec, adapter_idx=aidx, chunk_lens=lens,
            last_idx=last)
        toks = [torch.argmax(lg[:, 0], dim=-1)]
        for i in range(k - 1):
            pos = (lens + i)[:, None]
            lg, cache, _ = tfm.forward(
                self.cfg, self.qparams, {"tokens": toks[-1][:, None]},
                lora=self.adapters, cache=cache, positions=pos,
                mode="decode", exec_cfg=self.ec, adapter_idx=aidx)
            toks.append(torch.argmax(lg[:, -1], dim=-1))
        return torch.stack(toks, dim=1).to(torch.int32)

    def _eager(self, sig, staged):
        return self._draft_fn(staged.to(self.device, non_blocking=True), *sig)

    def _replay(self, sig, staged):
        """The draft of signature ``sig`` by its CUDA graph; its first call
        runs eagerly and then captures the graph."""
        from repro_torch.serve import engine
        g = self._graphs.get(sig)
        if g is None:
            out = self._eager(sig, staged)
            self._graphs[sig], sec, nbytes = engine._capture(
                self.device, self._pool,
                lambda inputs: self._draft_fn(inputs, *sig), staged.numel(),
                f"the self-draft of signature (W={sig[0]}, k={sig[1]})")
            self.capture_s += sec
            self.graph_pool_bytes += nbytes
            return out
        self.replays += 1
        return engine._replay(g, staged)

    def propose(self, streams, adapter_ids, k):
        from repro_torch.serve.scheduler import bucketize
        n = len(streams)
        if n == 0 or k <= 0:
            return [_EMPTY] * n
        assert n <= self.max_rows, (n, self.max_rows)
        tails = [np.asarray(s[-self.draft_ctx:], np.int32) for s in streams]
        W = bucketize(max(t.size for t in tails), self.ctx_buckets)
        o = self._lens_at[W]
        host = self._host.numpy()
        host[:o + 2 * self._o] = 0
        for i, t in enumerate(tails):
            host[i * W:i * W + t.size] = t
            host[o + i] = t.size
        if self.adapters is not None:
            host[o + self._o:o + self._o + n] = np.asarray(adapter_ids,
                                                           np.int32)
        sig = (W, int(k))
        self._sigs.add(sig)
        self.calls += 1
        out = self._run(sig, self._host[:o + 2 * self._o]).cpu().numpy()
        return [out[i] for i in range(n)]

    def _run(self, sig, staged):
        """The draft: by its CUDA graph on a CUDA device, else eagerly."""
        if self.device.type == "cuda":
            return self._replay(sig, staged)
        return self._eager(sig, staged)

    def stats(self):
        return {"draft_signatures": sorted(self._sigs),
                "draft_compiles": len(self._sigs)}


def make_drafter(cfg, params, adapters, spec: SpecConfig, exec_cfg,
                 max_rows: int, *, pool=None) -> Drafter:
    """Build the drafter named by ``spec.drafter``."""
    if spec.drafter == "ngram":
        return NGramDrafter(spec.ngram_max, spec.ngram_min)
    if spec.drafter == "selfdraft":
        return QuantSelfDrafter(cfg, params, adapters, spec, exec_cfg,
                                max_rows, pool=pool)
    raise ValueError(f"unknown drafter {spec.drafter!r} "
                     f"(expected 'ngram' or 'selfdraft')")
