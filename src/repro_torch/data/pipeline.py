"""Deterministic, shardable, resumable token pipeline (the port's copy of
``repro.data.pipeline``: numpy only, so both packages draw the same
batches for the same seed, step and shard).

Design requirements for 1000+-node training (DESIGN.md SS4):

  * **stateless indexing** — batch contents are a pure function of
    (seed, step, sample index). Restarting from a checkpoint at step k
    reproduces exactly the batches k, k+1, ... with no sampler state to
    save, and elastic resharding just changes which indices a host draws.
  * **shardable** — a host materializes only its slice of the global batch.
  * **learnable synthetic corpus** — nothing is downloaded, so the
    "WikiText-like" corpus is a seeded Zipfian bigram language: strong
    first-order structure a model can learn (perplexity drops from ~ln V
    to the process entropy), which is what the Fig. 13 quantization-
    perplexity benchmark needs.

A memmap-backed dataset with the same interface covers real tokenized
corpora.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    index: int = 0
    count: int = 1


class SyntheticLM:
    """Seeded Zipfian-bigram language model corpus."""

    def __init__(self, vocab_size: int, seed: int = 0, branch: int = 8):
        self.vocab_size = vocab_size
        self.seed = seed
        self.branch = branch
        rng = np.random.default_rng(seed)
        # each token has `branch` likely successors with Zipf weights
        self._succ = rng.integers(0, vocab_size,
                                  size=(vocab_size, branch)).astype(np.int64)
        w = 1.0 / np.arange(1, branch + 1)
        self._w = (w / w.sum()).astype(np.float64)

    def entropy_bound(self) -> float:
        return float(-(self._w * np.log(self._w)).sum())

    def sequence(self, idx: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed * 0x9E3779B9 + idx) & 0xFFFFFFFF)
        out = np.empty(seq_len + 1, np.int32)
        tok = int(rng.integers(0, self.vocab_size))
        for t in range(seq_len + 1):
            out[t] = tok
            nxt = rng.choice(self.branch, p=self._w)
            tok = int(self._succ[tok, nxt])
        return out

    def batch(self, step: int, global_batch: int, seq_len: int,
              shard: ShardInfo = ShardInfo()) -> Dict[str, np.ndarray]:
        """Local slice of the global batch for this shard."""
        assert global_batch % shard.count == 0
        local = global_batch // shard.count
        lo = shard.index * local
        seqs = np.stack([
            self.sequence(step * global_batch + lo + i, seq_len)
            for i in range(local)
        ])
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


class MemmapLM:
    """Flat token file: deterministic strided windows (same interface)."""

    def __init__(self, path: str, vocab_size: int, seed: int = 0):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.vocab_size = vocab_size
        self.seed = seed

    def batch(self, step: int, global_batch: int, seq_len: int,
              shard: ShardInfo = ShardInfo()) -> Dict[str, np.ndarray]:
        assert global_batch % shard.count == 0
        local = global_batch // shard.count
        lo = shard.index * local
        n_win = (len(self.tokens) - 1) // seq_len
        rng = np.random.default_rng(self.seed)
        perm_base = rng.permutation(n_win)
        idx = [(step * global_batch + lo + i) % n_win for i in range(local)]
        rows = []
        for i in idx:
            s = perm_base[i] * seq_len
            rows.append(np.asarray(self.tokens[s:s + seq_len + 1]))
        seqs = np.stack(rows)
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def make_dataset(vocab_size: int, seed: int = 0,
                 path: Optional[str] = None):
    if path:
        return MemmapLM(path, vocab_size, seed)
    return SyntheticLM(vocab_size, seed)
