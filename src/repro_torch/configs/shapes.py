"""Assigned input-shape suites (one set, shared by all 10 LM-family archs).

``train_*`` lowers ``train_step``; ``prefill_*`` lowers ``prefill_step``;
``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ShapeSuite:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeSuite("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSuite("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSuite("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSuite("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSuite, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def cell_supported(cfg: ModelConfig, shape: ShapeSuite) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, and why not if skipped.

    long_500k requires sub-quadratic attention; per the brief we skip it for
    pure full-attention archs and run it for SSM/hybrid/sliding-window archs
    (see DESIGN.md SS5)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "skipped(full-attn): long_500k requires sub-quadratic attention"
    return True, ""
