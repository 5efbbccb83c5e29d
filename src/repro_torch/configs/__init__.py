"""Config registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

The port carries the configs of every architecture of the JAX package
(dense, sliding-window, MoE, RWKV, the Mamba+attention hybrid
jamba-1.5-large-398b, and the embedding-frontend stubs of musicgen-medium
and chameleon-34b), in its order, and the paper's own two evaluation
models (``"paper-gpt2-medium"``, ``"paper-bloom-560m"``), which, as in the
JAX package, ``get_config`` resolves but ``ARCH_IDS`` leaves out.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (AttnConfig, LoRAConfig, MambaConfig,
                                      ModelConfig, MoEConfig, QuantConfig,
                                      reduce_config)
from repro_torch.configs.shapes import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                        PREFILL_32K, SHAPES, TRAIN_4K,
                                        ShapeSuite, cell_supported)

_ARCH_MODULES = {
    "mixtral-8x22b": "mixtral_8x22b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "internlm2-20b": "internlm2_20b",
    "gemma2-9b": "gemma2_9b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "llama3.2-1b": "llama3_2_1b",
    "musicgen-medium": "musicgen_medium",
    "chameleon-34b": "chameleon_34b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "rwkv6-7b": "rwkv6_7b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name in _ARCH_MODULES:
        mod = importlib.import_module(
            f"repro_torch.configs.{_ARCH_MODULES[name]}")
        return mod.CONFIG
    if name in ("paper-gpt2-medium", "paper-bloom-560m"):
        mod = importlib.import_module("repro_torch.configs.paper_models")
        return {"paper-gpt2-medium": mod.GPT2_MEDIUM,
                "paper-bloom-560m": mod.BLOOM_560M}[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_IDS)}")


__all__ = ["ModelConfig", "AttnConfig", "MoEConfig", "MambaConfig",
           "LoRAConfig", "QuantConfig",
           "reduce_config", "get_config", "ARCH_IDS", "ALL_SHAPES", "SHAPES",
           "ShapeSuite", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
           "cell_supported"]
