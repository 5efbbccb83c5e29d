"""Config registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

The port carries the configs of the architectures it can run, and the
paper's own two evaluation models (``"paper-gpt2-medium"``,
``"paper-bloom-560m"``), which, as in the JAX package, ``get_config``
resolves but ``ARCH_IDS`` leaves out. The JAX package knows more
architectures; asking for one of those raises ``NotImplementedError``
naming the ROADMAP item that ports what it needs.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (AttnConfig, LoRAConfig, ModelConfig,
                                      QuantConfig, reduce_config)
from repro_torch.configs.shapes import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                        PREFILL_32K, SHAPES, TRAIN_4K,
                                        ShapeSuite, cell_supported)

_ARCH_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "rwkv6-7b": "rwkv6_7b",
    "gemma2-9b": "gemma2_9b",
}

# architectures of the JAX package that wait for a later slice of the port
_WAITING = {
    "mixtral-8x22b": "ROADMAP Queue 1 item 12 (MoE)",
    "llama4-scout-17b-a16e": "ROADMAP Queue 1 item 12 (MoE)",
    "internlm2-20b": "ROADMAP Queue 1 item 19 (config copy)",
    "mistral-nemo-12b": "ROADMAP Queue 1 item 19 (config copy)",
    "musicgen-medium": "ROADMAP Queue 1 item 19 (embeddings frontend)",
    "chameleon-34b": "ROADMAP Queue 1 item 19 (qk-norm, embeddings frontend)",
    "jamba-1.5-large-398b": "ROADMAP Queue 1 items 12-13 (MoE, Mamba)",
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
    if name in _WAITING:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: {_WAITING[name]}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_IDS)}")


__all__ = ["ModelConfig", "AttnConfig", "LoRAConfig", "QuantConfig",
           "reduce_config", "get_config", "ARCH_IDS", "ALL_SHAPES", "SHAPES",
           "ShapeSuite", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
           "cell_supported"]
