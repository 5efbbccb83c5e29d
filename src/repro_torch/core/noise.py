"""Noise-aware fine-tuning (Atleus SS V.E), PyTorch port of
``repro.core.noise``.

ReRAM crossbars perturb stored conductances; the paper injects clipped
Gaussian noise dw ~ N(0, sigma^2) into the *frozen pre-trained* weights
while training the LoRA adapters (which live on the noise-free systolic
engine), so the adapters learn to compensate. sigma is set relative to the
per-tensor absolute-maximum weight, and perturbations beyond the absmax
bound are clipped (ref [57] in the paper).

The JAX package folds a shape fingerprint into one key per layer; here
every call draws fresh noise from an explicit ``torch.Generator`` that
lives on the weight's device. The two frameworks' random bits differ, so
tests compare the noise's distribution, not its values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class NoiseConfig:
    enabled: bool = False
    sigma_rel: float = 0.02   # sigma = sigma_rel * absmax(w), per tensor
    clip: bool = True         # clip w+dw to [-absmax, absmax]

    def with_sigma(self, sigma_rel: float) -> "NoiseConfig":
        return NoiseConfig(enabled=True, sigma_rel=sigma_rel, clip=self.clip)


def apply_weight_noise(w: torch.Tensor, cfg: NoiseConfig,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
    """Perturb a frozen weight the way a non-ideal crossbar would."""
    if not cfg.enabled:
        return w
    if generator is None:
        raise ValueError("noise-aware fine-tuning needs a torch.Generator")
    absmax = torch.max(torch.abs(w)).to(torch.float32)
    sigma = cfg.sigma_rel * absmax
    noise = torch.randn(w.shape, generator=generator, device=w.device,
                        dtype=torch.float32)
    noisy = w.to(torch.float32) + sigma * noise
    if cfg.clip:
        noisy = torch.clamp(noisy, -absmax, absmax)
    return noisy.to(w.dtype)
