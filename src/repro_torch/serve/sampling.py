"""Token sampling (PyTorch port of ``repro.serve.sampling``).

Greedy argmax at temperature 0, Gumbel-max at temperature > 0:
``argmax(logits/T + g)`` with ``g ~ Gumbel(0,1)`` draws exactly from
``softmax(logits/T)``. That makes the speculative-decoding rejection rule
exact: its correction token must come from the target distribution (with
the rejected draft masked out, ``forbid=``). The noise comes from a
``torch.Generator``, so only greedy tokens can match the JAX package;
sampled tokens agree with it in distribution only (ROADMAP Queue 3).
"""
from __future__ import annotations

from typing import Optional

import torch


def gumbel_like(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Seeded Gumbel(0,1) noise (the 1e-9 floor avoids log(0))."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u * (1.0 - 1e-9) + 1e-9
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, temps: Optional[torch.Tensor],
                  generator: Optional[torch.Generator] = None, *,
                  any_sampled: bool,
                  forbid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, V), temps (B,) -> (B,) int64. Greedy where temp == 0.

    ``any_sampled`` says whether some temp is > 0. The caller holds the
    temperatures on the host, so the choice costs no wait for the device;
    when it is False, ``temps`` is not read (it may be None) and the
    generator is not drawn from. ``forbid`` (B,) optionally masks one token
    id per row to -inf first: the residual draw of the spec-decode
    rejection rule (with a deterministic drafter the residual of ``p``
    after rejecting draft ``d`` is ``p`` renormalized over ``V \\ {d}``);
    ``forbid[b] = -1`` leaves row ``b`` unmasked."""
    if forbid is not None:
        V = logits.shape[-1]
        hit = ((torch.arange(V, device=logits.device)[None, :]
                == forbid[:, None]) & (forbid[:, None] >= 0))
        logits = logits.masked_fill(hit, float("-inf"))
    greedy = torch.argmax(logits, dim=-1)
    if not any_sampled:
        return greedy
    if generator is None:
        raise ValueError("sampling at temperature > 0 needs a generator")
    g = gumbel_like(generator, logits.shape, logits.device)
    sampled = torch.argmax(
        logits.to(torch.float32) / torch.clamp(temps[:, None], min=1e-6) + g,
        dim=-1)
    return torch.where(temps > 0, sampled, greedy)
