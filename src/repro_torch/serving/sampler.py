"""Token samplers: greedy / temperature / top-k over (B, V) logits.

``temperature == 0`` (greedy, the default) is ``argmax``, which returns the
first maximal index on ties, as ``jnp.argmax`` does.  Sampling draws from
an explicit ``torch.Generator`` on the logits' device; its numbers differ
from ``jax.random``'s for the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0   # 0 = greedy
    top_k: int = 0             # 0 = no truncation


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           sc: SamplerConfig) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32."""
    if sc.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = logits.float() / sc.temperature
    if sc.top_k > 0:
        kth = torch.topk(x, sc.top_k, dim=-1).values[:, -1:]
        x = torch.where(x < kth, float("-inf"), x)
    probs = torch.softmax(x, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
