"""Model entry points: ``init_model``, ``apply_model``, ``init_paged_cache``."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

__all__ = ["ModelConfig", "init_model", "apply_model", "init_paged_cache"]


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device=None) -> Dict:
    """Random weights with the JAX package's tree and names, drawn from
    ``generator`` (default: a CPU generator seeded with 0)."""
    return transformer.init_lm(cfg, generator=generator, device=device)


def init_paged_cache(cfg: ModelConfig, batch: int, n_pages: int,
                     page_size: int, max_pages: int, device=None) -> Dict:
    return transformer.init_paged_cache(cfg, batch, n_pages, page_size,
                                        max_pages, device=device)


def apply_model(params: Dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, cache: Dict):
    """Returns (logits, new_cache)."""
    return transformer.forward(params, tokens, cfg, positions=positions,
                               cache=cache)
