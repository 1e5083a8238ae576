"""Inference engine: the decode step over the paged KV cache.

The paged scheduler drives every prefill and decode through ``decode``
(decode-shaped blocks against the page pool).  The dense-cache
``prefill`` / ``generate`` / ``generate_stream`` loops and the
speculative ``DraftEngine`` wait for ROADMAP (a)2, dense scheduler.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import apply_model, init_paged_cache
from repro_torch.models.config import ModelConfig


class Engine:
    """``params`` are moved to ``device`` (default: the CUDA card; with no
    card and no explicit device this raises)."""

    def __init__(self, cfg: ModelConfig, params: Dict, max_len: int = 256,
                 device=None):
        self.cfg = cfg.validate()
        self.device = resolve_device(device)
        self.params = _tree_to(params, self.device)
        self.max_len = max_len

    def new_paged_cache(self, batch: int, n_pages: int, page_size: int,
                        max_pages: int) -> Dict:
        """Global page pool + per-slot page tables; allocator / trie
        metadata lives with the scheduler (serving/kv_cache.PagePool)."""
        return init_paged_cache(self.cfg, batch, n_pages, page_size, max_pages,
                                device=self.device)

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, positions: torch.Tensor, cache: Dict):
        return decode_step(self.params, tokens, positions, cache, cfg=self.cfg)


def decode_step(params: Dict, tokens: torch.Tensor, positions: torch.Tensor,
                cache: Dict, *, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """tokens: (B, S); positions: (B, S) absolute positions.

    S == 1 is the plain decode step; S > 1 is a decode-shaped block (a
    suffix prefill against resident pages) writing KV at each slot's cursor
    and attending with per-row causal masking."""
    return apply_model(params, tokens, cfg, positions=positions, cache=cache)


def _tree_to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)
