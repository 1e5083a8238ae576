"""Decoder-only language model of the dense family, mirroring
``repro.models.transformer``.

Parameters keep the JAX tree: one dict of per-layer leaves stacked on a
leading layer dim, walked by a Python loop where JAX scans.  The forward
runs against the paged KV cache only (the path the paged scheduler
drives): ``(B, S)`` token blocks at per-row absolute positions write their
KV at each slot's cursor and then attend with per-row causal masks.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Initializer, StackedInit


def _attn_block(p, x, cfg: ModelConfig, *, positions, window, cache):
    h = L.rms_norm(x, p["attn_norm_w"], cfg.norm_eps)
    return x + L.attention(p, h, cfg, positions=positions, window=window, cache=cache)


def _mlp_block(p, x, cfg: ModelConfig):
    h = L.rms_norm(x, p["mlp_norm_w"], cfg.norm_eps)
    return x + L.mlp(p, h, cfg)


def init_lm(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
            device=None) -> Dict:
    """Weights drawn from ``generator`` (default: a CPU generator seeded
    with 0) and placed on ``device``.  A generator on the card draws
    full-width weights there."""
    cfg.validate()
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init = Initializer(generator, torch_dtype(cfg.dtype), device)
    p: Dict = {"embed": init.normal((cfg.vocab, cfg.d_model))}
    if not cfg.tie_embeddings:
        p["unembed"] = init.fan_in((cfg.d_model, cfg.vocab))
    p.update(L.init_norm(init, cfg.d_model, "final_norm"))
    si = StackedInit(init, cfg.n_layers)
    lp = L.init_attention(si, cfg)
    lp.update(L.init_norm(si, cfg.d_model, "attn_norm"))
    lp.update(L.init_mlp(si, cfg))
    lp.update(L.init_norm(si, cfg.d_model, "mlp_norm"))
    p["layers"] = lp
    return p


def _window_array(cfg: ModelConfig) -> List[int]:
    return [0 if cfg.layer_is_global(i) else cfg.sliding_window
            for i in range(cfg.n_layers)]


def init_paged_cache(cfg: ModelConfig, batch: int, n_pages: int,
                     page_size: int, max_pages: int, device=None) -> Dict:
    """Paged KV cache: a global page pool + per-slot page tables.  The
    serving scheduler owns the allocator / prefix-trie metadata
    (serving/kv_cache.PagePool)."""
    return {"paged": L.init_paged_kv_cache(
        cfg, batch, n_pages, page_size, max_pages, cfg.n_layers,
        torch_dtype(cfg.dtype), resolve_device(device))}


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            positions: torch.Tensor, cache: Dict):
    """tokens, positions: (B, S).  Returns (logits (B, S, V), new_cache).

    The page pools of ``cache`` are written in place; ``new_cache`` shares
    them and carries the cursors advanced by S."""
    x = L.embed(tokens, params["embed"])
    x = _dense_stack(params, x, cfg, positions, cache["paged"])
    x = L.rms_norm(x, params["final_norm_w"], cfg.norm_eps)
    logits = L.unembed(x, params["embed"] if cfg.tie_embeddings else params["unembed"],
                       cfg.tie_embeddings)
    kv = cache["paged"]
    new_cache = {"paged": {**kv, "pos": kv["pos"] + tokens.shape[1]}}
    return logits, new_cache


def _dense_stack(params, x, cfg: ModelConfig, positions, kv: Dict):
    layers = params["layers"]
    for i, window in enumerate(_window_array(cfg)):
        lp = {k: v[i] for k, v in layers.items()}
        kv_l = {k: v[i] for k, v in kv.items()}
        x = _attn_block(lp, x, cfg, positions=positions, window=window, cache=kv_l)
        x = _mlp_block(lp, x, cfg)
    return x
