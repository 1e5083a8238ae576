"""Transformer layers of the dense family, as pure functions of
(params dict, inputs), mirroring ``repro.models.layers``.

GQA is computed without repeating KV heads: the attention kernels carry the
G query heads of a KV head together.  Only the paged-cache attention is
ported: the dense-cache and no-cache paths (``_sdpa``) wait for ROADMAP
(a)2.  Sliding windows are a per-layer Python int.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.models.config import ModelConfig


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def init_norm(init, d: int, prefix: str) -> Dict:
    return {prefix + "_w": init.ones((d,))}


# --------------------------------------------------------------------------
# Rotary embeddings
# --------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. fp32 trig, dtype-preserving."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    angles = positions.float()[:, :, None] * freqs                 # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
def init_attention(init, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    p = {
        "wq": init.fan_in((d, cfg.q_dim)),
        "wk": init.fan_in((d, cfg.kv_dim)),
        "wv": init.fan_in((d, cfg.kv_dim)),
        "wo": init.fan_in((cfg.q_dim, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = init.zeros((cfg.q_dim,))
        p["bk"] = init.zeros((cfg.kv_dim,))
        p["bv"] = init.zeros((cfg.kv_dim,))
    return p


def _project_qkv(p: Dict, x: torch.Tensor, cfg: ModelConfig):
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    return q, k, v


def attention(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, window: int, cache: Dict) -> torch.Tensor:
    """Self-attention of x (B, S, d) at ``positions`` (B, S) against one
    layer's paged cache, whose pools it writes in place.  Returns (B, S, d)."""
    if cache is None or "k_pages" not in cache:
        raise NotImplementedError(
            "only paged-cache attention is ported; the dense and no-cache "
            "paths are ROADMAP (a)2, dense scheduler")
    q, k, v = _project_qkv(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = _decode_attn_paged(q, k, v, cache, cfg, window=window)
    return out @ p["wo"]


def _decode_attn_paged(q, k_new, v_new, cache: Dict, cfg: ModelConfig, *,
                       window: int) -> torch.Tensor:
    """Decode-shaped attention against the paged KV pool.

    ``cache`` is one layer's slice of the paged cache: ``k_pages`` /
    ``v_pages`` (N, P, Hkv, hd) global pools, ``table`` (B, MP) physical
    page per logical page (-1 = unmapped) and ``pos`` (B,) write cursors.
    The S new tokens' KV is written at positions ``pos .. pos+S-1`` into
    each slot's mapped pages; a write whose position falls on an UNMAPPED
    page (right-padding past a slot's reservation, idle slots) goes to the
    pinned trash page 0.  Several pad rows may write the same trash cell:
    which one lands there is undefined, and no real row ever reads it.

    S == 1 is the decode hot path (paged decode kernel); S > 1 is the paged
    prefill path — query j attends causally through position ``pos + j``.
    Returns (B, S, Hq*hd).
    """
    B, S, Hq, hd = q.shape
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    table, pos = cache["table"], cache["pos"]
    P = k_pages.shape[1]
    MP = table.shape[1]
    idx = pos[:, None] + torch.arange(S, dtype=pos.dtype, device=pos.device)[None, :]
    pg = torch.div(idx, P, rounding_mode="floor")
    entry = torch.gather(table, 1, pg.clamp(0, MP - 1).long())
    valid = (pg < MP) & (entry >= 0)
    phys = torch.where(valid, entry, torch.zeros_like(entry)).long()
    off = (idx % P).long()
    # in place: the pools are updated where the JAX package copies with .at[].set
    k_pages.index_put_((phys, off), k_new.to(k_pages.dtype))
    v_pages.index_put_((phys, off), v_new.to(v_pages.dtype))
    if S == 1:
        out = da_ops.paged_decode_attention(
            q[:, 0].contiguous(), k_pages, v_pages, table, pos, window=window,
            softcap=cfg.logit_softcap)
    else:
        out = da_ops.paged_prefill_attention(
            q.contiguous(), k_pages, v_pages, table, pos, window=window,
            softcap=cfg.logit_softcap)
    return out.reshape(B, S, Hq * hd)


def init_paged_kv_cache(cfg: ModelConfig, batch: int, n_pages: int,
                        page_size: int, max_pages: int, n_layers: int,
                        dtype: torch.dtype, device: torch.device) -> Dict:
    """One global page pool per layer + per-slot page tables.  ``table`` and
    ``pos`` are replicated over the layer axis, as in the JAX layout."""
    shape = (n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return {
        "k_pages": torch.zeros(shape, dtype=dtype, device=device),
        "v_pages": torch.zeros(shape, dtype=dtype, device=device),
        "table": torch.full((n_layers, batch, max_pages), -1, dtype=torch.int32,
                            device=device),
        "pos": torch.zeros((n_layers, batch), dtype=torch.int32, device=device),
    }


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def init_mlp(init, cfg: ModelConfig) -> Dict:
    d, d_ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": init.fan_in((d, d_ff)),
        "w_up": init.fan_in((d, d_ff)),
        "w_down": init.fan_in((d_ff, d)),
    }


def mlp(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------
def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(x: torch.Tensor, table_or_w: torch.Tensor, tied: bool) -> torch.Tensor:
    if tied:
        return x @ table_or_w.T
    return x @ table_or_w
