"""Plain PyTorch versions of GQA paged decode / paged prefill attention:
gather each slot's pages back into a dense cache in logical order, then
masked softmax attention in fp32.  The CPU path of ``ops.py`` and the
oracle the CUDA kernels are held against."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: torch.Tensor,
                         window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, T, Hkv, D); pos: (B,) index of the query
    token (attends to kv positions <= pos); ``softcap`` > 0 applies the
    score cap c*tanh(s/c). Returns (B, Hq, D)."""
    B, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) * (1.0 / math.sqrt(D))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(T, device=q.device)[None, :]
    qpos = pos.long()[:, None]
    mask = kpos <= qpos
    if window > 0:
        mask = mask & (qpos - kpos < window)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return o.reshape(B, Hq, D).to(q.dtype)


def _gather_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(N, P, Hkv, D) pages + (B, MP) table -> (B, MP*P, Hkv, D); unmapped
    (-1) entries are clamped to page 0 and die under the positional mask."""
    B, MP = table.shape
    _, P, Hkv, D = pages.shape
    return pages[table.clamp(min=0).long()].reshape(B, MP * P, Hkv, D)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, table: torch.Tensor,
                               pos: torch.Tensor, window: int = 0,
                               softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, D); pages: (N, P, Hkv, D) global pools; table: (B, MP)
    int32 physical page per logical page (-1 = unmapped); pos: (B,).
    Returns (B, Hq, D)."""
    return decode_attention_ref(q, _gather_pages(k_pages, table),
                                _gather_pages(v_pages, table), pos, window,
                                softcap=softcap)


def paged_prefill_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, table: torch.Tensor,
                                pos: torch.Tensor, window: int = 0,
                                softcap: float = 0.0) -> torch.Tensor:
    """q: (B, S, Hq, D) with query j of slot b at absolute position
    ``pos[b] + j``; pages: (N, P, Hkv, D); table: (B, MP); pos: (B,).
    Per-row causal (+ sliding window, + softcap) masking.
    Returns (B, S, Hq, D)."""
    B, S, Hq, D = q.shape
    Hkv = k_pages.shape[2]
    G = Hq // Hkv
    k = _gather_pages(k_pages, table).float()
    v = _gather_pages(v_pages, table).float()
    T = k.shape[1]
    qg = q.reshape(B, S, Hkv, G, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k) * (1.0 / math.sqrt(D))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(T, device=q.device)[None, None, :]                 # (1, 1, T)
    qpos = (pos.long()[:, None]
            + torch.arange(S, device=q.device)[None, :])[:, :, None]       # (B, S, 1)
    mask = kpos <= qpos
    if window > 0:
        mask = mask & (qpos - kpos < window)
    s = s.masked_fill(~mask[:, None, None, :, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v)
    return o.reshape(B, S, Hq, D).to(q.dtype)
