"""Wrappers for GQA paged decode / paged prefill attention.

The path is picked by the tensors' device and by nothing else: a CPU
tensor goes to the plain PyTorch version (``ref.py``); a CUDA tensor goes to
the hand-written kernel (``csrc/paged_attention.cu``), or the wrapper
raises.  Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import (
    paged_decode_attention_ref, paged_prefill_attention_ref)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _bind(name: str, n_ints: int):
    """The C entry point: 5 input pointers, 1 output pointer, ``n_ints``
    shape ints, window, softcap, dtype code, stream."""
    fn = getattr(_build.library("paged_attention"), name)
    fn.argtypes = [_P] * 6 + [_I] * n_ints + [_I, ctypes.c_float, _I, _P]
    fn.restype = _I
    return fn


def _check(q, k_pages, v_pages, table, pos, B: int, Hq: int, D: int) -> None:
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "table": table, "pos": pos}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q, k_pages and v_pages must share one dtype")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("table and pos must be int32")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("k_pages and v_pages must both be (N, P, Hkv, D)")
    Hkv = k_pages.shape[2]
    if k_pages.shape[3] != D or Hq % Hkv != 0:
        raise ValueError(f"q heads/dim ({Hq}, {D}) do not fit pages "
                         f"{tuple(k_pages.shape)}")
    if table.dim() != 2 or table.shape[0] != B or pos.shape != (B,):
        raise ValueError(f"table must be ({B}, MP) and pos ({B},)")
    if B < 1:
        raise ValueError("empty batch")


def _device_path(q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return True


def paged_decode_attention(q, k_pages, v_pages, table, pos, window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, D); pages: (N, P, Hkv, D); table: (B, MP) int32 physical
    page per logical page (-1 = unmapped); pos: (B,) int32; ``window`` 0 =
    off; ``softcap`` 0 = off.  Returns (B, Hq, D) in q's dtype."""
    if not _device_path(q):
        return paged_decode_attention_ref(q, k_pages, v_pages, table, pos,
                                          window, softcap=softcap)
    if q.dim() != 3:
        raise ValueError(f"q must be (B, Hq, D), got {tuple(q.shape)}")
    B, Hq, D = q.shape
    _check(q, k_pages, v_pages, table, pos, B, Hq, D)
    _, P, Hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    err = _bind("paged_decode_attention", 6)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
        pos.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, P, table.shape[1],
        int(window), float(softcap), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA error {err}")
    paged_decode_attention.launches += 1
    return out


def paged_prefill_attention(q, k_pages, v_pages, table, pos, window: int = 0,
                            softcap: float = 0.0) -> torch.Tensor:
    """q: (B, S, Hq, D), query j of slot b at absolute position
    ``pos[b] + j``; the rest as ``paged_decode_attention``.
    Returns (B, S, Hq, D) in q's dtype."""
    if not _device_path(q):
        return paged_prefill_attention_ref(q, k_pages, v_pages, table, pos,
                                           window, softcap=softcap)
    if q.dim() != 4 or q.shape[1] < 1:
        raise ValueError(f"q must be (B, S>=1, Hq, D), got {tuple(q.shape)}")
    B, S, Hq, D = q.shape
    _check(q, k_pages, v_pages, table, pos, B, Hq, D)
    _, P, Hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    err = _bind("paged_prefill_attention", 7)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
        pos.data_ptr(), out.data_ptr(), B, S, Hq, Hkv, D, P, table.shape[1],
        int(window), float(softcap), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill_attention launch failed: CUDA error {err}")
    paged_prefill_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_prefill_attention.launches = 0
