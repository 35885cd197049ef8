"""Wrapper for the flash-attention kernel (``csrc/flash_attn.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version in ``ref.py``.  ``LAUNCHES`` counts kernel launches.  The kernel
reads q ``(B, S, H, hd)`` and k, v ``(B, S, KV, hd)`` by their strides:
GQA needs no expanded copy and hd no padding.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import _build
from . import ref

LAUNCHES = 0
HEAD_DIMS = (64, 128)
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}
_MAX_GRID_Y = 65535          # B * H CTAs on the grid's y axis


def _strided(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where the kernel can read it by strides (unit stride on
    hd, the other strides multiples of 8 elements, 16-byte aligned), else a
    contiguous copy."""
    if (x.stride(-1) == 1 and all(s % 8 == 0 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0):
        return x
    return x.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention, (B, S, H, hd) out in q's dtype; causal by default.

    ``scale`` defaults to ``1 / sqrt(hd)``.  H must be a multiple of KV.
    """
    global LAUNCHES
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B, S, H, hd) and k, v "
                         f"(B, S, KV, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd or H % KV:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal, scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v must share one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: the kernel takes bf16 or fp16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: hd must be one of {HEAD_DIMS}, got {hd}")
    if S < 1 or B * H > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: want S >= 1 and B * H <= {_MAX_GRID_Y}, "
                         f"got S={S}, B*H={B * H}")
    q, k, v = _strided(q), _strided(k), _strided(v)
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    rc = _build.library().vilamb_flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, H, KV, hd, _DTYPES[q.dtype], int(bool(causal)),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), _build.stream_handle(q))
    _build.check(rc, "flash_attn")
    LAUNCHES += 1
    return out
