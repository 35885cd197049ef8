"""Wrapper for the flash-attention kernel (``csrc/flash_attn.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version in ``ref.py``; ``meta`` tensors run the card's checks and get the
card's output shape, with nothing launched (the dry run).  ``LAUNCHES``
counts kernel launches.  On every device the call reports one launch and
its work to an active cost counter (``launch.cost_analysis``), and a
copy the card makes of a layout its tensor maps cannot describe is
counted under its own name.  The kernel
reads q ``(B, Sq, H, hd)`` and k, v ``(B, Sk, KV, hd)`` in place through TMA
tensor maps of dims ``(hd, heads, S, B)`` and the byte strides that
``tensor_map_layout`` computes: GQA needs no expanded copy and hd no
padding.  Layouts a tensor map cannot describe are copied first.  The key
length may differ from the query's (cross attention over an encoder
memory), as in the TPU kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ...launch import cost_analysis
from .. import _build
from . import ref

LAUNCHES = 0
HEAD_DIMS = (64, 128)
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}
_BLOCK_M = 128                # query rows a CTA
_MAX_GRID = 2**31 - 1        # CTAs: B * H * ceil(Sq / 128) on the grid's x axis
_MAX_STRIDE = 1 << 40        # TMA: byte strides below 2^40


def tensor_map_layout(x: torch.Tensor) -> Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """The TMA tensor map of a ``(B, S, heads, hd)`` tensor: its dims
    innermost first, ``(hd, heads, S, B)``, and the byte strides of heads,
    S and B.  None where a tensor map cannot describe ``x``: hd not
    unit-stride, a stride not a multiple of 16 bytes or not below 2^40, a
    dim's stride smaller than the extent of the dims inside it (TMA wants
    each dim to enclose the previous one), or a base not 16-byte aligned.
    A dim of size 1 is never stepped, so its stride is taken as that
    extent."""
    B, S, heads, hd = x.shape
    if x.stride(3) != 1 or x.data_ptr() % 16:
        return None
    es = x.element_size()
    strides, extent = [], hd * es
    for size, stride in ((heads, x.stride(2)), (S, x.stride(1)), (B, x.stride(0))):
        st = extent if size == 1 else stride * es
        if st % 16 or st < extent or st >= _MAX_STRIDE:
            return None
        strides.append(st)
        extent = st * size
    return (hd, heads, S, B), tuple(strides)


def _strided(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where a tensor map can describe it, else a packed copy."""
    if tensor_map_layout(x) is not None:
        return x
    cost_analysis.note_copy("flash_attn packed copy", 2 * x.numel() * x.element_size())
    return x.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention, (B, Sq, H, hd) out in q's dtype; causal by
    default.  q is (B, Sq, H, hd), k and v (B, Sk, KV, hd): query row r
    attends to keys c < Sk, and with ``causal`` only to c <= r (absolute
    indices, as the TPU kernel's mask).

    ``scale`` defaults to ``1 / sqrt(hd)``.  H must be a multiple of KV.
    Forward only: raises when grad mode is on and an input requires grad
    (on the CPU too), never returning a result with no graph; training
    takes the tiled differentiable attention instead.
    """
    with cost_analysis.launch("flash_attn",
                              lambda: (1, *cost_analysis.flash_work(q, k, v, causal), 0)):
        return _attention(q, k, v, causal, scale)


def _attention(q, k, v, causal: bool, scale: Optional[float]) -> torch.Tensor:
    global LAUNCHES
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is forward-only and was asked for a "
                           "gradient: training takes the tiled attention "
                           "(models.attention.causal_attention(..., train=True))")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B, Sq, H, hd) and k, v of one "
                         f"shape (B, Sk, KV, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if S < 1 or Sk < 1:
        raise ValueError(f"flash_attention: want Sq >= 1 and Sk >= 1, got "
                         f"Sq={S}, Sk={Sk}")
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal, scale)
    if (q.device.type not in ("cuda", "meta") or k.device != q.device
            or v.device != q.device):
        raise ValueError(f"flash_attention: q, k, v must share one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: the kernel takes bf16 or fp16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: hd must be one of {HEAD_DIMS}, got {hd}")
    if B * H * -(-S // _BLOCK_M) > _MAX_GRID:
        raise ValueError(f"flash_attention: want B * H * ceil(Sq / {_BLOCK_M}) "
                         f"<= {_MAX_GRID}, got B={B}, Sq={S}, H={H}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if scale < 0:            # the kernel takes scale >= 0: (-q) k (-scale) is exact
        q, scale = -q, -scale
    q, k, v = _strided(q), _strided(k), _strided(v)
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        return out
    strides = [s for t in (q, k, v, out) for s in tensor_map_layout(t)[1]]
    rc = _build.library().vilamb_flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, Sk, H, KV, hd, _DTYPES[q.dtype], int(bool(causal)), *strides,
        float(scale), _build.stream_handle(q))
    if rc < 0:
        raise RuntimeError(f"flash_attn: cuTensorMapEncodeTiled refused a tensor "
                           f"map (CUresult {-rc})")
    _build.check(rc, "flash_attn")
    LAUNCHES += 1
    return out
