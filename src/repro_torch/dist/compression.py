"""Gradient compression: blockwise int8 quantization with error feedback.

The port of ``repro.dist.compression``.  Cross-pod gradient reduction is
bandwidth-bound; 8-bit blockwise quantization cuts the wire bytes 4x vs
fp32 (2x vs bf16).  Error feedback carries the per-step quantization
residual into the next step so no gradient mass is lost over time (the
EF-SGD contract: ``sum_t sent_t + err_T == sum_t grad_t``).
"""
from __future__ import annotations

from typing import Tuple

import torch

BLOCK = 256  # elements per scale block (one f32 scale per 256 int8 payloads)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat fp tensor (multiple of BLOCK) -> (int8[n], f32 scales[n/BLOCK]).

    Symmetric round-to-nearest-even; scale = max|x| / 127 per block, so the
    absolute error is bounded by scale/2 elementwise.
    """
    xb = x.reshape(-1, BLOCK).to(torch.float32)
    s = xb.abs().amax(dim=1) / 127.0
    live = s[:, None] > 0
    q = torch.where(live, torch.round(xb / torch.where(live, s[:, None], 1.0)), 0.0)
    return q.to(torch.int8).reshape(-1), s


def _dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (q.reshape(-1, BLOCK).to(torch.float32) * s[:, None]).reshape(-1)


def ef_compress(x: torch.Tensor, err: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One error-feedback step: quantize ``x + err``, return the residual.

    Returns ``(q, scales, new_err)``; the receiver reconstructs with
    :func:`_dequantize` and the sender carries ``new_err`` into the next
    call.
    """
    flat = x + err
    q, s = _quantize(flat)
    new_err = flat - _dequantize(q, s)
    return q, s, new_err
