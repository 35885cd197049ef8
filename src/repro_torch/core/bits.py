"""Packed dirty-bitvector primitives (paper §3.2).

The writer produces dirty masks directly; this module holds the packed
bitvector representation (uint32 words carried as int32, little-endian
bits) and the snapshot/clear operations of Algorithm 1.  Every function is
shape-static and never synchronises with the device.
"""
from __future__ import annotations

import torch

from ..kernels.common import wrap_i32

WORD_BITS = 32


def n_words(n_bits: int) -> int:
    """Number of uint32 words needed to hold ``n_bits`` bits."""
    return max(1, (n_bits + WORD_BITS - 1) // WORD_BITS)


def zeros(n_bits: int, device=None) -> torch.Tensor:
    return torch.zeros((n_words(n_bits),), dtype=torch.int32, device=device)


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=torch.int32, device=device)


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """Pack a bool[n_bits] mask into int32[n_words] (little-endian bits)."""
    return pack_rows(mask[None])


def pack_rows(mask: torch.Tensor) -> torch.Tensor:
    """Pack a bool[rows, n_bits] mask into int32[rows * n_words]: one
    bitvector per row (a shard's), concatenated."""
    rows, n_bits = mask.shape
    nw = n_words(n_bits)
    m = torch.zeros((rows, nw * WORD_BITS), dtype=torch.int64, device=mask.device)
    m[:, :n_bits] = mask
    weights = torch.ones((), dtype=torch.int64, device=mask.device) << _shifts(
        mask.device).to(torch.int64)
    return wrap_i32((m.view(rows, nw, WORD_BITS) * weights).sum(dim=2)).reshape(-1)


def unpack(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Unpack int32[n_words] into bool[n_bits]."""
    bits = (words[:, None] >> _shifts(words.device)[None, :]) & 1
    return bits.reshape(-1)[:n_bits].bool()


def unpack_rows(words: torch.Tensor, rows: int, n_bits: int) -> torch.Tensor:
    """Unpack ``rows`` concatenated bitvectors into bool[rows, n_bits]."""
    w = words.reshape(rows, -1)
    bits = (w[:, :, None] >> _shifts(words.device)[None, None, :]) & 1
    return bits.reshape(rows, -1)[:, :n_bits].bool()


def mark(words: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """OR a bool[n_bits] dirty mask into the packed bitvector."""
    return words | pack_mask(mask)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Total number of set bits (int32 scalar tensor)."""
    bits = (words[:, None] >> _shifts(words.device)[None, :]) & 1
    return bits.sum(dtype=torch.int32)
