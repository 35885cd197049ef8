"""Shared uint32 helpers for the kernels' plain versions and the core.

Every uint32 bit pattern (lanes, checksums, parity, dirty words) is carried
as a ``torch.int32`` tensor holding the same bits: torch has no CPU ``>>``
or ``>`` for ``torch.uint32``.  An int32 multiply wraps exactly as a uint32
one does; only right shifts differ (int32 ``>>`` is arithmetic), so the
logical shifts below mask off the sign-extended bits.  The CUDA side of
these helpers is ``csrc/vilamb_common.cuh``.
"""
from __future__ import annotations

import torch


def i32(v: int) -> int:
    """The signed int32 value holding the bits of uint32 ``v``."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


GOLDEN = i32(0x9E3779B9)
SALT2 = i32(0x85EBCA77)
C1 = i32(0x85EBCA6B)
C2 = i32(0xC2B2AE35)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> int32 tensor with the same low 32 bits."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 32-bit finalizer on int32-carried uint32 words."""
    return fmix32_(x.clone())


def fmix32_(x: torch.Tensor) -> torch.Tensor:
    """In-place :func:`fmix32` for a temporary the caller owns.

    The plain versions run over whole 8 GiB lane views on the card; the
    in-place form keeps them at one extra full-size temporary.  The logical
    shifts mask off the bits an int32 ``>>`` sign-extends.
    """
    t = torch.bitwise_right_shift(x, 16)
    x ^= t.bitwise_and_(0xFFFF)
    x *= C1
    torch.bitwise_right_shift(x, 13, out=t)
    x ^= t.bitwise_and_(0x7FFFF)
    x *= C2
    torch.bitwise_right_shift(x, 16, out=t)
    x ^= t.bitwise_and_(0xFFFF)
    return x


def xor_fold(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR-reduce ``x`` over ``dim`` (torch has no XOR reduction).

    Pairwise halving: an odd length folds its last slice into the first
    before halving, which is the same as padding with a zero slice.
    """
    dim = dim % x.dim()
    n = x.shape[dim]
    if n == 0:
        shape = list(x.shape)
        del shape[dim]
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    while n > 1:
        h = n // 2
        lo = x.narrow(dim, 0, h) ^ x.narrow(dim, h, h)
        if n % 2:
            first = lo.narrow(dim, 0, 1)
            first ^= x.narrow(dim, n - 1, 1)
        x, n = lo, h
    return x.squeeze(dim)
