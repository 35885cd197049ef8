"""Per-block checksums — a position-salted fmix32 XOR-fold.

    cksum(block b) = XOR_i fmix32(w_i XOR salt(b, i))
    salt(b, i)     = (b * GOLDEN) XOR (i * SALT2)

Same function as the reference's ``repro/core/checksum.py``, on uint32
words carried as int32 (see ``kernels/common.py``).  ``block_checksums``
launches the hand-written CUDA kernel for a tensor on the card and runs
its plain version for a tensor on the CPU; the diff and meta-checksum
helpers are plain torch everywhere, as in the reference.
"""
from __future__ import annotations

import torch

from ..kernels.checksum import ops as _ops
from ..kernels.common import (C1, C2, GOLDEN, SALT2, fmix32, fmix32_, i32,
                              xor_fold)

__all__ = ["C1", "C2", "GOLDEN", "SALT2", "block_checksums", "checksum_diff",
           "fmix32", "fmix32_", "lane_salt", "meta_checksum",
           "meta_checksum_delta", "meta_checksum_rows"]


def lane_salt(block_ids: torch.Tensor, lane_ids: torch.Tensor) -> torch.Tensor:
    """salt(b, i); broadcasts (B,1)x(1,L) -> (B,L)."""
    return (block_ids.to(torch.int32) * GOLDEN) ^ (lane_ids.to(torch.int32) * SALT2)


def block_checksums(lanes: torch.Tensor, block_offset: int = 0) -> torch.Tensor:
    """int32[n_blocks] checksums of a (n_blocks, L) lane view.

    ``block_offset`` shifts the block-id salt, so a window of blocks
    starting at ``block_offset`` checksums like the same rows of the leaf.
    """
    return _ops.block_checksums(lanes, block_offset)


def checksum_diff(old_lanes: torch.Tensor, new_lanes: torch.Tensor,
                  block_offset: int = 0) -> torch.Tensor:
    """Per-block incremental checksum delta: cksum' = cksum ^ delta.  A
    (k, n_blocks, L) pair of k shards' views gives int32[k * n_blocks],
    each shard salted by its local block index."""
    nb, L = old_lanes.shape[-2], old_lanes.shape[-1]
    dev = old_lanes.device
    bids = torch.arange(nb, dtype=torch.int32, device=dev)[:, None] + i32(block_offset)
    lids = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    salt = lane_salt(bids, lids)
    h = fmix32_(old_lanes ^ salt)
    h ^= fmix32_(new_lanes ^ salt)
    return xor_fold(h, -1).reshape(-1)


def meta_checksum(checksums: torch.Tensor) -> torch.Tensor:
    """Checksum-of-checksums (paper Algorithm 1, line 22); int32 scalar."""
    return meta_checksum_rows(checksums.reshape(1, -1))[0]


def meta_checksum_rows(checksums: torch.Tensor) -> torch.Tensor:
    """:func:`meta_checksum` of each row of a (k, n_blocks) view: one
    checksum-of-checksums per shard, int32[k]."""
    ids = torch.arange(checksums.shape[1], dtype=torch.int32, device=checksums.device)
    return xor_fold(fmix32_(checksums ^ (ids * GOLDEN)), 1)


def meta_checksum_delta(old_vals: torch.Tensor, new_vals: torch.Tensor,
                        block_ids: torch.Tensor) -> torch.Tensor:
    """XOR-delta of :func:`meta_checksum` from changed entries only:
    ``meta' = meta ^ meta_checksum_delta(old, new, ids)``; entries with
    ``old == new`` contribute zero."""
    salt = block_ids.to(torch.int32) * GOLDEN
    h = fmix32_(old_vals ^ salt)
    h ^= fmix32_(new_vals ^ salt)
    return xor_fold(h.reshape(-1), 0)
