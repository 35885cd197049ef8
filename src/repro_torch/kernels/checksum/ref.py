"""Plain PyTorch version of the block-checksum kernel (``csrc/checksum.cu``).

The CPU path of ``ops.block_checksums`` and the kernel's bitwise oracle on
the card.  Written with in-place ops so that one call over an 8 GiB lane
view needs one full-size temporary plus the halving fold.
"""
from __future__ import annotations

import torch

from ..common import GOLDEN, SALT2, fmix32_, i32, xor_fold


def block_checksums(lanes: torch.Tensor, block_offset: int = 0) -> torch.Tensor:
    """int32[n_blocks]: XOR_i fmix32(w_i ^ ((b+off)*GOLDEN ^ i*SALT2)); a
    (k, n_blocks, L) view of k shards gives int32[k * n_blocks], ``b``
    being each shard's local block index.  The view may step any stride
    from one shard to the next (a window of every shard, in place), as the
    kernel's may."""
    nb, L = lanes.shape[-2], lanes.shape[-1]
    dev = lanes.device
    lsalt = torch.arange(L, dtype=torch.int32, device=dev) * SALT2
    bsalt = (torch.arange(nb, dtype=torch.int32, device=dev) + i32(block_offset)) * GOLDEN
    h = lanes ^ lsalt
    h ^= bsalt[:, None]
    return xor_fold(fmix32_(h), -1).reshape(-1)
