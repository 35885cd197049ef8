"""Plain PyTorch version of the fused masked checksum+parity update
(``csrc/redundancy.cu``): the reference semantics of Algorithm 1 lines
7-18 over a lane view.

* checksums recomputed for dirty blocks only (clean blocks keep stored
  values so scrubbing can still catch their corruption);
* parity recomputed for stripes containing any dirty block.

It recomputes the whole region and then selects, so it is the kernel's
oracle, not a model of its cost.
"""
from __future__ import annotations

import torch

from ..checksum import ref as cref
from ..parity import ref as pref


def fused_update(lanes: torch.Tensor, old_checksums: torch.Tensor,
                 old_parity: torch.Tensor, block_dirty: torch.Tensor,
                 stripe_dirty: torch.Tensor, stripe_width: int):
    cks = torch.where(block_dirty, cref.block_checksums(lanes), old_checksums)
    par = pref.stripe_parity_masked(lanes, old_parity, stripe_dirty, stripe_width)
    return cks, par
