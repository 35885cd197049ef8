"""Plain PyTorch version of the fused masked checksum+parity update
(``csrc/redundancy.cu``): the reference semantics of Algorithm 1 lines
7-18 over a lane view.

* checksums recomputed for dirty blocks only (clean blocks keep stored
  values so scrubbing can still catch their corruption);
* parity recomputed for stripes containing any dirty block.

It recomputes the whole region and then selects, so it is the kernel's
oracle, not a model of its cost.  ``fused_update_many`` is the grouped
form the kernel computes: per job the packed ``dirty | shadow`` words are
unpacked and reduced to stripes first.
"""
from __future__ import annotations

import torch

from ...core import bits
from ..checksum import ref as cref
from ..parity import ref as pref


def fused_update(lanes: torch.Tensor, old_checksums: torch.Tensor,
                 old_parity: torch.Tensor, block_dirty: torch.Tensor,
                 stripe_dirty: torch.Tensor, stripe_width: int):
    cks = torch.where(block_dirty, cref.block_checksums(lanes), old_checksums)
    par = pref.stripe_parity_masked(lanes, old_parity, stripe_dirty, stripe_width)
    return cks, par


def fused_update_many(jobs, stripe_width: int):
    """Per job ``(lanes, checksums, parity, dirty_words)``: the new
    ``(checksums, parity)``, the dirty masks unpacked from the words."""
    out = []
    for lanes, cks, par, words in jobs:
        bd = bits.unpack(words, lanes.shape[0])
        ns = -(-lanes.shape[0] // stripe_width)
        padded = torch.zeros((ns * stripe_width,), dtype=torch.bool, device=bd.device)
        padded[: bd.shape[0]] = bd
        out.append(fused_update(lanes, cks, par, bd, padded.view(ns, stripe_width).any(dim=1),
                                stripe_width))
    return out
