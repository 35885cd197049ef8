"""Redundancy state containers."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .blocks import BlockMeta

FIELDS = ("checksums", "parity", "dirty", "shadow", "meta_ck")


@dataclasses.dataclass
class LeafRedundancy:
    """Per-leaf system-redundancy state; every field holds uint32 bits as int32.

    checksums : int32[n_blocks]      per-block fmix32 XOR-fold (paper: CRC32C)
    parity    : int32[n_stripes, L]  stripe XOR parity (paper: parity pages)
    dirty     : int32[n_words]       packed dirty bitvector (paper: PTE bits)
    shadow    : int32[n_words]       persistent shadow copy (paper §3.2)
    meta_ck   : int32[]              checksum-of-checksums (Alg. 1 line 22)
    """
    checksums: torch.Tensor
    parity: torch.Tensor
    dirty: torch.Tensor
    shadow: torch.Tensor
    meta_ck: torch.Tensor


def empty_leaf_red(meta: BlockMeta, device=None) -> LeafRedundancy:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return LeafRedundancy(
        checksums=z(meta.n_blocks),
        parity=z(meta.n_stripes, meta.lanes_per_block),
        dirty=z(meta.n_dirty_words),
        shadow=z(meta.n_dirty_words),
        meta_ck=z(),
    )


RedundancyState = Dict[str, LeafRedundancy]
