"""Wrapper for the block-checksum kernel K1 (``csrc/checksum.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version in ``ref.py``.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import _build
from . import ref

LAUNCHES = 0


def block_checksums(lanes: torch.Tensor, block_offset: int = 0) -> torch.Tensor:
    """int32[n_blocks] checksums of a (n_blocks, L) int32 lane view."""
    global LAUNCHES
    if lanes.device.type == "cpu":
        return ref.block_checksums(lanes, block_offset)
    _build.require_lanes(lanes, "checksum")
    nb, L = lanes.shape
    out = torch.empty((nb,), dtype=torch.int32, device=lanes.device)
    rc = _build.library().vilamb_checksum(
        lanes.data_ptr(), out.data_ptr(), nb, L, int(block_offset),
        _build.stream_handle(lanes))
    _build.check(rc, "checksum")
    LAUNCHES += 1
    return out
