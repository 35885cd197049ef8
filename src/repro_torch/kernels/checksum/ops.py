"""Wrapper for the block-checksum kernel K1 (``csrc/checksum.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version in ``ref.py``; a ``meta`` tensor runs the card's checks and gets
the card's output shape, with nothing launched (the dry run).
``LAUNCHES`` counts kernel launches.  On every device the call reports one
launch and its work to an active cost counter (``launch.cost_analysis``).
"""
from __future__ import annotations

import torch

from ...launch import cost_analysis
from .. import _build
from . import ref

LAUNCHES = 0
MAX_SHARDS = 65535   # the launch grid's y dimension


def block_checksums(lanes: torch.Tensor, block_offset: int = 0) -> torch.Tensor:
    """int32[n_blocks] checksums of a (n_blocks, L) int32 lane view, or
    int32[k * n_blocks] of a (k, n_blocks, L) view of k shards, each salted
    by its local block index (+ ``block_offset``), all in one launch.

    The shards of a 3-D view need not be adjacent: each shard's rows are
    contiguous, and the kernel steps ``lanes.stride(0)`` lanes from one
    shard to the next, so a window of every row-range shard of a leaf
    (``leaf_lanes[:, start:start + w]``) is read in place."""
    with cost_analysis.launch("checksum", lambda: _work(lanes)):
        return _checksums(lanes, block_offset)


def _work(lanes: torch.Tensor):
    n_bytes, ops = cost_analysis.checksum_work(
        lanes.shape[-2] * (lanes.shape[0] if lanes.dim() == 3 else 1), lanes.shape[-1])
    return 1, 0, n_bytes, ops


def _checksums(lanes: torch.Tensor, block_offset: int) -> torch.Tensor:
    global LAUNCHES
    if lanes.device.type == "cpu":
        return ref.block_checksums(lanes, block_offset)
    _build.require_lanes(lanes, "checksum", strided_shards=True)
    if lanes.dim() == 3 and not 1 <= lanes.shape[0] <= MAX_SHARDS:
        raise ValueError(f"checksum: 1..{MAX_SHARDS} shards a launch, got {lanes.shape[0]}")
    nb, L = lanes.shape[-2], lanes.shape[-1]
    k = lanes.shape[0] if lanes.dim() == 3 else 1
    stride = lanes.stride(0) if k > 1 else nb * L
    out = torch.empty((k * nb,), dtype=torch.int32, device=lanes.device)
    if lanes.device.type == "meta":
        return out
    rc = _build.library().vilamb_checksum(
        lanes.data_ptr(), out.data_ptr(), nb, L, int(block_offset), k, stride,
        _build.stream_handle(lanes))
    _build.check(rc, "checksum")
    LAUNCHES += 1
    return out
