"""Wrapper for the fused work-queue update kernel K3 (``csrc/redundancy.cu``).

The dirty-stripe mask is compacted into a work queue on the device (a
cumsum and one scatter: the ids in order, and their count); the kernel
reads the count on the device and never the ids past it, so the queue
needs no padding and nothing here waits for the card.  The update is in
place: ``checksums`` and ``parity`` are refreshed under the dirty masks
and returned.  A CPU tensor runs the plain version in ``ref.py`` and
copies its result into the same tensors.  ``LAUNCHES`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from .. import _build
from . import ref

LAUNCHES = 0
MAX_STRIPE = 16      # kMaxStripe in csrc/redundancy.cu
CTAS_PER_SM = 16     # grid = min(n_stripes, SMs * CTAS_PER_SM), striding


def _work_queue(stripe_dirty: torch.Tensor):
    """``(ids, count)``: ``ids[:count]`` are the dirty stripes in order;
    ``count`` is a 1-element int32 tensor.  Entries past ``count`` are left
    unset (the kernel never reads them).  No host sync."""
    ns = stripe_dirty.shape[0]
    pos = torch.cumsum(stripe_dirty, 0, dtype=torch.int32)     # 1-based slot
    buf = torch.empty((ns + 1,), dtype=torch.int32, device=stripe_dirty.device)
    buf[torch.where(stripe_dirty, pos, 0)] = torch.arange(
        ns, dtype=torch.int32, device=stripe_dirty.device)     # clean -> slot 0
    return buf[1:], pos[-1:]


def fused_update(lanes: torch.Tensor, checksums: torch.Tensor,
                 parity: torch.Tensor, block_dirty: torch.Tensor,
                 stripe_dirty: torch.Tensor, stripe_width: int = 4):
    """Masked checksum+parity refresh, in place; returns (checksums, parity).

    Bitwise equal to ``ref.fused_update`` when ``stripe_dirty`` is the
    stripe reduction of ``block_dirty``.
    """
    global LAUNCHES
    if lanes.device.type == "cpu":
        cks, par = ref.fused_update(lanes, checksums, parity, block_dirty,
                                    stripe_dirty, stripe_width)
        checksums.copy_(cks)
        parity.copy_(par)
        return checksums, parity
    _build.require_lanes(lanes, "fused_update")
    if not 1 <= stripe_width <= MAX_STRIPE:
        raise ValueError(f"fused_update: stripe_width must be in 1..{MAX_STRIPE}")
    nb, L = lanes.shape
    ns = -(-nb // stripe_width)
    _build.require(checksums, lanes, torch.int32, (nb,), "fused_update checksums")
    _build.require(parity, lanes, torch.int32, (ns, L), "fused_update parity")
    _build.require(block_dirty, lanes, torch.bool, (nb,), "fused_update block_dirty")
    _build.require(stripe_dirty, lanes, torch.bool, (ns,), "fused_update stripe_dirty")
    if parity.data_ptr() % 16:
        raise ValueError("fused_update: parity must be 16-byte aligned")
    ids, count = _work_queue(stripe_dirty)
    sms = torch.cuda.get_device_properties(lanes.device).multi_processor_count
    rc = _build.library().vilamb_fused_update(
        lanes.data_ptr(), checksums.data_ptr(), parity.data_ptr(),
        block_dirty.data_ptr(), ids.data_ptr(), count.data_ptr(), nb, L,
        stripe_width, min(ns, sms * CTAS_PER_SM), _build.stream_handle(lanes))
    _build.check(rc, "fused_update")
    LAUNCHES += 1
    return checksums, parity
