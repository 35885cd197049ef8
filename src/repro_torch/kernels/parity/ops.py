"""Wrapper for the stripe-parity kernel K2 (``csrc/parity.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version in ``ref.py``; a ``meta`` tensor runs the card's checks and gets
the card's output shape, with nothing launched (the dry run).
``LAUNCHES`` counts kernel launches.  On every device the call reports one
launch and its work to an active cost counter (``launch.cost_analysis``).
The kernel reads the lane view in place: a partial last stripe is
zero-padded inside the kernel, never by copying the view.
"""
from __future__ import annotations

import torch

from ...launch import cost_analysis
from .. import _build
from . import ref

LAUNCHES = 0
MAX_SHARDS = 65535   # the launch grid's y dimension


def stripe_parity(lanes: torch.Tensor, stripe_width: int = 4) -> torch.Tensor:
    """int32[n_stripes, L] XOR parity of a (n_blocks, L) int32 lane view, or
    int32[k * n_stripes, L] of a (k, n_blocks, L) view of k shards (stripe
    ``t`` is stripe ``t mod n_stripes`` of shard ``t div n_stripes``; a
    stripe never spans shards), all in one launch."""
    with cost_analysis.launch("parity", lambda: _work(lanes, stripe_width)):
        return _parity(lanes, stripe_width)


def _work(lanes: torch.Tensor, stripe_width: int):
    k = lanes.shape[0] if lanes.dim() == 3 else 1
    nb, L = lanes.shape[-2], lanes.shape[-1]
    n_bytes, ops = cost_analysis.parity_work(k * nb, k * -(-nb // stripe_width), L)
    return 1, 0, n_bytes, ops


def _parity(lanes: torch.Tensor, stripe_width: int) -> torch.Tensor:
    global LAUNCHES
    if lanes.device.type == "cpu":
        return ref.stripe_parity(lanes, stripe_width)
    _build.require_lanes(lanes, "parity")
    if lanes.dim() == 3 and not 1 <= lanes.shape[0] <= MAX_SHARDS:
        raise ValueError(f"parity: 1..{MAX_SHARDS} shards a launch, got {lanes.shape[0]}")
    if stripe_width < 1:
        raise ValueError(f"parity: stripe_width must be >= 1, got {stripe_width}")
    nb, L = lanes.shape[-2], lanes.shape[-1]
    k = lanes.shape[0] if lanes.dim() == 3 else 1
    out = torch.empty((k * -(-nb // stripe_width), L), dtype=torch.int32,
                      device=lanes.device)
    if lanes.device.type == "meta":
        return out
    rc = _build.library().vilamb_parity(
        lanes.data_ptr(), out.data_ptr(), nb, L, stripe_width, k,
        _build.stream_handle(lanes))
    _build.check(rc, "parity")
    LAUNCHES += 1
    return out
