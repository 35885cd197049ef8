"""Wrapper for the stripe-parity kernel K2 (``csrc/parity.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version in ``ref.py``.  ``LAUNCHES`` counts kernel launches.  The kernel
reads the lane view in place: a partial last stripe is zero-padded inside
the kernel, never by copying the view.
"""
from __future__ import annotations

import torch

from .. import _build
from . import ref

LAUNCHES = 0


def stripe_parity(lanes: torch.Tensor, stripe_width: int = 4) -> torch.Tensor:
    """int32[n_stripes, L] XOR parity of a (n_blocks, L) int32 lane view."""
    global LAUNCHES
    if lanes.device.type == "cpu":
        return ref.stripe_parity(lanes, stripe_width)
    _build.require_lanes(lanes, "parity")
    if stripe_width < 1:
        raise ValueError(f"parity: stripe_width must be >= 1, got {stripe_width}")
    nb, L = lanes.shape
    out = torch.empty((-(-nb // stripe_width), L), dtype=torch.int32,
                      device=lanes.device)
    rc = _build.library().vilamb_parity(
        lanes.data_ptr(), out.data_ptr(), nb, L, stripe_width,
        _build.stream_handle(lanes))
    _build.check(rc, "parity")
    LAUNCHES += 1
    return out
