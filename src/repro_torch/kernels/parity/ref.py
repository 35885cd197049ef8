"""Plain PyTorch version of the stripe-parity kernel (``csrc/parity.cu``).

The CPU path of ``ops.stripe_parity`` and the kernel's bitwise oracle on
the card.
"""
from __future__ import annotations

import torch

from ..common import xor_fold


def striped(lanes: torch.Tensor, stripe_width: int) -> torch.Tensor:
    """(n_blocks, L) -> (n_stripes, P, L), zero-padding trailing blocks
    (a view when n_blocks % P == 0, a copy otherwise)."""
    nb, L = lanes.shape
    ns = -(-nb // stripe_width)
    if ns * stripe_width != nb:
        padded = torch.zeros((ns * stripe_width, L), dtype=lanes.dtype,
                             device=lanes.device)
        padded[:nb] = lanes
        lanes = padded
    return lanes.reshape(ns, stripe_width, L)


def stripe_parity(lanes: torch.Tensor, stripe_width: int) -> torch.Tensor:
    """XOR parity for every stripe: int32[n_stripes, L]; of a (k, n_blocks,
    L) view of k shards, int32[k * n_stripes, L], shard after shard."""
    if lanes.dim() == 3:
        return torch.cat([xor_fold(striped(s, stripe_width), 1) for s in lanes])
    return xor_fold(striped(lanes, stripe_width), 1)


def stripe_parity_masked(lanes: torch.Tensor, old_parity: torch.Tensor,
                         stripe_dirty: torch.Tensor,
                         stripe_width: int) -> torch.Tensor:
    """Recompute parity only for dirty stripes; clean stripes keep old parity."""
    return torch.where(stripe_dirty[:, None], stripe_parity(lanes, stripe_width),
                       old_parity)
