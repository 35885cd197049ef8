"""Cross-block XOR parity stripes (paper's cross-page parity).

Stripes are ``P`` consecutive data blocks plus one parity block (paper
default: 4+1).  Parity lives in a separate array (``int32[n_stripes, L]``).
``stripe_parity`` launches the hand-written CUDA kernel for a tensor on the
card and runs its plain version on the CPU.
"""
from __future__ import annotations

import torch

from ..kernels.parity import ops as _ops


def stripe_parity(lanes: torch.Tensor, stripe_width: int) -> torch.Tensor:
    """XOR parity for every stripe: int32[n_stripes, L]."""
    return _ops.stripe_parity(lanes, stripe_width)


def stripe_parity_masked(lanes: torch.Tensor, old_parity: torch.Tensor,
                         stripe_dirty: torch.Tensor,
                         stripe_width: int) -> torch.Tensor:
    """Recompute parity only for dirty stripes; clean stripes keep old parity."""
    return torch.where(stripe_dirty[:, None], stripe_parity(lanes, stripe_width),
                       old_parity)


def parity_diff(old_lanes: torch.Tensor, new_lanes: torch.Tensor,
                stripe_width: int) -> torch.Tensor:
    """Pangolin-mode incremental parity delta: parity' = parity ^ delta."""
    return stripe_parity(old_lanes ^ new_lanes, stripe_width)


def scatter_xor_stripes(parity: torch.Tensor, stripe_ids: torch.Tensor,
                        deltas: torch.Tensor) -> torch.Tensor:
    """``parity[s] ^= XOR of deltas with stripe_ids == s``, in place.

    Ids may repeat; out-of-range ids (``>= n_stripes``) are dropped.  Torch
    has no XOR scatter-reduce, so rows are sorted by stripe id, a segmented
    XOR scan (log2(n) doubling passes) folds each stripe's deltas into its
    last row, and that row lands as an integer add of ``new - old`` — the
    adds of distinct stripes never collide and int32 wraps, so the write is
    exact and never synchronises with the host.  Returns ``parity``.
    """
    ns = parity.shape[0]
    n = stripe_ids.shape[0]
    if n == 0:
        return parity
    sid = stripe_ids.to(torch.int64)
    valid = (sid >= 0) & (sid < ns)
    sid = torch.where(valid, sid, 0)
    d = torch.where(valid[:, None], deltas, 0)
    sid, order = torch.sort(sid, stable=True)
    d = d[order]
    k = 1
    while k < n:
        same = (sid[k:] == sid[:-k])[:, None]
        nxt = d.clone()
        nxt[k:] ^= torch.where(same, d[:-k], 0)
        d, k = nxt, 2 * k
    is_last = torch.ones((n,), dtype=torch.bool, device=sid.device)
    is_last[:-1] = sid[1:] != sid[:-1]
    cur = parity[sid]
    add = torch.where(is_last[:, None], (cur ^ d) - cur, 0)
    parity.index_put_((sid,), add, accumulate=True)
    return parity


def reconstruct_block(lanes: torch.Tensor, parity_row: torch.Tensor,
                      stripe_width: int, block_id: int,
                      stripe_id: int) -> torch.Tensor:
    """Rebuild one block from its stripe: XOR of parity and the other members.

    Members past the end of the leaf (a partial last stripe) count as zero.
    The caller must ensure every other member is clean and parity is
    current (the paper's vulnerable-stripe rule, §3.3).
    """
    nb = lanes.shape[0]
    acc = parity_row.clone()
    for b in range(stripe_id * stripe_width, (stripe_id + 1) * stripe_width):
        if b != block_id and b < nb:
            acc ^= lanes[b]
    return acc
