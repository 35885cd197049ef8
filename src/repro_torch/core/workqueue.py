"""Work-queue compaction for Algorithm 1 in plain torch.

The CPU path of the tick and the bitwise oracle of the fused CUDA kernel:

1. **Compact** dirty-stripe ids into a fixed-capacity queue (static size
   ``K``, padded with the out-of-range sentinel ``n_stripes``).
2. **Gather** only those stripes into a ``(K, P, L)`` slab that feeds both
   checksum and parity.
3. **Compute** per-member checksums and the stripe XOR parity on the slab.
4. **Scatter** results back under the dirty masks; sentinel rows drop.
5. Update the meta-checksum incrementally from the changed checksums.

Nothing here synchronises with the device: compaction is a cumsum plus a
scatter, and a sentinel-dropping scatter writes ``new - old`` as an
integer add that is zero on dropped rows.  Overflow (more dirty stripes
than the capacity) is a host-side dispatch decision (``queue_fits``).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..kernels.common import xor_fold
from . import checksum, parity

DEFAULT_QUEUE_FRAC = 0.125   # queue capacity as a fraction of n_stripes
MIN_QUEUE_STRIPES = 4


def queue_capacity(n_stripes: int, frac: float,
                   min_stripes: int = MIN_QUEUE_STRIPES) -> int:
    """Static per-leaf queue capacity; 0 disables compaction (a capacity
    >= n_stripes would gather everything and is reported as 0)."""
    if frac <= 0.0 or n_stripes <= 1:
        return 0
    cap = max(min_stripes, math.ceil(n_stripes * frac))
    if cap >= n_stripes:
        return 0
    return cap


def compact_stripe_ids(stripe_dirty: torch.Tensor, size: int, *,
                       pad_repeat_last: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact a bool[n_stripes] mask into int32 ids of static length ``size``.

    Returns ``(ids, count, overflow)`` exactly as the reference's
    ``jnp.nonzero(size=, fill_value=)`` form: the first ``size`` set
    positions in order, padded with the sentinel ``n_stripes`` — or, with
    ``pad_repeat_last`` (the convention of the reference's Pallas kernel),
    padded with the last live id (0 when none is set).  ``overflow`` is True when more than ``size``
    bits are set (``ids`` is then truncated).
    """
    ns = stripe_dirty.shape[0]
    dev = stripe_dirty.device
    fill = 0 if pad_repeat_last else ns
    pos = torch.cumsum(stripe_dirty, 0, dtype=torch.int64) - 1
    keep = stripe_dirty & (pos < size)
    buf = torch.full((size + 1,), fill, dtype=torch.int32, device=dev)
    buf[torch.where(keep, pos, size)] = torch.arange(ns, dtype=torch.int32, device=dev)
    ids = buf[:size]
    count = stripe_dirty.sum(dtype=torch.int32)
    if pad_repeat_last:
        last = ids[(torch.clamp(count, max=size) - 1).clamp(min=0)]
        ids = torch.where(torch.arange(size, device=dev) < count, ids, last)
    return ids, count, count > size


def stripe_fits(stripe_dirty: torch.Tensor, capacity: int) -> torch.Tensor:
    """Device-side fit check: do the dirty stripes fit a ``capacity`` queue?"""
    return stripe_dirty.sum(dtype=torch.int32) <= capacity


def fold_fits_host(fits_row) -> bool:
    """Host-side AND-fold of one group's fetched fit signal."""
    if isinstance(fits_row, torch.Tensor):
        fits_row = fits_row.cpu().numpy()
    return bool(np.asarray(fits_row).all())


def scatter_set(dst: torch.Tensor, index: torch.Tensor, values: torch.Tensor,
                keep: torch.Tensor) -> torch.Tensor:
    """``dst[index[keep]] = values[keep]`` in place, without a host sync.

    The kept indices must be distinct.  Dropped rows add zero; kept rows
    add ``new - old`` (int32 wraps), which lands ``new`` exactly.
    """
    safe = torch.where(keep, index, 0)
    expand = keep.reshape(keep.shape + (1,) * (values.dim() - keep.dim()))
    add = torch.where(expand, values - dst[safe], 0)
    dst.index_put_((safe,), add, accumulate=True)
    return dst


def queued_update(lanes: torch.Tensor, old_cks: torch.Tensor,
                  old_par: torch.Tensor, old_meta: torch.Tensor,
                  bdirty: torch.Tensor, ids: torch.Tensor, stripe_width: int):
    """Gather→compute→scatter one compacted work queue (Alg. 1 lines 7-22).

    ``ids`` comes from :func:`compact_stripe_ids` (sentinel padding), and
    every dirty stripe must be in it (the caller checked ``queue_fits``).
    Returns new ``(checksums, parity, meta_ck)``; the inputs are untouched.
    """
    nb, L = lanes.shape
    ns = old_par.shape[0]
    P = stripe_width
    dev = lanes.device
    ids = ids.to(torch.int64)
    valid_q = ids < ns
    safe_sid = torch.clamp(ids, max=ns - 1)
    block_ids = safe_sid[:, None] * P + torch.arange(P, dtype=torch.int64, device=dev)[None, :]
    in_leaf = block_ids < nb
    safe_bid = torch.clamp(block_ids, max=nb - 1)
    slab = torch.where(in_leaf[:, :, None], lanes[safe_bid], 0)
    par_rows = xor_fold(slab, 1)
    salt = checksum.lane_salt(block_ids[:, :, None],
                              torch.arange(L, dtype=torch.int32, device=dev)[None, None, :])
    cks_rows = xor_fold(checksum.fmix32_(slab ^ salt), 2)
    upd = valid_q[:, None] & in_leaf & bdirty[safe_bid]
    cks = scatter_set(old_cks.clone(), block_ids.reshape(-1), cks_rows.reshape(-1),
                      upd.reshape(-1))
    par = scatter_set(old_par.clone(), ids, par_rows, valid_q)
    old_vals = torch.where(upd, old_cks[safe_bid], 0)
    new_vals = torch.where(upd, cks_rows, old_vals)
    meta = old_meta ^ checksum.meta_checksum_delta(
        old_vals.reshape(-1), new_vals.reshape(-1),
        torch.where(upd, block_ids, 0).reshape(-1))
    return cks, par, meta


def full_update(lanes, old_cks, old_par, bdirty, sdirty, stripe_width):
    """Reference full-region masked recompute (the pre-queue semantics)."""
    cks = torch.where(bdirty, checksum.block_checksums(lanes), old_cks)
    par = parity.stripe_parity_masked(lanes, old_par, sdirty, stripe_width)
    return cks, par, checksum.meta_checksum(cks)
