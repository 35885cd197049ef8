"""Vilamb core on torch tensors: asynchronous system-redundancy.

Public API: :class:`ProtectedStore` + :class:`RedundancyPolicy` own the
lifecycle (attach / on_write / tick / flush).  :class:`RedundancyEngine`
is the per-group target underneath.  uint32 bit patterns are carried as
int32 tensors; :mod:`.convert` moves state to and from numpy.
"""
from . import convert
from .blocks import BlockMeta, ShapeDtype, from_lanes, make_meta, to_lanes
from .checksum import (block_checksums, checksum_diff, fmix32, meta_checksum,
                       meta_checksum_delta)
from .engine import ALL, RedundancyConfig, RedundancyEngine
from .parity import (parity_diff, reconstruct_block, scatter_xor_stripes,
                     stripe_parity, stripe_parity_masked)
from .state import LeafRedundancy, RedundancyState, empty_leaf_red
from .store import (LeafPolicy, ProtectedStore, RedundancyPolicy,
                    StragglerGovernor, TickReport)
from .workqueue import (compact_stripe_ids, full_update, queue_capacity,
                        queued_update)

__all__ = [
    "ALL", "BlockMeta", "LeafPolicy", "LeafRedundancy", "ProtectedStore",
    "RedundancyConfig", "RedundancyEngine", "RedundancyPolicy",
    "RedundancyState", "ShapeDtype", "StragglerGovernor", "TickReport", "block_checksums",
    "checksum_diff", "compact_stripe_ids", "convert", "empty_leaf_red", "fmix32",
    "from_lanes", "full_update", "make_meta", "meta_checksum",
    "meta_checksum_delta", "parity_diff", "queue_capacity", "queued_update",
    "reconstruct_block", "scatter_xor_stripes", "stripe_parity",
    "stripe_parity_masked", "to_lanes",
]
