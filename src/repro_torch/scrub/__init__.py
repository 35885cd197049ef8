"""Scrub patroller: the port of ``repro.scrub``, machine-local.

Continuous low-priority verification of protected state between the
paper's scheduled full scrubs.  Enabled via
``RedundancyPolicy.patrol_bytes_per_tick``; see :mod:`.patrol`.  The
reference's online shard rebuild (``ShardRebuilder``, ``RebuildStatus``,
``CrossShardParity``, ``pack_mask_np``) is ROADMAP.md, Queue 1 item 11.4.
"""
from .patrol import (MAX_REPAIR_ATTEMPTS, OBSERVABILITY_CAP, PROBE_FORCE_TICKS,
                     DetectionEvent, ScrubPatroller, ShardLossConflictError)

__all__ = [
    "ScrubPatroller", "DetectionEvent", "MAX_REPAIR_ATTEMPTS",
    "OBSERVABILITY_CAP", "PROBE_FORCE_TICKS", "ShardLossConflictError",
]
