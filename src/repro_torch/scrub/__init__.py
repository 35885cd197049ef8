"""Scrub patroller + online shard rebuild: the port of ``repro.scrub``.

Continuous low-priority verification of protected state between the
paper's scheduled full scrubs, plus reconstruction of a lost shard from
cross-shard parity while the foreground keeps running.  Enabled via
``RedundancyPolicy.patrol_bytes_per_tick``; see :mod:`.patrol` and
:mod:`.rebuild`.
"""
from .patrol import (MAX_REPAIR_ATTEMPTS, OBSERVABILITY_CAP, PROBE_FORCE_TICKS,
                     DetectionEvent, ScrubPatroller, ShardLossConflictError)
from .rebuild import (CrossShardParity, RebuildStatus, ShardRebuilder,
                      pack_mask_np)

__all__ = [
    "ScrubPatroller", "DetectionEvent", "MAX_REPAIR_ATTEMPTS",
    "OBSERVABILITY_CAP", "PROBE_FORCE_TICKS", "ShardRebuilder", "RebuildStatus",
    "CrossShardParity", "pack_mask_np", "ShardLossConflictError",
]
