"""Checkpoints and failure handling: the port of ``repro.ckpt``."""
from .checkpoint import (CheckpointManager, RestoreReport, file_checksum,
                         state_leaves)
from .failure import PreemptionHandler, repair_corruption

__all__ = ["CheckpointManager", "PreemptionHandler", "RestoreReport",
           "file_checksum", "repair_corruption", "state_leaves"]
