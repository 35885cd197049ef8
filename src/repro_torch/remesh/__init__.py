"""Elastic remesh: online shard grow and shrink by incremental re-striping.

The port of ``repro.remesh``.  ``ProtectedStore.remesh(new_mesh)``
migrates every protected leaf onto a grown or shrunk mesh over bounded
per-tick windows, with no stop-the-world re-attach; see
:mod:`repro_torch.remesh.migrate`.
"""
from .migrate import (RemeshError, RemeshGeometryError, RemeshInProgressError,
                      RemeshMigrator, RemeshStatus, translate_marks,
                      translate_marks_global, translate_words, validate_remesh)

__all__ = [
    "RemeshError", "RemeshGeometryError", "RemeshInProgressError",
    "RemeshMigrator", "RemeshStatus", "translate_marks",
    "translate_marks_global", "translate_words", "validate_remesh",
]
