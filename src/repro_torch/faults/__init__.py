"""Deterministic fault injection and crash-consistency verification.

The port of ``repro.faults``.  The paper's core claim (§5) is that
*delayed* redundancy still bounds data loss: scrub and cross-page parity
detect and repair firmware-induced corruption, and the tunable knob bounds
the vulnerability window.  This package makes that claim executable on
the port's store:

* :mod:`.inject`: a seeded injector that corrupts data blocks, checksums,
  parity and meta-checksums (bit flips, torn multi-stripe writes, stale
  redundancy), through :meth:`repro_torch.core.ProtectedStore.inject`.
* :mod:`.crashpoints`: a crash-point state machine that enumerates the
  pipelined tick's phases, persists the live view at each, and replays
  recovery through ``CheckpointManager.restore_verified``.
* :mod:`.oracle`: the exact vulnerability window of a run, the audit that
  scrub detects 100% of injected corruption outside it with zero false
  positives, and measured detection latencies for
  :mod:`repro_torch.core.mttdl`.

Sharded stores are covered too: specs, windows and injections in global
block space, and ``shard_loss`` of a whole shard, which the patroller
rebuilds from cross-shard parity; the crash machine's ``actions`` can
queue a remesh, whose windows fire ``remesh_migrate``.  The reference's
chaos soak (``repro.faults.chaos``) is not ported yet: ROADMAP.md, Queue 1
item 11.5 (c).

``python -m repro_torch.faults --smoke`` runs the battery (crash sweep,
crash plus corruption, oracle over several seeds, the scrub patroller's
detection on a settled store, the sharded oracle, crash subset and shard
rebuild).
"""
from .inject import FAULT_KINDS, FaultInjector, FaultSpec, apply_fault
from .crashpoints import (CRASH_PHASES, CrashOutcome, CrashPlan,
                          CrashPointMachine)
from .oracle import (DetectionRecord, OracleReport, VulnerabilityWindow,
                     check_detection, vulnerability_window)

__all__ = [
    "FAULT_KINDS", "FaultInjector", "FaultSpec", "apply_fault",
    "CRASH_PHASES", "CrashOutcome", "CrashPlan", "CrashPointMachine",
    "DetectionRecord", "OracleReport", "VulnerabilityWindow",
    "check_detection", "vulnerability_window",
]
