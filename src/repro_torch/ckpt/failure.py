"""Failure handling: the preemption flush (the paper's battery) and
corruption repair.  The port of ``repro.ckpt.failure``.

The paper's battery guarantees that redundancy is brought up to date on a
power failure (§3.3).  The fleet analogue: SIGTERM arrives with a grace
window; the handler (1) forces a redundancy flush (Algorithm 1 over all
dirty state), (2) writes a checkpoint, (3) exits with a restartable code.
§4.7's battery sizing becomes "flush seconds within the grace budget".
"""
from __future__ import annotations

import dataclasses
import signal
import time
import warnings
from typing import Any, Optional

import torch

from ..core.repairs import (plan_stripe_repairs, repair_blocks,
                            vulnerable_unrecoverable)


@dataclasses.dataclass
class PreemptionHandler:
    grace_seconds: float = 30.0
    exit_code: int = 42          # restartable by the job scheduler

    def __post_init__(self):
        self._requested = False
        self._flush_seconds: Optional[float] = None
        self._previous: dict = {}

    def install(self):
        """Take SIGTERM and SIGUSR1 (the test hook); ``uninstall`` puts the
        previous handlers back."""
        self._previous = {s: signal.signal(s, self._on_signal)
                          for s in (signal.SIGTERM, signal.SIGUSR1)}
        return self

    def uninstall(self) -> None:
        for s, h in self._previous.items():
            signal.signal(s, h)
        self._previous = {}

    def _on_signal(self, signum, frame):
        self._requested = True

    @property
    def requested(self) -> bool:
        return self._requested

    def drain(self, trainer, state, ckpt=None) -> Any:
        """Flush redundancy and checkpoint within the grace budget.

        The clock stops once the device has finished the flush: on the card
        a device-wide synchronise, which also waits for the store's side
        stream (the reference's ``block_until_ready``).  ``flush_seconds``
        is the battery metric."""
        t0 = time.perf_counter()
        state = trainer.flush(state)              # battery analogue
        device = getattr(trainer.model, "device", None)
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        self._flush_seconds = time.perf_counter() - t0
        if ckpt is not None:
            ckpt.save(int(state.step), state, blocking=True)
        return state

    @property
    def flush_seconds(self) -> Optional[float]:
        return self._flush_seconds


def repair_corruption(engine, leaves, red, mismatches, details=None) -> tuple:
    """Recover every detected-corrupt block from parity.  Returns
    ``(repaired_leaves, n_fixed, n_lost)``.

    ``engine`` is anything exposing ``recover_block`` and ``metas``: a
    RedundancyEngine or a ProtectedStore.  Blocks are rebuilt in place
    (see :func:`~repro_torch.core.repairs.repair_blocks`).

    Two unrecoverable classes are refused loudly, never papered over:
    blocks in vulnerable stripes (another member dirty or shadow-set:
    parity is stale there, paper §3.3), and two or more detected-corrupt
    blocks sharing one parity group (XOR parity corrects single failures;
    the whole stripe is counted lost and a warning names it).

    ``details`` (optional list) collects one structured
    :class:`~repro_torch.core.repairs.UnrecoverableBlock` per refused
    stripe.  Callers fall back to a checkpoint for lost blocks
    (``CheckpointManager.restore_verified`` does so).
    """
    singles, unrec = plan_stripe_repairs(engine.metas, mismatches)
    for u in unrec:
        warnings.warn(
            f"{u.leaf}: {len(u.blocks)} corrupt blocks {list(u.blocks)} share "
            f"parity group {u.stripe}; XOR parity corrects single failures — "
            "counting the stripe as lost (restore from checkpoint)",
            RuntimeWarning, stacklevel=2)
    leaves, fixed, vulnerable = repair_blocks(engine, leaves, red, singles)
    unrec = unrec + vulnerable_unrecoverable(engine.metas, vulnerable)
    if details is not None:
        details.extend(unrec)
    lost = sum(len(u.blocks) for u in unrec)
    return leaves, len(fixed), lost
