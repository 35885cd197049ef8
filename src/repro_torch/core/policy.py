"""Update scheduling + flush budget — paper §3.3 battery / §4.7 cost model.

On preemption the launcher must finish pending redundancy updates (flush)
within a grace budget.  This module sizes that flush from dirty state and
prices the paper's battery equivalents.  The device's memory rate is an
argument: the store measures a device-to-device copy rate on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

# Paper §4.7 constants.
ULTRACAP_DOLLARS_PER_KJ = 2.85
LIION_DOLLARS_PER_KJ = 0.02
SERVER_WATTS = 500.0


@dataclasses.dataclass(frozen=True)
class FlushEstimate:
    dirty_bytes: int          # data read to recompute checksums
    stripe_bytes: int         # stripe reads for parity
    write_bytes: int          # checksum + parity writes
    seconds: float            # at the given memory rate (memory-bound)
    energy_kj: float
    ultracap_dollars: float
    liion_dollars: float


def should_update(step: int, period_steps: int) -> bool:
    return period_steps > 0 and step % period_steps == 0 and step > 0


def should_scrub(step: int, scrub_period_steps: int) -> bool:
    return scrub_period_steps > 0 and step % scrub_period_steps == 0 and step > 0


def estimate_flush(dirty_stats: Mapping[str, Mapping[str, int]],
                   bytes_per_block: Mapping[str, int], stripe_blocks: int,
                   bytes_per_sec: float) -> FlushEstimate:
    """Size the preemption flush from live dirty state.

    The fused update reads every vulnerable stripe once (covering the dirty
    blocks' checksum read) and writes parity rows and checksums; the flush
    is memory-bound, so seconds = bytes / ``bytes_per_sec``.
    """
    if bytes_per_sec <= 0:
        raise ValueError(f"bytes_per_sec must be positive, got {bytes_per_sec}")
    dirty_b = stripe_b = write_b = 0
    for name, s in dirty_stats.items():
        bpb = bytes_per_block[name]
        dirty_b += int(s["dirty_blocks"]) * bpb
        stripe_b += int(s["vulnerable_stripes"]) * stripe_blocks * bpb
        write_b += int(s["vulnerable_stripes"]) * bpb + int(s["dirty_blocks"]) * 4
    seconds = (max(dirty_b, stripe_b) + write_b) / bytes_per_sec
    energy_kj = seconds * SERVER_WATTS / 1e3
    return FlushEstimate(
        dirty_bytes=dirty_b, stripe_bytes=stripe_b, write_bytes=write_b,
        seconds=seconds, energy_kj=energy_kj,
        ultracap_dollars=energy_kj * ULTRACAP_DOLLARS_PER_KJ,
        liion_dollars=energy_kj * LIION_DOLLARS_PER_KJ)
