"""Vulnerability-window oracle (paper §5 made executable).

The port of ``repro.faults.oracle``.  A corruption is *detectable* (and a
single-block one *repairable*) iff it lands in a block whose redundancy
is fresh, i.e. outside the **vulnerability window**: the blocks marked in
``dirty | shadow`` (writes since the last consumed snapshot, plus the
snapshot an in-flight overlapped update is covering).  The freshness knob
(``max_vulnerable_steps`` / ``_seconds``) bounds how long a block may
stay in that set.

This module computes the window from live state and audits a run:

* every injected corruption **outside** the window must be detected by
  scrub (100% detection), and
* scrub must report **nothing else** (zero false positives), and
* every *missed* corruption must lie **inside** the window.

Detection latencies measured against scheduled scrubs feed
:func:`repro_torch.core.mttdl.mttdl_measured`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.bits import bits_to_mask
from .inject import FaultSpec

# Fault kinds that skew data vs redundancy of specific blocks: the kinds a
# *scrub* is responsible for catching.  Redundancy-side faults (checksum,
# parity, meta bitflips) are audited by verify_meta / repair verification.
DATA_FAULT_KINDS = ("data_bitflip", "torn_write", "stale_redundancy")


@dataclasses.dataclass
class VulnerabilityWindow:
    """Per-leaf block masks of the instantaneous vulnerability window."""
    blocks: Dict[str, np.ndarray]          # bool[n_blocks], True = vulnerable
    stripes: Dict[str, np.ndarray]         # bool[n_stripes]

    def contains(self, leaf: str, block: int) -> bool:
        return bool(self.blocks[leaf][block])

    def n_vulnerable_stripes(self) -> int:
        return int(sum(int(m.sum()) for m in self.stripes.values()))


def vulnerability_window(store, red) -> VulnerabilityWindow:
    """The exact current window from the epoch double-buffer state:
    ``dirty | shadow`` per protected leaf, unpacked on the host, and its
    stripe view (Algorithm 1's block-to-stripe reduction).  Sharded leaves
    unpack shard by shard into global block and stripe space."""
    blocks: Dict[str, np.ndarray] = {}
    stripes: Dict[str, np.ndarray] = {}
    factor = getattr(store, "shard_factor", lambda n: 1)
    for name, meta in store.protected_metas.items():
        r = red[name]
        k = int(factor(name))
        live = (r.dirty | r.shadow).cpu().numpy()
        bmask = bits_to_mask(live, meta.n_blocks, shards=k)
        blocks[name] = bmask
        padded = np.zeros((k, meta.padded_blocks), bool)
        padded[:, :meta.n_blocks] = bmask.reshape(k, meta.n_blocks)
        stripes[name] = padded.reshape(
            k * meta.n_stripes, meta.stripe_data_blocks).any(axis=1)
    return VulnerabilityWindow(blocks=blocks, stripes=stripes)


@dataclasses.dataclass
class OracleReport:
    """Audit result of one scrub against a set of injected faults."""
    detected: Dict[str, Set[int]]          # leaf -> blocks scrub flagged
    expected: Dict[str, Set[int]]          # injected data-faults outside window
    in_window: Dict[str, Set[int]]         # injected data-faults inside window
    false_positives: Dict[str, Set[int]]   # flagged but never injected
    missed: Dict[str, Set[int]]            # outside window but not flagged

    @property
    def ok(self) -> bool:
        return not any(self.false_positives.values()) and not any(
            self.missed.values())

    def summary(self) -> str:
        n = lambda d: sum(len(v) for v in d.values())
        return (f"detected={n(self.detected)} expected={n(self.expected)} "
                f"in_window={n(self.in_window)} "
                f"false_pos={n(self.false_positives)} missed={n(self.missed)}")


def _injected_blocks(specs: Sequence[FaultSpec]) -> Dict[str, Set[int]]:
    out: Dict[str, Set[int]] = {}
    for s in specs:
        if s.kind in DATA_FAULT_KINDS:
            out.setdefault(s.leaf, set()).update(s.touched_blocks)
    return out


def _flagged(mask) -> Set[int]:
    return set(np.flatnonzero(mask.cpu().numpy()).tolist())


def check_detection(store, leaves, red, specs: Sequence[FaultSpec],
                    window: Optional[VulnerabilityWindow] = None
                    ) -> OracleReport:
    """Scrub and audit: 100% detection outside the window, zero false
    positives, misses only inside the window.

    ``window`` defaults to the window at call time; pass the window taken
    *at injection time* when the run kept mutating state between injection
    and scrub (blocks may have left the window since, which only makes
    detection easier).
    """
    if window is None:
        window = vulnerability_window(store, red)
    mm = store.scrub(leaves, red)
    detected = {name: _flagged(mask) for name, mask in mm.items()}
    injected = _injected_blocks(specs)
    expected: Dict[str, Set[int]] = {}
    in_window: Dict[str, Set[int]] = {}
    for name, blks in injected.items():
        for b in blks:
            if window.contains(name, b):
                in_window.setdefault(name, set()).add(b)
            else:
                expected.setdefault(name, set()).add(b)
    false_positives = {
        name: blks - injected.get(name, set())
        for name, blks in detected.items() if blks - injected.get(name, set())}
    missed = {
        name: blks - detected.get(name, set())
        for name, blks in expected.items() if blks - detected.get(name, set())}
    return OracleReport(detected=detected, expected=expected,
                        in_window=in_window, false_positives=false_positives,
                        missed=missed)


# ------------------------------------------------------- detection latency
@dataclasses.dataclass
class DetectionRecord:
    """One injected corruption's life cycle against scheduled scrubs."""
    spec: FaultSpec
    injected_step: int
    detected_step: Optional[int] = None    # None = never detected (in window)
    in_window_at_injection: bool = False

    @property
    def latency_steps(self) -> Optional[int]:
        if self.detected_step is None:
            return None
        return self.detected_step - self.injected_step


def measure_detection_latency(store, drive,
                              inject_at: Mapping[int, Sequence[FaultSpec]],
                              steps: int, scrub_period: int
                              ) -> List[DetectionRecord]:
    """Drive a workload, injecting per ``inject_at[step]`` and recording the
    first scheduled scrub that flags each corrupted block.

    ``drive(step, leaves, red) -> (leaves, red)`` applies the workload's
    own write+tick for one step (scrubbing is done here, so latencies are
    attributed exactly).  Returns one record per injected spec.
    """
    records: List[DetectionRecord] = []
    live: Dict[Tuple[str, int], DetectionRecord] = {}
    leaves, red = drive(0, None, None)       # step 0 = init convention
    for step in range(1, steps + 1):
        leaves, red = drive(step, leaves, red)
        for spec in inject_at.get(step, ()):
            window = vulnerability_window(store, red)
            leaves, red = store.inject(leaves, red, spec)
            rec = DetectionRecord(
                spec=spec, injected_step=step,
                in_window_at_injection=any(
                    window.contains(spec.leaf, b)
                    for b in spec.touched_blocks))
            records.append(rec)
            for b in spec.touched_blocks:
                live.setdefault((spec.leaf, b), rec)
        if scrub_period and step % scrub_period == 0:
            mm = store.scrub(leaves, red)
            for name, mask in mm.items():
                for b in sorted(_flagged(mask)):
                    rec = live.pop((name, int(b)), None)
                    if rec is not None and rec.detected_step is None:
                        rec.detected_step = step
    return records
