"""Tick-scheduled scrub patroller.

The port of ``repro.scrub.patrol``, machine-local.  The paper's scheduled
scrub (``ProtectedStore.scrub``) reads every block of every leaf in one
pass — fine at checkpoint boundaries, far too heavy to run often, so
silent corruption sits latent for most of a scrub period.  The patroller
closes that gap with a **continuous low-priority sweep**: a cursor walks
block space and each quiet tick verifies one bounded window
(``patrol_bytes_per_tick``) of one leaf against its stored checksums —
the same comparison as scrub, paced so foreground work never waits on a
full-leaf pass.  Detection latency drops from "next scheduled scrub" to
"next sweep", which feeds the measured-MTTDL model
(:func:`repro_torch.core.mttdl.mttdl_measured`) directly.

Duty order inside one tick — strictly below the foreground:

1. foreground writes / due redundancy updates (the store's group loop ran
   before we are called);
2. paced parity repairs of previously detected blocks;
3. a patrol probe — on quiet ticks (no update dispatched); after
   ``patrol_max_starved_ticks`` consecutive probe-less ticks one probe
   dispatches even on a busy tick (the starvation floor;
   ``TickReport.patrol_starved_ticks`` surfaces the current streak).

Probes are asynchronous: dispatched at tick ``t`` against the
post-dispatch live view (in-flight blocks are shadow-marked, so the clean
mask skips them), fetched non-blocking at ``t+1``.  At most one probe is
in flight.  On the card a probe runs on the stream that called ``tick``
(the one that writes the leaves), its two verdict masks are copied into
pinned host memory without blocking, and an event recorded behind the
copy says when they have landed (see :meth:`ScrubPatroller._dispatch_probe`
for why the probe may read the checksums an in-flight update is
rewriting).

The reference's cross-shard parity (``xpar``: the probe's slab export,
the per-tick write sample, the first tick's fold) and its online shard
rebuild serve sharded stores only; on a machine-local store ``xpar`` is
empty and the reference returns early from each.  They are ROADMAP.md,
Queue 1 item 11.4; ``TickReport.rebuild`` stays None here.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.repairs import (UnrecoverableBlock, plan_stripe_repairs,
                            repair_blocks, vulnerable_unrecoverable)
from ..core.store import _ready

# A block is only "repaired-for-sure" once a later probe stops flagging it.
# recover_block can succeed (stripe clean) yet reconstruct garbage if the
# corruption raced a parity refresh of its stripe; such blocks re-detect on
# the next sweep and are retried up to this many times before the stripe is
# declared lost.
MAX_REPAIR_ATTEMPTS = 3

# Bound on the observability histories (detections, measured latencies) so
# a long-running store does not grow them without limit; the MTTDL model
# only ever wants recent-window statistics anyway.
OBSERVABILITY_CAP = 4096

# A probe outstanding this many process attempts with its readiness still
# False is force-fetched (the reference's guard against a readiness
# notification that never arrives; on the card ``Event.synchronize``).
PROBE_FORCE_TICKS = 4


class ShardLossConflictError(RuntimeError):
    """A second shard of the same leaf was declared lost while a rebuild of
    the first is active or pending (the reference's sharded stores;
    machine-local stores have one shard and no cross-shard parity)."""

    def __init__(self, leaf: str, active_shard: int, new_shard: int):
        self.leaf = leaf
        self.active_shard = int(active_shard)
        self.new_shard = int(new_shard)
        super().__init__(
            f"{leaf}: shard {new_shard} declared lost while shard "
            f"{active_shard} is still rebuilding; cross-shard parity "
            "covers a single lost shard, so a concurrent second loss is "
            "unrecoverable (wait for the active rebuild to finish)")


@dataclasses.dataclass(frozen=True)
class DetectionEvent:
    """One patrol detection: leaf, block id, detection step, and — when the
    corruption was registered via :meth:`ScrubPatroller.expect_injection` —
    the measured latency in steps."""
    leaf: str
    block: int
    step: int
    latency_steps: Optional[int] = None


class ScrubPatroller:
    """Continuous verify-window patrol for one
    :class:`repro_torch.core.ProtectedStore` (built by ``attach`` when
    ``RedundancyPolicy.patrol_bytes_per_tick > 0``)."""

    def __init__(self, store):
        self.store = store
        self.patrol_bytes = int(store.policy.patrol_bytes_per_tick)
        # Patrol targets: every vilamb-protected leaf, round-robin.  The
        # probe window is static per leaf.
        self.targets: List[str] = []
        self.window: Dict[str, int] = {}
        self.cursor: Dict[str, int] = {}
        self.sweeps: Dict[str, int] = {}
        for g in store._protected():
            if g.policy.mode != "vilamb":
                continue
            for name in g.names:
                meta = store.metas[name]
                w = max(1, self.patrol_bytes // max(1, meta.bytes_per_block))
                self.window[name] = min(w, meta.n_blocks)
                self.cursor[name] = 0
                self.sweeps[name] = 0
                self.targets.append(name)
        # In-flight probe: (name, start, window, host masks, event, step).
        self._probe: Optional[Tuple] = None
        self._probe_stuck = 0              # not-ready process attempts
        self._host: Dict[int, torch.Tensor] = {}   # pinned (2, window) bool
        self._ti = 0                       # round-robin target index
        # Detection / repair bookkeeping ((name, block) keyed).
        self._detected: set = set()
        self._attempts: Dict[Tuple[str, int], int] = {}
        self._expected: Dict[Tuple[str, int], int] = {}
        self._repair_queue: List[List] = []    # [name, block, retries]
        # Observability.
        self.ticks = 0
        self.blocks_scanned = 0            # probe positions covered
        self.starved_ticks = 0             # consecutive ticks with no probe
        self.detections: collections.deque = collections.deque(
            maxlen=OBSERVABILITY_CAP)
        self.latencies: collections.deque = collections.deque(
            maxlen=OBSERVABILITY_CAP)      # steps, registered injections only
        self.unrecoverable: List[UnrecoverableBlock] = []

    # ------------------------------------------------------------- plumbing
    def engine_of(self, name: str):
        eng = self.store.engine_for(name)
        assert eng is not None, name
        return eng

    def adopt_repair(self, name: str, leaf, overlay, report) -> None:
        """Surface a repaired leaf: the patroller's own overlay uses it for
        the rest of the tick, and ``TickReport.repaired`` tells the caller
        to adopt it.  The port repairs in place, so this is the caller's
        own tensor unless the leaf's lane view is a padded copy."""
        overlay[name] = leaf
        report.repaired[name] = leaf

    # ------------------------------------------------------------------ API
    def expect_injection(self, name: str, gblock: int, step: int) -> None:
        """Register a known corruption (fault oracle / benches) so its
        patrol detection yields a measured latency in steps."""
        self._expected[(name, int(gblock))] = int(step)

    def declare_shard_lost(self, name: str, shard: int,
                           red: Optional[Mapping[str, Any]] = None) -> None:
        """Queue an online rebuild of ``name``'s ``shard`` from cross-shard
        parity.  A machine-local store has none, so this raises the
        reference's ``ValueError``; the patroller of a sharded store, with
        its cross-shard parity, is ROADMAP.md, Queue 1 item 11.4."""
        raise ValueError(
            f"{name}: no cross-shard parity (leaf must be dim0-sharded "
            "across >= 2 shards for online rebuild)")

    def latency_stats(self, step_seconds: float = 1.0) -> Dict[str, float]:
        """Measured detection-latency summary for the MTTDL model
        (:func:`repro_torch.core.mttdl.detection_latency_stats`)."""
        from ..core import mttdl
        return mttdl.detection_latency_stats(self.latencies, step_seconds)

    def coverage(self) -> Dict[str, float]:
        """Fraction of each leaf's block space the current sweep has
        covered (1.0 = at least one full sweep done)."""
        out = {}
        for n in self.targets:
            nb = self.store.metas[n].n_blocks
            out[n] = 1.0 if self.sweeps[n] else min(1.0, self.cursor[n] / nb)
        return out

    # ----------------------------------------------------------------- tick
    def on_tick(self, get_leaves, out, step: int, report,
                busy: bool = False) -> None:
        """One tick of background duty (called by ``ProtectedStore.tick``
        after the foreground group loop; mutates ``out`` and ``report``)."""
        self.ticks += 1
        overlay: Optional[Dict[str, Any]] = None

        def lv() -> Dict[str, Any]:
            nonlocal overlay
            if overlay is None:
                overlay = dict(get_leaves())
            return overlay

        # The reference's cross-shard parity (its first-tick fold and the
        # write samples) and shard rebuild would run around here: item 11.4.
        self._process_probe(out, step, report)
        if self._repair_queue:
            self._run_repairs(lv, out, report)
        # Busy ticks defer the probe, but only up to the starvation floor:
        # under wall-to-wall update traffic the patrol would otherwise
        # never run and detection latency silently degrades to the
        # scheduled-scrub baseline.  After ``patrol_max_starved_ticks``
        # consecutive probe-less ticks one probe dispatches anyway
        # (0 disables the floor).
        floor = int(self.store.policy.patrol_max_starved_ticks)
        forced = floor > 0 and self.starved_ticks >= floor
        if (not busy or forced) and self._probe is None and self.targets:
            self._dispatch_probe(lv(), out, step, report)
            self.starved_ticks = 0
        elif self._probe is None and self.targets:
            self.starved_ticks += 1
        report.patrol_starved_ticks = self.starved_ticks

    # ------------------------------------------------------------- internals
    def _dispatch_probe(self, leaves, out, step: int, report) -> None:
        """Verify one window of the next target, without waiting.

        The probe reads the live view's ``checksums`` on the stream that
        called ``tick``.  On the card an in-flight update (K3) rewrites
        that very tensor in place on the store's side stream, and the
        probe does not wait for it: K3 writes only the checksums of the
        blocks dirty in its snapshot, which are ``shadow`` in the live view
        the probe masks with, so every entry the probe judges (a clean
        block) is one K3 never touches.  Waiting for K3 would put the
        foreground's next step behind the update.  The probe stays on the
        tick's stream because that stream writes the leaves (KV caches,
        in-place AdamW): a probe on a stream of its own could read a block
        torn by a later write and "repair" it from stale parity.
        """
        name = self.targets[self._ti % len(self.targets)]
        self._ti += 1
        meta = self.store.metas[name]
        w, nb = self.window[name], meta.n_blocks
        # Clamp so windows never cross n_blocks: the final window of a
        # sweep re-probes a little instead.
        start = min(self.cursor[name], nb - w)
        fn = self.engine_of(name).verify_window_fn(name, w)
        mism, clean = fn(leaves[name], out[name], start)
        masks = torch.cat([mism, clean])            # (2, w) bool
        done = None
        if masks.device.type == "cuda":
            host = self._host.get(w)
            if host is None:
                host = self._host[w] = torch.empty(
                    (2, w), dtype=torch.bool, pin_memory=True)
            host.copy_(masks, non_blocking=True)
            done = torch.cuda.Event(blocking=True)
            done.record()
            masks = host
        self._probe = (name, start, w, masks, done, step)
        self.blocks_scanned += w
        self.cursor[name] = start + w
        if self.cursor[name] >= nb:
            self.cursor[name] = 0
            self.sweeps[name] += 1
        report.patrolled = report.patrolled + (name,)

    def _process_probe(self, out, step: int, report) -> None:
        if self._probe is None:
            return
        name, start, w, masks, done, _ = self._probe
        if not _ready(done):
            self._probe_stuck += 1
            if self._probe_stuck < PROBE_FORCE_TICKS:
                return  # still in flight; at most one probe outstanding
            # Stuck past any plausible execution time: force the (tiny)
            # fetch (see PROBE_FORCE_TICKS).  On the CPU the masks are host
            # tensors already.
            if done is not None:
                done.synchronize()
        self._probe_stuck = 0
        self._probe = None
        meta = self.store.metas[name]
        mc = masks.numpy()
        m, c = mc[0].reshape(1, w), mc[1].reshape(1, w)
        report.patrol_mismatches += int(m.sum())
        lost_shards = self._detect_loss(name, m, c, out)
        for s in range(m.shape[0]):
            if s in lost_shards:
                continue
            for j in np.flatnonzero(m[s]):
                self._on_detection(name, s * meta.n_blocks + start + int(j),
                                   step, report)

    def _detect_loss(self, name: str, m: np.ndarray,
                     c: np.ndarray, out) -> set:
        """Wholesale-corrupt shard heuristic (a shard whose mismatches
        dominate a probe window queues a rebuild): it needs cross-shard
        parity, so on a machine-local store every detection is handled per
        block, as the reference's early return does (item 11.4)."""
        return set()

    def _on_detection(self, name: str, gblock: int, step: int,
                      report) -> None:
        key = (name, gblock)
        if key in self._detected:
            return
        self._detected.add(key)
        if self._attempts.get(key, 0) >= MAX_REPAIR_ATTEMPTS:
            # Re-detected after repeated "successful" repairs: the stripe's
            # parity was refreshed over the corrupt data (vulnerability
            # window hit) and reconstruction keeps reproducing garbage.
            u = vulnerable_unrecoverable(self.store.metas, [(name, gblock)])
            self.unrecoverable.extend(u)
            report.unrecoverable = report.unrecoverable + tuple(u)
            return
        inj = self._expected.pop(key, None)
        lat = (step - inj) if inj is not None else None
        if lat is not None:
            self.latencies.append(int(lat))
        self.detections.append(DetectionEvent(name, gblock, int(step), lat))
        self._repair_queue.append([name, gblock, 0])

    def _run_repairs(self, lv, out, report) -> None:
        """Parity repairs, paced at ``patrol_repair_per_tick`` blocks.  Runs
        only on ticks with detections queued: each repair's stripe check
        (``recover_block``) waits for the device."""
        budget = max(1, int(self.store.policy.patrol_repair_per_tick))
        by_leaf: Dict[str, List[int]] = {}
        for name, gb, _ in self._repair_queue:
            by_leaf.setdefault(name, []).append(gb)
        singles, multi = plan_stripe_repairs(self.store.metas, by_leaf)
        if multi:
            # >= 2 detections sharing a parity group: XOR cannot repair.
            bad = {(u.leaf, b) for u in multi for b in u.blocks}
            self._repair_queue = [e for e in self._repair_queue
                                  if (e[0], e[1]) not in bad]
            self.unrecoverable.extend(multi)
            report.unrecoverable = report.unrecoverable + tuple(multi)
        take = singles[:budget]
        if not take:
            return
        leaves = lv()
        repaired, fixed, vulnerable = repair_blocks(
            self.store, leaves, out, take)
        for name, gb in fixed:
            self.adopt_repair(name, repaired[name], leaves, report)
            self._repair_queue = [e for e in self._repair_queue
                                  if (e[0], e[1]) != (name, gb)]
            # Success is provisional (see MAX_REPAIR_ATTEMPTS): forget the
            # detection so the next sweep can re-flag it if reconstruction
            # reproduced garbage.
            self._detected.discard((name, gb))
            self._attempts[(name, gb)] = self._attempts.get((name, gb),
                                                            0) + 1
        vul = set(vulnerable)
        drop: List[UnrecoverableBlock] = []
        for e in self._repair_queue:
            if (e[0], e[1]) in vul:
                e[2] += 1
                if e[2] > MAX_REPAIR_ATTEMPTS:
                    drop.extend(vulnerable_unrecoverable(
                        self.store.metas, [(e[0], e[1])]))
        if drop:
            gone = {(u.leaf, u.blocks[0]) for u in drop}
            self._repair_queue = [e for e in self._repair_queue
                                  if (e[0], e[1]) not in gone]
            self.unrecoverable.extend(drop)
            report.unrecoverable = report.unrecoverable + tuple(drop)
