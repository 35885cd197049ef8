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
2. online shard rebuild, one bounded window per tick (loss recovery);
3. paced parity repairs of previously detected blocks;
4. a patrol probe — on quiet ticks (no update dispatched) and never
   while a rebuild is active; after ``patrol_max_starved_ticks``
   consecutive probe-less ticks one probe dispatches even on a busy tick
   (the starvation floor; ``TickReport.patrol_starved_ticks`` surfaces the
   current streak).

Probes are asynchronous: dispatched at tick ``t`` against the
post-dispatch live view (in-flight blocks are shadow-marked, so the clean
mask skips them), fetched non-blocking at ``t+1``.  At most one probe is
in flight.  On the card a probe runs on the stream that called ``tick``
(the one that writes the leaves), its verdict masks are copied into
pinned host memory without blocking, and an event recorded behind the
copy says when they have landed (see :meth:`ScrubPatroller._dispatch_probe`
for why the probe may read the checksums an in-flight update is
rewriting).

Alongside each probe of a dim0-sharded leaf the same pass exports the raw
lanes, XOR-folded across shards into **cross-shard parity** rows
(:mod:`repro_torch.scrub.rebuild`) — the patrol traffic doubles as
rebuild capital.  A tiny per-tick *write sample* (``dirty | shadow``,
copied to pinned host memory behind an event, read at a later tick)
conservatively invalidates rows written since their refresh; samples are
processed before probe results, so a stale row is never validated over a
fresh write.  A lost shard (declared, or found by a probe whose window it
dominates with mismatches) is rebuilt from that parity while the
foreground keeps running (:class:`~repro_torch.scrub.rebuild.ShardRebuilder`).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.repairs import (UnrecoverableBlock, plan_stripe_repairs,
                            repair_blocks, vulnerable_unrecoverable)
from ..core.store import _ready
from ..faults.inject import bits_to_mask
from .rebuild import CrossShardParity, ShardRebuilder, to_device, xor_fold

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
    the first is active or pending.  Cross-shard parity is a single XOR
    fold: it can reconstruct exactly one missing shard, so the second loss
    is genuinely unrecoverable from ``xpar`` — raising keeps the in-flight
    rebuild's paste state intact instead of silently resetting it."""

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
    """Continuous verify-window patrol + online shard rebuild for one
    :class:`repro_torch.core.ProtectedStore` (built by ``attach`` when
    ``RedundancyPolicy.patrol_bytes_per_tick > 0``)."""

    def __init__(self, store):
        self.store = store
        self.patrol_bytes = int(store.policy.patrol_bytes_per_tick)
        # Mesh-geometry epoch (0 until a remesh exists: ROADMAP.md, Queue 1
        # item 11.5): every parity image carries the geometry it was folded
        # under, so stale xpar could never seed a rebuild on a new mesh.
        self.geometry_version = int(getattr(store, "geometry_version", 0))
        # Patrol targets: every vilamb-protected leaf, round-robin.  The
        # probe window is static per leaf.
        self.targets: List[str] = []
        self.window: Dict[str, int] = {}
        self.cursor: Dict[str, int] = {}
        self.sweeps: Dict[str, int] = {}
        self.xpar: Dict[str, CrossShardParity] = {}
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
                eng = store.engine_for(name)
                k = eng.shard_factor(name)
                gshape = eng.global_shapes[name]
                # Cross-shard parity needs clean row-contiguous shard
                # slices: dim0-sharded with an even split (the same
                # precondition as blocks.shard_slice / recover_block).
                if (k >= 2 and gshape and gshape[0] % k == 0
                        and tuple(meta.shape) ==
                        (gshape[0] // k,) + tuple(gshape[1:])):
                    self.xpar[name] = CrossShardParity(
                        name, meta.n_blocks, version=self.geometry_version)
        self._primed = False
        # In-flight probe: (name, start, window, masks, event, xwin, step);
        # masks are the (2k, window) mism-then-clean verdicts (host memory
        # on the card), xwin the window's cross-shard fold (or None).
        self._probe: Optional[Tuple] = None
        self._probe_stuck = 0              # not-ready process attempts
        # Rows of the in-flight probe's leaf invalidated by write samples
        # processed since its dispatch: a probe that lands late must not
        # re-validate them (its clean mask predates those writes).
        self._probe_inval: Optional[np.ndarray] = None
        self._host: Dict[Tuple[int, int], torch.Tensor] = {}   # pinned verdicts
        # Write samples not processed yet, oldest first: (event, names,
        # words); on the card the words are pinned host memory the event
        # says has landed.
        self._samples: collections.deque = collections.deque()
        self._ti = 0                       # round-robin target index
        # Detection / repair bookkeeping ((name, global_block) keyed).
        self._detected: set = set()
        self._attempts: Dict[Tuple[str, int], int] = {}
        self._expected: Dict[Tuple[str, int], int] = {}
        self._repair_queue: List[List] = []    # [name, gblock, retries]
        # Queued losses: (name, shard, preloss-row-mask-or-None).
        self._pending_loss: List[Tuple[str, int, Optional[np.ndarray]]] = []
        self.rebuild: Optional[ShardRebuilder] = None
        # Observability.
        self.ticks = 0
        self.blocks_scanned = 0            # local probe positions covered
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

    def fetch_live_rows(self, name: str, r) -> np.ndarray:
        """Exact (blocking) ``dirty | shadow`` fetch as a bool ``(k, nb)``
        row mask — writes land before the tick, so a fetch at tick ``t``
        sees every mark through step ``t``.  The reference's semantics at
        a loss declaration and at rebuild start and each rebuild tick, and
        nowhere else: on the card it waits for the current stream."""
        meta = self.store.metas[name]
        k = self.store.shard_factor(name)
        live = (r.dirty | r.shadow).cpu().numpy()
        return bits_to_mask(live, meta.n_blocks, shards=k).reshape(k, meta.n_blocks)

    def adopt_repair(self, name: str, leaf, overlay, report) -> None:
        """Surface a repaired or rebuilt leaf: the patroller's own overlay
        uses it for the rest of the tick, and ``TickReport.repaired`` tells
        the caller to adopt it.  The port repairs in place, so this is the
        caller's own tensor unless the leaf's lane view is a padded copy
        (a parity repair of a machine-local leaf); the reference re-pins
        its new array to the leaf's sharding (``_repin``), which a tensor
        written in place keeps."""
        overlay[name] = leaf
        report.repaired[name] = leaf

    # ------------------------------------------------------------------ API
    def expect_injection(self, name: str, gblock: int, step: int) -> None:
        """Register a known corruption (fault oracle / benches) so its
        patrol detection yields a measured latency in steps."""
        self._expected[(name, int(gblock))] = int(step)

    def declare_shard_lost(self, name: str, shard: int,
                           red: Optional[Mapping[str, Any]] = None) -> None:
        """Queue an online rebuild of ``name``'s ``shard`` (operator
        signal; probes also declare losses themselves past the
        ``shard_loss_threshold``).

        Pass the current ``red`` state when it is in hand: its ``dirty |
        shadow`` marks on the lost shard pin down *declaration-time*
        in-flight writes (data died with the shard — reported
        unrecoverable, never "fresh") while later foreground writes still
        classify as fresh.  Without ``red`` the rebuild snapshots at
        construction instead, which conservatively sweeps any write
        between declaration and the next tick into the pre-loss set."""
        if name not in self.xpar:
            raise ValueError(
                f"{name}: no cross-shard parity (leaf must be dim0-sharded "
                "across >= 2 shards for online rebuild)")
        if self.rebuild is not None and self.rebuild.name == name:
            if self.rebuild.shard == int(shard):
                return      # idempotent: already rebuilding this shard
            raise ShardLossConflictError(name, self.rebuild.shard, shard)
        for p in self._pending_loss:
            if p[0] != name:
                continue
            if p[1] == int(shard):
                return      # keep the earliest (closest-to-loss) snapshot
            # A different shard of the same leaf is already queued: the
            # single-XOR parity cannot cover both.
            raise ShardLossConflictError(name, p[1], shard)
        preloss = None
        if red is not None:
            preloss = self.fetch_live_rows(name, red[name])[int(shard)].copy()
        self._pending_loss.append((name, int(shard), preloss))

    def latency_stats(self, step_seconds: float = 1.0) -> Dict[str, float]:
        """Measured detection-latency summary for the MTTDL model
        (:func:`repro_torch.core.mttdl.detection_latency_stats`)."""
        from ..core import mttdl
        return mttdl.detection_latency_stats(self.latencies, step_seconds)

    def coverage(self) -> Dict[str, float]:
        """Fraction of each leaf's local block space the current sweep has
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

        if not self._primed:
            if self.xpar:
                self._prime(lv(), out)
            self._primed = True
        # Invalidate-then-validate: write samples first, so a probe result
        # never re-validates a cross-shard parity row over a fresh write.
        self._process_sample()
        self._process_probe(out, step, report)
        if self.rebuild is None and self._pending_loss:
            self._start_rebuild(lv(), out, step)
        if self.rebuild is not None:
            self._step_rebuild(lv(), out, report, step)
        elif self._repair_queue:
            self._run_repairs(lv, out, report)
        self._dispatch_sample(out)
        # Busy ticks defer the probe, but only up to the starvation floor:
        # under wall-to-wall update traffic the patrol would otherwise
        # never run and detection latency silently degrades to the
        # scheduled-scrub baseline.  After ``patrol_max_starved_ticks``
        # consecutive probe-less ticks one probe dispatches anyway
        # (0 disables the floor; rebuilds still take priority).
        floor = int(self.store.policy.patrol_max_starved_ticks)
        forced = floor > 0 and self.starved_ticks >= floor
        if ((not busy or forced) and self._probe is None
                and self.rebuild is None and self.targets):
            self._dispatch_probe(lv(), out, step, report)
            self.starved_ticks = 0
        elif self._probe is None and self.targets:
            self.starved_ticks += 1
        report.patrol_starved_ticks = self.starved_ticks

    def drain_rebuild(self, leaves, out, report, step: Optional[int]) -> None:
        """Run the active rebuild to its end, a window at a time (``settle``
        and ``flush`` with the leaves: no checkpoint holds a half-pasted
        shard).  ``step`` is None when the caller gave none."""
        while self.rebuild is not None:
            self._step_rebuild(leaves, out, report, step)

    # ------------------------------------------------------------- internals
    def _step_rebuild(self, leaves, out, report, step: Optional[int]) -> None:
        """Paste one window of the active rebuild; after its last, the loss
        records go on ``report`` and the rebuild ends."""
        self.rebuild.step_once(leaves, out, report, step)
        if self.rebuild.status.done:
            recs = self.rebuild.unrecoverable()
            self.unrecoverable.extend(recs)
            report.unrecoverable = report.unrecoverable + tuple(recs)
            self.rebuild = None

    def _prime(self, leaves, out) -> None:
        """First tick: fold the initial cross-shard parity image per
        eligible leaf (on the current stream, one shard-sized buffer) and
        seed row validity from the live bitvectors (a blocking fetch,
        once)."""
        for name, xp in self.xpar.items():
            stack = self.engine_of(name).shard_lanes_fn(name)(leaves[name])
            xp.xpar = xor_fold(stack)
            xp.xvalid = ~self.fetch_live_rows(name, out[name]).any(axis=0)

    def _process_sample(self, force: bool = False) -> None:
        """Apply every landed write sample, oldest first (``force``: wait
        for those still in flight)."""
        while self._samples:
            done, names, words = self._samples[0]
            if not _ready(done):
                if not force:
                    return
                done.synchronize()
            self._samples.popleft()
            words = words.numpy().view(np.uint32)
            off = 0
            for name in names:
                meta = self.store.metas[name]
                k = self.store.shard_factor(name)
                n = k * meta.n_dirty_words
                # A row any shard wrote: the OR of the shards' words, unpacked.
                folded = np.bitwise_or.reduce(words[off:off + n].reshape(k, -1), axis=0)
                written = bits_to_mask(folded, meta.n_blocks)
                off += n
                self.xpar[name].xvalid &= ~written
                # Remember rows written while a probe is in flight on this
                # leaf: the probe's clean mask predates them, so its
                # adoption must not re-validate them.
                if (self._probe is not None and self._probe_inval is not None
                        and self._probe[0] == name):
                    self._probe_inval |= written

    def _dispatch_sample(self, out) -> None:
        """Per-tick write sample for cross-shard parity freshness.  Runs on
        EVERY tick (not just probe ticks): a mark consumed by an update
        dispatched this tick leaves ``dirty`` at adoption, and only this
        sample still catches it in ``shadow``.  It is taken on the current
        stream after this step's marks; on the card its words go to pinned
        host memory without blocking, and a later tick reads them once the
        event recorded behind the copy has fired."""
        if not self.xpar:
            return
        names = tuple(sorted(self.xpar))
        parts = [self.engine_of(n).live_words_fn(n)(out[n]) for n in names]
        words = parts[0] if len(parts) == 1 else torch.cat(parts)
        done = None
        if words.device.type == "cuda":
            host = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
            host.copy_(words, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            words = host
        self._samples.append((done, names, words))

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
        torn by a later write and "repair" it from stale parity.  For the
        same reason the window's cross-shard fold (a dim0-sharded leaf's
        slab, a view of the leaf) is queued right behind the checksum
        launch, before any later write can reach those rows.
        """
        name = self.targets[self._ti % len(self.targets)]
        self._ti += 1
        meta = self.store.metas[name]
        k = self.store.shard_factor(name)
        w, nb = self.window[name], meta.n_blocks
        # Clamp so windows never cross n_blocks: the final window of a
        # sweep re-probes a little instead.
        start = min(self.cursor[name], nb - w)
        want_slab = name in self.xpar
        outs = self.engine_of(name).verify_window_fn(name, w, want_slab)(
            leaves[name], out[name], start)
        xwin = xor_fold(outs[2]) if want_slab else None
        masks = torch.cat(outs[:2])                 # (2k, w) bool
        done = None
        if masks.device.type == "cuda":
            host = self._host.get(masks.shape)
            if host is None:
                host = self._host[masks.shape] = torch.empty(
                    masks.shape, dtype=torch.bool, pin_memory=True)
            host.copy_(masks, non_blocking=True)
            done = torch.cuda.Event(blocking=True)
            done.record()
            masks = host
        self._probe = (name, start, w, masks, done, xwin, step)
        self._probe_inval = np.zeros((nb,), bool) if want_slab else None
        self.blocks_scanned += w
        self.cursor[name] = start + w
        if self.cursor[name] >= nb:
            self.cursor[name] = 0
            self.sweeps[name] += 1
        report.patrolled = report.patrolled + (name,)

    def _process_probe(self, out, step: int, report) -> None:
        if self._probe is None:
            return
        name, start, w, masks, done, xwin, _ = self._probe
        # A probe is processed only after every write sample taken before
        # it is (a sample still pending holds writes it must not validate).
        if not _ready(done) or self._samples:
            self._probe_stuck += 1
            if self._probe_stuck < PROBE_FORCE_TICKS:
                return  # still in flight; at most one probe outstanding
            # Stuck past any plausible execution time: force the (tiny)
            # fetch (see PROBE_FORCE_TICKS).  On the CPU the masks are host
            # tensors already.
            self._process_sample(force=True)
            if done is not None:
                done.synchronize()
        self._probe_stuck = 0
        self._probe = None
        inval, self._probe_inval = self._probe_inval, None
        if self.rebuild is not None and self.rebuild.name == name:
            # Dispatched before the loss was declared: its verdicts are
            # about pre-rebuild garbage.  Drop it wholesale (the next sweep
            # re-covers the window).
            return
        meta = self.store.metas[name]
        k = self.store.shard_factor(name)
        mc = masks.numpy()
        m, c = mc[:k], mc[k:]
        report.patrol_mismatches += int(m.sum())
        lost_shards = self._detect_loss(name, m, c, out)
        for s in range(k):
            if s in lost_shards:
                continue
            for j in np.flatnonzero(m[s]):
                self._on_detection(name, s * meta.n_blocks + start + int(j),
                                   step, report)
        # Adopt the probe's fold into cross-shard parity for rows every
        # shard saw clean and matching (skip entirely once a shard is
        # wholesale-suspect: its lanes are garbage, not parity capital).
        if name in self.xpar and xwin is not None and not lost_shards:
            ok = c.all(axis=0) & ~m.any(axis=0)
            if inval is not None:
                # Rows written after dispatch (per the samples processed
                # while this probe was in flight): the slab predates them.
                ok &= ~inval[start:start + w]
            if ok.any():
                xp = self.xpar[name]
                cur = xp.xpar[start:start + w]
                if not ok.all():
                    xwin = torch.where(to_device(ok, cur.device)[:, None], xwin, cur)
                cur.copy_(xwin)
                xp.xvalid[start:start + w] |= ok

    def _detect_loss(self, name: str, m: np.ndarray,
                     c: np.ndarray, out) -> set:
        """Wholesale-corrupt shard heuristic: within one probe window, a
        shard whose mismatches dominate its clean blocks is lost, not
        bitflipped — queue a rebuild instead of per-block repairs."""
        pol = self.store.policy
        lost = set()
        if name not in self.xpar:
            return lost      # no rebuild substrate; treat per-block
        for s in range(m.shape[0]):
            mm, cc = int(m[s].sum()), int(c[s].sum())
            if cc and mm >= max(pol.shard_loss_min_blocks,
                                math.ceil(pol.shard_loss_threshold * cc)):
                lost.add(s)
                try:
                    self.declare_shard_lost(name, s, out)
                except (ValueError, ShardLossConflictError):
                    # No parity substrate, or a second shard of a leaf
                    # already mid-rebuild: fall back to per-block handling
                    # (the probe's detections stand on their own).
                    lost.discard(s)
        return lost

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

    def _start_rebuild(self, leaves, out, step: int) -> None:
        # Every write sample taken so far goes into xvalid first, landed or
        # not: a mark that an adopted update consumed survives only in its
        # tick's sample, and the rebuilder's freshness fetch cannot see it,
        # so a row left valid here would be rebuilt from stale xpar.  The
        # reference's sample is always applied by now (its fetch blocks);
        # the rebuilder's own fetch waits for the stream anyway.
        self._process_sample(force=True)
        name, shard, preloss = self._pending_loss.pop(0)
        # Shard-wide garbage invalidates every queued per-block judgment
        # about this leaf; the rebuild re-establishes it wholesale and
        # later probes re-detect anything still wrong — with a fresh
        # attempt budget (stale counts would declare a post-rebuild
        # re-detection unrecoverable prematurely).
        self._repair_queue = [e for e in self._repair_queue if e[0] != name]
        self._detected = {d for d in self._detected if d[0] != name}
        self._attempts = {k: v for k, v in self._attempts.items()
                          if k[0] != name}
        try:
            self.rebuild = ShardRebuilder(self, name, shard,
                                          leaves, out, step, preloss)
        except RuntimeError as e:     # not primed yet: retry next tick
            warnings.warn(str(e), RuntimeWarning, stacklevel=2)
            self._pending_loss.append((name, shard, preloss))

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
