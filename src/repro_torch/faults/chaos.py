"""Chaos-soak battery: every fault mode at once, under live traffic.

The port of ``repro.faults.chaos``.  The fault machinery so far proves
each hazard in isolation: bitflips (oracle and patroller), process death
(crash points), wholesale shard loss (online rebuild), geometry changes
(remesh).  Production fails them *together*.  This module composes them
into one seeded soak: a :class:`ChaosSchedule` of storm phases runs
against a live write/tick workload while an invariant checker audits
every tick:

(a) **no stale bytes**: periodic ``read_verified`` spot-checks against a
    host-side ground-truth mirror either return the mirror's exact bytes
    or raise a typed ``UnrecoverableReadError``; a silent mismatch fails
    the run,
(b) **no silent deadline violations**: whenever a group's vulnerability
    age exceeds ``max_vulnerable_steps`` the tick's ``report.health``
    must carry a matching violation or escalation action (the governor's
    never-silent contract); an excursion nothing reported fails the run,
(c) **bitwise recovery**: after the last storm the store settles,
    flushes, scrubs clean, and every leaf equals the mirror bit for bit.

Measured patrol detection latencies feed
:func:`repro_torch.core.mttdl.mttdl_measured_live`, the soak's empirical
reliability number, and the post-storm breaker recovery time is reported
as ``recovery_ticks``.

Ground truth: writes are row ``set``s with seeded values, mirrored into a
host numpy array (bitwise-identical on both sides, so the final
comparison is exact equality, not tolerance).

The full schedule (bitflips, crash, straggler storm, shard loss,
mid-rebuild remesh) needs a mesh: here a simulated one, every shard on
the soak's one device (``python -m repro_torch.faults --chaos``);
:func:`run_chaos_soak` also runs machine-local with the mesh-dependent
phases (``quiesce``, ``shard_loss``, ``remesh``) omitted.

The leaf's rows and the rows written a step are arguments (the
reference's 64 rows of 2,048 fp32 words and 3 rows a step by default).
The patrol budget scales with the leaf's bytes from the reference's 16 KiB a shard over its 512 KiB leaf,
and the rebuild's and the remesh's windows follow it at their defaults
(4x), so every sweep takes as many ticks as in the reference and the
schedule's tick bounds keep their meaning at any size.
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import resolve_device
from ..core import ProtectedStore, RedundancyPolicy, UnrecoverableReadError, mttdl
from ..core.blocks import ShapeDtype
from ..health import HealthPolicy
from .inject import FaultInjector, FaultSpec

# Nominal per-block MTTF for the soak's MTTDL projection (same figure the
# mttdl benchmark uses for its scheduled-vs-patrol comparison).
MTTF_BLOCK_S = 1e9

# The reference soak's leaf, rows written a step and patrol budget (16 KiB
# a shard a tick over its 512 KiB leaf).
N_ROWS, N_COLS, ROWS_PER_STEP = 64, 2048, 3
PATROL_BYTES_REF = 32 * 128 * 4

# Bytes of the leaf copied to or compared with the mirror at a time (on the
# card through one pinned buffer of this size).
CHUNK_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True)
class StormPhase:
    """One schedule entry.  Kinds:

    ``traffic``    : ``steps`` plain write+tick steps
    ``bitflips``   : inject ``n`` clean-block bitflips, then quiet ticks
                     until the patroller repairs them all
    ``straggler``  : ``steps`` write+tick steps reporting ``step_time``
                     seconds each (stretches the straggler governor)
    ``crash``      : persist live (leaves, red) via CheckpointManager,
                     build a fresh store/governor, ``restore_verified``
    ``quiesce``    : flush, then quiet ticks until cross-shard parity
                     covers the leaf (pre-loss coverage wait)
    ``shard_loss`` : wipe shard ``n`` wholesale + declare it lost, then
                     ``steps`` live-traffic ticks (rebuild runs under
                     traffic; needs a mesh)
    ``remesh``     : queue ``store.remesh`` onto the grow mesh (mid-storm:
                     issued while the rebuild is still pasting), then
                     ``steps``+ ticks until rebuild and migration adopt
    ``drain``      : stop the traffic, tick until every breaker is
                     HEALTHY again (measures ``recovery_ticks``)
    """
    kind: str
    steps: int = 0
    n: int = 0
    step_time: float = 0.0


class ChaosSchedule:
    """A seeded sequence of storm phases (see :class:`StormPhase`)."""

    def __init__(self, phases: Sequence[StormPhase], seed: int = 0):
        self.phases = tuple(phases)
        self.seed = int(seed)

    @classmethod
    def default(cls, seed: int = 0, *, sharded: bool = True,
                smoke: bool = True) -> "ChaosSchedule":
        t = 4 if smoke else 12
        phases = [
            StormPhase("traffic", steps=2 * t),
            StormPhase("bitflips", n=2 if smoke else 4),
            StormPhase("traffic", steps=t),
            StormPhase("straggler", steps=2 * t, step_time=1.0),
            StormPhase("crash"),
            StormPhase("traffic", steps=t),
        ]
        if sharded:
            phases += [
                StormPhase("quiesce"),
                StormPhase("shard_loss", steps=2, n=2),
                StormPhase("remesh", steps=6 * t, step_time=0.5),
            ]
        phases += [StormPhase("traffic", steps=t), StormPhase("drain")]
        return cls(phases, seed)


@dataclasses.dataclass
class ChaosResult:
    seed: int
    steps: int = 0
    ticks: int = 0
    phases_run: Tuple[str, ...] = ()
    # Invariant (b): excursions past the deadline with NO matching
    # violation/action on report.health.  Must be zero, always.
    silent_violations: int = 0
    violations_reported: int = 0
    ladder_actions: int = 0
    backpressure_events: int = 0
    # Invariant (a): read_verified spot-checks.
    reads_checked: int = 0
    reads_typed_errors: int = 0
    reads_stale: int = 0
    # Storm bookkeeping.
    bitflips_injected: int = 0
    bitflips_repaired: int = 0
    crash_restores: int = 0
    # Named losses: blocks the rebuild reported structurally
    # unrecoverable (e.g. a survivor write staled the cross-shard parity
    # row before the rebuild froze the survivors' XOR).  The runner plays
    # the app and restores them from its mirror: loss is acceptable only
    # when *named*; the final bitwise check stays strict.
    named_lost_blocks: int = 0
    named_lost_rows_restored: int = 0
    rebuild_done: bool = True      # vacuously true when phase not scheduled
    remesh_done: bool = True
    deadline_fired: int = 0
    # Invariant (c): post-storm state.
    final_clean: bool = False
    final_bitwise: bool = False
    recovery_ticks: int = 0
    # Reliability projection from measured patrol detection latencies.
    detect_latency_stats: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    mttdl_live_s: float = 0.0
    failures: Tuple[str, ...] = ()

    def ok(self) -> bool:
        return (not self.failures and self.silent_violations == 0
                and self.reads_stale == 0 and self.final_clean
                and self.final_bitwise and self.rebuild_done
                and self.remesh_done)

    def summary(self) -> str:
        return (f"seed={self.seed} ticks={self.ticks} "
                f"phases={len(self.phases_run)} "
                f"silent={self.silent_violations} "
                f"violations={self.violations_reported} "
                f"actions={self.ladder_actions} "
                f"reads={self.reads_checked}"
                f"(typed={self.reads_typed_errors} stale={self.reads_stale}) "
                f"deadline_fired={self.deadline_fired} "
                f"named_lost={self.named_lost_blocks} "
                f"recovery_ticks={self.recovery_ticks} "
                f"clean={self.final_clean} bitwise={self.final_bitwise} "
                f"mttdl={self.mttdl_live_s:.3g}s "
                f"{'OK' if self.ok() else 'FAIL: ' + '; '.join(self.failures)}")


class _ChaosRunner:
    """One soak run: store + mirror + invariant checker.

    ``initial`` (numpy, ``(n_rows, N_COLS)`` float32) is the leaf the soak
    starts from.  The runner keeps it as its mirror, without a copy, and
    writes into it.  By default it is drawn from its own
    ``np.random.default_rng(seed)`` (the reference draws it with
    ``jax.random.normal``, which the port cannot reproduce: pass the
    reference's leaf to run its soak).  Every other draw comes from the
    runner's ``np.random.default_rng(seed)`` in the reference's order: each
    step's rows and values, and the spot-read blocks every fifth tick.

    ``timings`` records, per schedule entry, the phase's wall seconds and
    each tick's host milliseconds (no device sync), with whether a shard
    rebuild or a remesh migration was active on it, and the crash's save
    and restore seconds.
    """

    def __init__(self, schedule: ChaosSchedule, *, sharded: bool,
                 verbose=None, device=None, initial: Optional[np.ndarray] = None,
                 n_rows: int = N_ROWS, rows_per_step: int = ROWS_PER_STEP):
        self.schedule = schedule
        self.sharded = sharded
        self.device = resolve_device(device, "run_chaos_soak")
        self.N_ROWS = int(n_rows)
        self.rows_per_step = int(rows_per_step)
        self.rng = np.random.default_rng(schedule.seed)
        self.log = verbose or (lambda *_: None)
        self.result = ChaosResult(seed=schedule.seed)
        self.step = 0
        self.lost_shard: Optional[int] = None
        self.rebuild_done_seen = False
        self.detect_latencies: List[float] = []
        self.timings: Dict[str, Any] = {"phases": [], "crash": {}}
        self._ticks: List[Dict[str, Any]] = []
        if sharded:
            from ..dist import P
            from ..launch.mesh import make_mesh
            self.mesh = make_mesh((1, 2, 2), ("pod", "data", "model"),
                                  device=self.device)
            self.grow_mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                                       device=self.device)
            self.specs = {"w": P(("pod", "data", "model"), None)}
        else:
            self.mesh = self.grow_mesh = None
            self.specs = {}
        if initial is None:
            initial = np.random.default_rng(schedule.seed).standard_normal(
                (self.N_ROWS, N_COLS), dtype=np.float32)
        self.mirror = np.ascontiguousarray(initial, dtype=np.float32)
        if self.mirror.shape != (self.N_ROWS, N_COLS):
            raise ValueError(f"initial leaf {self.mirror.shape}, want "
                             f"{(self.N_ROWS, N_COLS)}")
        self.store = self._make_store(self.mesh)
        self._pinned: Optional[torch.Tensor] = None
        self.leaves = {"w": self._upload_mirror()}
        self.red = self.store.init(self.leaves)
        self.injector = FaultInjector(self.store, seed=schedule.seed)

    # ------------------------------------------------------------ plumbing

    def _make_store(self, mesh) -> ProtectedStore:
        # precompile=False: as the reference's store (its crash replays
        # restore unsharded host arrays).  The patrol budget keeps the
        # reference's ticks a sweep at any leaf size.
        patrol = max(1, PATROL_BYTES_REF * self.N_ROWS // N_ROWS)
        pol = RedundancyPolicy.single(
            "vilamb", period_steps=2, max_vulnerable_steps=6,
            lanes_per_block=128, work_queue_frac=0.5, async_tick=True,
            patrol_bytes_per_tick=patrol, precompile=False,
            straggler_window=4, straggler_recovery_steps=2,
            health=HealthPolicy(dispatch_timeout_s=5.0,
                                deadline_margin_steps=1,
                                backpressure="spin",
                                backpressure_spin_s=0.0,
                                recovery_ticks=2,
                                violation_mode="report"))
        store = ProtectedStore(pol, device=self.device, mesh=mesh)
        structs = {"w": ShapeDtype((self.N_ROWS, N_COLS), torch.float32)}
        if mesh is not None:
            return store.attach(structs, specs=self.specs)
        return store.attach(structs)

    def _harvest_latencies(self) -> None:
        pat = self.store.patroller
        if pat is not None and pat.latencies:
            self.detect_latencies.extend(pat.latencies)
            pat.latencies.clear()

    def _write_rows(self, rows: np.ndarray, vals: np.ndarray) -> None:
        """Rows ``set`` in the leaf (in place) and the mirror, marked dirty."""
        idx = torch.as_tensor(rows, device=self.device)
        self.leaves["w"].index_copy_(
            0, idx, torch.from_numpy(vals).to(self.device))
        self.mirror[rows] = vals
        ev = torch.zeros((self.N_ROWS,), dtype=torch.bool,
                         device=self.device).index_fill_(0, idx, True)
        self.red = self.store.on_write(self.red, events={"w": ev})

    def _mirror_block(self, gb: int) -> np.ndarray:
        """Global block ``gb``'s uint32 lanes from the mirror: the rows of
        its shard viewed flat, zero-padded past the shard's end as
        ``to_lanes`` pads (no copy of the shard)."""
        meta = self.store.protected_metas["w"]
        k = self.store.shard_factor("w")
        rows_local = self.N_ROWS // k
        s, lb = divmod(int(gb), meta.n_blocks)
        words = self.mirror[s * rows_local:(s + 1) * rows_local].reshape(-1)
        words = words.view(np.uint32)
        L = meta.lanes_per_block
        out = np.zeros((L,), np.uint32)
        got = words[lb * L:(lb + 1) * L]
        out[:len(got)] = got
        return out

    def _chunks(self):
        """``(first, end)`` row ranges of at most CHUNK_BYTES, and the
        reused pinned buffer they pass through on the card (None on the
        CPU): a pageable copy runs at a fraction of the link's rate."""
        rows = max(1, min(self.N_ROWS, CHUNK_BYTES // (N_COLS * 4)))
        if self.device.type == "cuda" and self._pinned is None:
            self._pinned = torch.empty((rows, N_COLS), dtype=torch.float32,
                                       pin_memory=True)
        return ([(a, min(self.N_ROWS, a + rows)) for a in range(0, self.N_ROWS, rows)],
                self._pinned)

    def _upload_mirror(self) -> torch.Tensor:
        """The mirror copied into a new leaf on the device."""
        chunks, buf = self._chunks()
        if buf is None:
            return torch.from_numpy(self.mirror.copy())
        leaf = torch.empty(self.mirror.shape, dtype=torch.float32, device=self.device)
        for a, b in chunks:
            buf[:b - a].numpy()[...] = self.mirror[a:b]
            leaf[a:b].copy_(buf[:b - a], non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        return leaf

    def leaf_equals_mirror(self) -> bool:
        """The leaf against the mirror, bit for bit, a chunk of rows at a
        time (the whole leaf never sits on the host twice)."""
        w = self.leaves["w"]
        chunks, buf = self._chunks()
        for a, b in chunks:
            if buf is None:
                got = w[a:b].numpy()
            else:
                buf[:b - a].copy_(w[a:b], non_blocking=True)
                torch.cuda.current_stream(self.device).synchronize()
                got = buf[:b - a].numpy()
            if not np.array_equal(got.view(np.int32), self.mirror[a:b].view(np.int32)):
                return False
        return True

    # ----------------------------------------------------------- invariants

    def _check_tick(self, rep) -> None:
        r = self.result
        r.deadline_fired += len(rep.deadline_fired)
        if rep.health is not None:
            r.violations_reported += len(rep.health.violations)
            r.ladder_actions += len(rep.health.actions)
            r.backpressure_events += rep.health.backpressure_events
        for g in self.store._protected():
            lp = g.policy
            if lp.mode != "vilamb" or lp.max_vulnerable_steps <= 0:
                continue
            age = self.step - g.last_update_step
            if age <= lp.max_vulnerable_steps:
                continue
            h = rep.health
            visible = h is not None and (
                any(v.group == g.label for v in h.violations)
                or any(a.group == g.label for a in h.actions))
            if not visible:
                r.silent_violations += 1
                self.log(f"  SILENT deadline excursion: {g.label} age {age} "
                         f"> {lp.max_vulnerable_steps} at step {self.step}")

    def _spot_read(self, n_blocks: int = 2) -> None:
        r = self.result
        meta = self.store.protected_metas["w"]
        k = self.store.shard_factor("w")
        total = k * meta.n_blocks
        blocks = sorted(self.rng.choice(
            total, size=min(n_blocks, total), replace=False).tolist())
        try:
            got = self.store.read_verified(self.leaves, self.red, "w", blocks)
        except UnrecoverableReadError:
            # Typed is the contract: degraded, but never stale-silent.
            r.reads_checked += len(blocks)
            r.reads_typed_errors += len(blocks)
            return
        for b in blocks:
            r.reads_checked += 1
            if not np.array_equal(np.asarray(got[b]).view(np.uint32),
                                  self._mirror_block(b)):
                r.reads_stale += 1
                self.log(f"  STALE read_verified bytes: block {b} at step "
                         f"{self.step}")

    # ------------------------------------------------------------- workload

    def _tick(self, *, step_time: float = 0.0, write: bool = True) -> Any:
        if write:
            rows = np.sort(self.rng.choice(self.N_ROWS, size=self.rows_per_step,
                                           replace=False))
            vals = self.rng.standard_normal(
                (len(rows), N_COLS)).astype(np.float32)
            self._write_rows(rows, vals)
            self.result.steps += 1
        self.step += 1
        # Always feed the straggler governor: calm ticks report a small
        # baseline so a storm's inflated step_time registers as > factor x
        # the rolling median (an all-storm window would look "normal").
        t0 = time.perf_counter()
        self.red, rep = self.store.tick(
            self.leaves, self.red, self.step,
            step_time=step_time if step_time > 0 else 0.01, scrub_period=0)
        self._ticks.append({"host_ms": (time.perf_counter() - t0) * 1e3,
                            "rebuild": rep.rebuild is not None,
                            "remesh": rep.remesh is not None})
        if rep.repaired:
            self.leaves = dict(self.leaves, **rep.repaired)
        if rep.rebuild is not None and rep.rebuild.done:
            self.rebuild_done_seen = True
        if rep.unrecoverable:
            self._restore_named_losses(rep.unrecoverable)
        self.result.ticks += 1
        self._check_tick(rep)
        if self.result.ticks % 5 == 0:
            self._spot_read()
        return rep

    def _restore_named_losses(self, recs) -> None:
        """App-level restore of structurally reported losses.

        A rebuild can *name* blocks it cannot reconstruct (stale
        cross-shard parity row: a survivor write between the xpar fold
        and the rebuild's survivor-XOR freeze makes the XOR garbage).
        That is the contract: loss is acceptable only when reported.
        The runner answers like an application with a backup: rewrite
        the affected rows from the mirror as ordinary foreground
        writes, so redundancy re-converges through the normal dirty
        path and the final bitwise check stays strict."""
        meta = self.store.protected_metas["w"]
        k = self.store.shard_factor("w")
        rows_local = self.N_ROWS // k
        blocks_per_row = meta.n_blocks // rows_local
        # A block maps to one row only where each row fills whole blocks.
        assert N_COLS == blocks_per_row * meta.lanes_per_block, (
            f"rows of {N_COLS} words do not fill whole blocks of "
            f"{meta.lanes_per_block} lanes")
        rows = set()
        n_blocks = 0
        for rec in recs:
            if rec.leaf != "w":
                continue
            for gb in rec.blocks:
                s, lb = divmod(int(gb), meta.n_blocks)
                rows.add(s * rows_local + lb // blocks_per_row)
                n_blocks += 1
        if not rows:
            return
        r = np.asarray(sorted(rows))
        self._write_rows(r, self.mirror[r])
        self.result.named_lost_blocks += n_blocks
        self.result.named_lost_rows_restored += len(r)
        self.log(f"  named loss: {n_blocks} blocks -> restored rows "
                 f"{r.tolist()} from the mirror at step {self.step}")

    # --------------------------------------------------------------- phases

    def _phase_bitflips(self, ph: StormPhase) -> None:
        r = self.result
        specs = self.injector.plan_clean_blocks(
            self.red, n=ph.n, kinds=("data_bitflip",))
        if not specs:
            r.failures += ("bitflips: no clean blocks to corrupt",)
            return
        pat = self.store.patroller
        for spec in specs:
            self.leaves, self.red = self.injector.inject_many(
                self.leaves, self.red, [spec])
            pat.expect_injection("w", spec.block, self.step)
        r.bitflips_injected += len(specs)
        before = len(pat.latencies)
        # Quiet ticks: the patroller only probes idle ticks, and repairs
        # must not race fresh writes into the corrupted rows (a write
        # into a latently-corrupt block would launder the corruption into
        # recomputed checksums: the one sequence redundancy cannot catch).
        for _ in range(96):
            self._tick(write=False)
            if len(pat.latencies) - before >= len(specs):
                break
        repaired = len(pat.latencies) - before
        r.bitflips_repaired += repaired
        if repaired < len(specs):
            r.failures += (f"bitflips: {len(specs) - repaired} of "
                           f"{len(specs)} never repaired",)
        self._harvest_latencies()

    def _phase_crash(self, ph: StormPhase) -> None:
        from ..ckpt.checkpoint import CheckpointManager
        from .crashpoints import StoreState, _struct
        self._harvest_latencies()
        # In-flight work dies with the process: persist the live view as-is
        # (pendings dropped: their blocks are shadow-marked, so the
        # restore treats them as vulnerable), restore into a FRESH store on
        # the same device and simulated mesh.  The save is ordered after
        # the crashed store's in-flight update on the device, as the
        # reference's device_get is.  The reference's jax.eval_shape is
        # _struct's meta tensors; its NamedSharding re-placement has no
        # counterpart (every shard lies on the store's one device).
        state = StoreState(leaves=dict(self.leaves), red=dict(self.red),
                           step=self.step)
        with tempfile.TemporaryDirectory() as tmp:
            mgr = CheckpointManager(tmp, device=self.device)
            t0 = time.perf_counter()
            mgr.save(self.step, state, blocking=True, store=self.store)
            t1 = time.perf_counter()
            struct = _struct(state)
            self.store = self._make_store(self.mesh)
            self.injector = FaultInjector(self.store,
                                          seed=self.schedule.seed + 1)
            restored = mgr.restore_verified(
                struct, self.store,
                leaves_of=lambda st: st.leaves,
                replace_leaves=lambda st, lv: dataclasses.replace(
                    st, leaves=dict(lv)),
                step=self.step)
            self.timings["crash"] = {
                "save_s": t1 - t0, "restore_s": time.perf_counter() - t1,
                "bytes": mgr.last_save.get("bytes", 0),
                "tried": (list(mgr.last_restore_report.tried)
                          if mgr.last_restore_report else [])}
        if restored is None:
            self.result.failures += ("crash: restore_verified failed",)
            return
        self.leaves, self.red = dict(restored.leaves), dict(restored.red)
        self.result.crash_restores += 1
        # The restore scrub-repairs any latent out-of-window corruption;
        # in-window blocks keep their (newest, mirror-equal) data.
        if not self.leaf_equals_mirror():
            self.result.failures += ("crash: restored leaves != mirror",)

    def _phase_quiesce(self, ph: StormPhase) -> None:
        self.red = self.store.flush(self.leaves, self.red, self.step)
        pat = self.store.patroller
        for _ in range(96):
            self._tick(write=False)
            xp = pat.xpar.get("w") if pat is not None else None
            if xp is not None and bool(xp.xvalid.all()):
                return
        if self.sharded:
            self.result.failures += ("quiesce: xpar never covered the leaf",)

    def _phase_shard_loss(self, ph: StormPhase) -> None:
        lost = ph.n
        self.leaves, self.red = self.store.inject(
            self.leaves, self.red,
            FaultSpec(kind="shard_loss", leaf="w", block=lost))
        self.store.declare_shard_lost("w", lost, self.red)
        self.lost_shard = lost
        for _ in range(max(1, ph.steps)):
            self._tick()

    def _phase_remesh(self, ph: StormPhase) -> None:
        r = self.result
        # Mid-storm: the rebuild from the shard loss is still pasting; the
        # remesh queues behind it in the priority ladder and starts only
        # once the loss is recovered.
        self.store.remesh(self.grow_mesh)
        # The rebuild may already have finished during the shard-loss
        # phase's own live ticks: _tick tracks completion globally.
        rebuild_done = self.lost_shard is None or self.rebuild_done_seen
        remesh_done = False
        for i in range(max(ph.steps, 8) + 192):
            # Straggler storm overlapping the migration for the first
            # half of the nominal phase length.
            st = ph.step_time if i < max(ph.steps, 8) // 2 else 0.0
            rep = self._tick(step_time=st)
            if self.rebuild_done_seen:
                rebuild_done = True
            if rep.remesh is not None and rep.remesh.done:
                remesh_done = True
                break
        r.rebuild_done = r.rebuild_done and rebuild_done
        r.remesh_done = r.remesh_done and remesh_done
        if not rebuild_done:
            r.failures += ("shard rebuild never completed",)
        if not remesh_done:
            r.failures += ("remesh migration never adopted",)
        self.lost_shard = None
        self._harvest_latencies()

    def _phase_drain(self, ph: StormPhase) -> None:
        hg = self.store._health
        ticks = 0
        for _ in range(256):
            rep = self._tick(write=False)
            if hg is None or rep.health is None:
                break
            if rep.health.worst == "healthy":
                break
            ticks += 1
        else:
            self.result.failures += ("drain: breakers never recovered",)
        self.result.recovery_ticks = ticks

    # ------------------------------------------------------------------ run

    def run(self) -> ChaosResult:
        r = self.result
        dispatch = {
            "traffic": lambda ph: [self._tick(step_time=ph.step_time or 0.0)
                                   for _ in range(ph.steps)],
            "straggler": lambda ph: [self._tick(step_time=ph.step_time)
                                     for _ in range(ph.steps)],
            "bitflips": self._phase_bitflips,
            "crash": self._phase_crash,
            "quiesce": self._phase_quiesce,
            "shard_loss": self._phase_shard_loss,
            "remesh": self._phase_remesh,
            "drain": self._phase_drain,
        }
        for ph in self.schedule.phases:
            if not self.sharded and ph.kind in ("quiesce", "shard_loss",
                                                "remesh"):
                continue
            self.log(f"  chaos phase {ph.kind} (step {self.step})")
            self._ticks = []
            t0 = time.perf_counter()
            dispatch[ph.kind](ph)
            self.timings["phases"].append(
                {"kind": ph.kind, "wall_s": time.perf_counter() - t0,
                 "ticks": self._ticks})
            r.phases_run += (ph.kind,)
            if r.failures:
                break
        # Invariant (c): settle, flush, scrub clean, bitwise vs mirror.
        t0 = time.perf_counter()
        self.red = self.store.settle(self.red, self.leaves)
        self.leaves = dict(self.leaves, **self.store.take_repaired())
        self.red = self.store.flush(self.leaves, self.red, self.step)
        self.leaves = dict(self.leaves, **self.store.take_repaired())
        r.final_clean = int(self.store.scrub_check(self.leaves,
                                                   self.red)) == 0
        r.final_bitwise = self.leaf_equals_mirror()
        self.timings["final_check_s"] = time.perf_counter() - t0
        self._harvest_latencies()
        stats = mttdl.detection_latency_stats(self.detect_latencies,
                                              step_seconds=1.0)
        r.detect_latency_stats = stats
        meta = self.store.protected_metas["w"]
        r.mttdl_live_s = mttdl.mttdl_measured_live(
            MTTF_BLOCK_S, 0.0, self.store.policy.stripe_data_blocks + 1,
            meta.n_stripes, assumed_latency_seconds=stats["mean_s"],
            measured=stats)
        return r


def run_chaos_soak(seed: int = 0, *, sharded: bool = False,
                   smoke: bool = True,
                   schedule: Optional[ChaosSchedule] = None,
                   verbose=None, device=None) -> ChaosResult:
    """Run one seeded chaos soak; see the module docstring for invariants.

    ``sharded=True`` runs on a simulated (1, 2, 2) mesh grown to (2, 2, 2)
    on ``device`` (the card unless ``device="cpu"``); machine-local runs
    skip the mesh-dependent storm phases.
    """
    sched = schedule or ChaosSchedule.default(seed, sharded=sharded,
                                              smoke=smoke)
    return _ChaosRunner(sched, sharded=sharded, verbose=verbose,
                        device=device).run()
