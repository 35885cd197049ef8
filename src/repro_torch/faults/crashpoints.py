"""Crash-point state machine over the pipelined redundancy lifecycle.

The port of ``repro.faults.crashpoints``.  A due tick dispatches an
overlapped Algorithm-1 update; later ticks adopt it lazily (or coalesce
into it while it is in flight), and deadlines and scrubs force its
resolution.  Each of those phases is an interleaving a crash can land in,
and the paper's shadow protocol claims every one of them is safe: the
persisted ``(data, checksums, parity, dirty, shadow)`` tuple is always
either fully covered or conservatively marked.

1. :class:`~repro_torch.core.ProtectedStore` fires host-level **phase
   hooks** (``add_phase_hook``) at every lifecycle phase with the live
   redundancy view at that instant.
2. :class:`CrashPointMachine` drives a deterministic scripted workload,
   enumerates every fired ``(phase, occurrence)`` pair, and replays the
   run crashing at each one: the live view at the phase is persisted via
   :class:`~repro_torch.ckpt.CheckpointManager` (the NVM-survives-the-crash
   analogue), a **fresh** store restores it through ``restore_verified``,
   and the outcome is classified.
3. Outcomes: ``recovered_bitwise`` (data identical, scrub clean, forward
   progress resumes) or ``lost_within_window`` (every diverging block
   provably inside the vulnerability window at crash time).  Anything else
   fails the machine.

On the card a crash at ``dispatch`` or ``coalesce`` leaves the crashed
store's update running on its side stream, refreshing the live view's
checksums and parity in place; the persisted view is read after that
update (``ProtectedStore.await_inflight``), so it holds the update's
arrays with ``shadow`` still marking the blocks it covers, where the
reference (and the CPU) persist the previous epoch's.  Both are covered
or conservatively marked.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..ckpt.checkpoint import CheckpointManager
from ..core import blocks as B
from ..core import store as store_mod
from ..core.state import FIELDS, LeafRedundancy
from .inject import FaultSpec, apply_fault
from .oracle import vulnerability_window

# Phases the store instruments.  "adopt" = lazy adoption on a later tick;
# "adopt_forced" = deadline- or scrub-forced resolution; "coalesce" = a due
# tick folded into the still-in-flight update; "dispatcher_enqueue" = the
# batched update of every due group is about to be launched (pre-swap live
# view); "dispatch" = per due group, right after the launch (post-swap live
# view); "dispatcher_join" = a settle/flush/deadline path is about to wait
# for an update; "rebuild_paste" = one shard-rebuild paste window landed;
# "remesh_migrate" = one remesh migration window re-striped (fired with the
# old geometry's live view, the truth until adoption: a crash there
# restarts on the old mesh).
CRASH_PHASES = ("init", "on_write", "dispatcher_enqueue", "dispatch",
                "coalesce", "dispatcher_join", "adopt", "adopt_forced",
                "blocking_update", "scrub", "tick", "flush",
                "settle", "rebuild_paste", "remesh_migrate")


@dataclasses.dataclass
class StoreState:
    """The persisted state of a raw ProtectedStore run: the protected
    leaves plus their redundancy state, what NVM holds at a crash.  The
    checkpoint flattens it as the reference flattens its registered
    dataclass (``leaves/<leaf>``, ``red/<leaf>/<field>``, ``step``)."""
    leaves: Dict[str, torch.Tensor]
    red: Any
    step: int


@dataclasses.dataclass(frozen=True)
class CrashPlan:
    """Crash at the ``occurrence``-th firing of ``phase`` (0-based)."""
    phase: str
    occurrence: int = 0


@dataclasses.dataclass
class CrashOutcome:
    plan: CrashPlan
    step: int                               # workload step at the crash
    classification: str                     # recovered_bitwise | lost_within_window | rejected | FAILED
    diverged: Dict[str, Set[int]]           # restored-vs-pristine block diffs
    window: Dict[str, Set[int]]             # vulnerable blocks at crash time
    scrub_after_flush: int = -1             # mismatches after restart+flush
    # Host seconds of the replay's parts: drive (to the crash), save,
    # restore (restore_verified).  Not part of the outcome's equality.
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict,
                                                  compare=False)

    @property
    def ok(self) -> bool:
        return self.classification in ("recovered_bitwise",
                                       "lost_within_window")


class _CrashNow(Exception):
    """Raised from a phase hook to emulate process death at that phase.
    Carries the crashed ``store``: its update may still be in flight."""

    def __init__(self, phase: str, red_live, leaves, step: int, store=None):
        super().__init__(phase)
        self.phase = phase
        self.red_live = red_live
        self.leaves = leaves
        self.step = step
        self.store = store


def default_mutate(rng: np.random.Generator, step: int,
                   leaves: Mapping[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Deterministic scripted writes: add ``0.25 * step`` to 1-4 random
    leading-axis rows of every leaf (of a copy: the inputs stay as they
    are), returning (new_leaves, row-mask events)."""
    out = dict(leaves)
    events: Dict[str, torch.Tensor] = {}
    for name in sorted(leaves):
        v = leaves[name]
        n = v.shape[0]
        rows = rng.choice(n, size=int(rng.integers(1, min(4, n) + 1)),
                          replace=False)
        idx = torch.as_tensor(np.sort(rows), device=v.device)
        w = v.clone()
        w[idx] += 0.25 * step
        out[name] = w
        events[name] = torch.zeros((n,), dtype=torch.bool,
                                   device=v.device).index_fill_(0, idx, True)
    return out, events


def _struct(state: StoreState) -> StoreState:
    """``state``'s shapes and dtypes on the meta device (the reference's
    ``jax.eval_shape``): what ``restore_verified`` rebuilds into."""
    def meta(t):
        return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
    return StoreState(
        leaves={k: meta(v) for k, v in state.leaves.items()},
        red={n: LeafRedundancy(**{f: meta(getattr(r, f)) for f in FIELDS})
             for n, r in state.red.items()},
        step=int(state.step))


class CrashPointMachine:
    """Enumerate-and-replay crash consistency over a scripted store run.

    ``make_store`` builds a fresh, identically-configured ProtectedStore
    (one per replay: a crash kills the process, state machines included);
    ``make_leaves`` the initial protected leaves.  The workload is
    ``steps`` iterations of ``mutate`` (seeded rng -> identical writes
    every replay) + ``on_write`` + ``tick``; ``scrub_every`` forwards to
    the tick, and steps listed in ``hold_inflight_steps`` pretend the
    in-flight update is not ready yet (deterministically exercising the
    coalesce/mid-flight interleavings on a fast device).

    ``actions`` maps workload step -> ``fn(store, leaves, red)`` fired
    after that step's writes but before its tick; it may return nothing,
    or ``(leaves, red)`` to substitute state (e.g. after injecting a
    fault).
    """

    def __init__(self, make_store: Callable[[], Any],
                 make_leaves: Callable[[], Dict[str, torch.Tensor]],
                 ckpt_dir, *, seed: int = 0, steps: int = 8,
                 scrub_every: int = 0,
                 hold_inflight_steps: Sequence[int] = (),
                 mutate: Callable = default_mutate,
                 flush_at_end: bool = True,
                 actions: Optional[Mapping[int, Callable]] = None):
        self.make_store = make_store
        self.make_leaves = make_leaves
        self.ckpt_dir = str(ckpt_dir)
        self.seed = int(seed)
        self.steps = int(steps)
        self.scrub_every = int(scrub_every)
        self.hold_inflight_steps = set(int(s) for s in hold_inflight_steps)
        self.mutate = mutate
        self.flush_at_end = flush_at_end
        self.actions = {int(k): v for k, v in (actions or {}).items()}
        self._probe_store = None

    def _probe(self):
        if self._probe_store is None:
            self._probe_store = self.make_store()
        return self._probe_store

    # ------------------------------------------------------------- driving
    @contextlib.contextmanager
    def _held_readiness(self, active: bool):
        """Force the non-blocking readiness probe (on the card, the
        completion event's query) to report 'in flight'."""
        if not active:
            yield
            return
        orig = store_mod._ready
        store_mod._ready = lambda x: False
        try:
            yield
        finally:
            store_mod._ready = orig

    def _drive(self, on_phase: Optional[Callable[[str, dict], None]] = None):
        """One full scripted run; returns (store, leaves, red, fired).

        ``on_phase(phase, info)`` may raise :class:`_CrashNow`; ``fired``
        is the ordered list of every phase firing with its occurrence
        index (the machine's transition log).
        """
        store = self.make_store()
        leaves = self.make_leaves()
        rng = np.random.default_rng(self.seed)
        fired: List[Tuple[str, int]] = []
        counts: Dict[str, int] = {}
        cur = {"leaves": leaves, "step": 0}

        def hook(phase: str, info: dict):
            occ = counts.get(phase, 0)
            counts[phase] = occ + 1
            fired.append((phase, occ))
            if on_phase is not None:
                info = dict(info)
                info.setdefault("step", cur["step"])
                info["occurrence"] = occ
                info["leaves"] = cur["leaves"]
                info["store"] = store
                on_phase(phase, info)

        store.add_phase_hook(hook)
        red = store.init(leaves)
        hook("init", {"red": red})
        try:
            for step in range(1, self.steps + 1):
                cur["step"] = step
                leaves, events = self.mutate(rng, step, leaves)
                cur["leaves"] = leaves
                red = store.on_write(red, events=events)
                act = self.actions.get(step)
                if act is not None:
                    res = act(store, leaves, red)
                    if res is not None:
                        leaves, red = dict(res[0]), dict(res[1])
                        cur["leaves"] = leaves
                held = step in self.hold_inflight_steps
                if not held:
                    # Determinism: a non-held tick always sees the in-flight
                    # update as ready, whatever the device's timing, so the
                    # adopt-vs-coalesce branch (and the enumerated crash
                    # points) never depend on it.
                    store.sync_inflight()
                with self._held_readiness(held):
                    red, rep = store.tick(
                        leaves, red, step,
                        scrub_period=self.scrub_every or None)
                if rep.repaired:
                    leaves = dict(leaves)
                    leaves.update(rep.repaired)
                    cur["leaves"] = leaves
            if self.flush_at_end:
                red = store.flush(leaves, red, step=self.steps)
                drained = store.take_repaired()
                if drained:
                    leaves = dict(leaves)
                    leaves.update(drained)
                    cur["leaves"] = leaves
        finally:
            store.remove_phase_hook(hook)
        return store, leaves, red, fired

    def enumerate_phases(self) -> List[Tuple[str, int]]:
        """Dry run: every (phase, occurrence) a crash could land in."""
        _, _, _, fired = self._drive()
        return fired

    # ------------------------------------------------------------ crashing
    def run_crash(self, plan: CrashPlan,
                  faults: Sequence[FaultSpec] = ()) -> CrashOutcome:
        """Replay the workload, die at ``plan``, restart, classify.

        ``faults`` are applied to the *persisted* state between death and
        restart: corruption landing while the process is down.
        """

        def on_phase(phase: str, info: dict):
            if phase == plan.phase and info["occurrence"] == plan.occurrence:
                raise _CrashNow(phase, info.get("red"), info["leaves"],
                                int(info["step"]), store=info["store"])

        t0 = time.perf_counter()
        try:
            self._drive(on_phase)
        except _CrashNow as crash:
            return self._restart(plan, crash, faults, time.perf_counter() - t0)
        raise ValueError(
            f"plan {plan} never fired; enumerate_phases() lists valid "
            "crash points for this workload")

    def _restart(self, plan: CrashPlan, crash: _CrashNow,
                 faults: Sequence[FaultSpec], drive_s: float) -> CrashOutcome:
        """Persist the crash-time view, corrupt it, restore, classify."""
        # The crashed store's update may still be running on its side
        # stream, writing the live view's checksums and parity: everything
        # below reads them after it.
        crash.store.await_inflight()
        pristine = {k: v.detach().clone() for k, v in crash.leaves.items()}
        leaves, red = dict(crash.leaves), dict(crash.red_live)
        # The window is judged at the instant of death: exactly the
        # dirty|shadow set the persisted bitmaps encode.  The probe store
        # is consulted only for static geometry.
        probe_store = self._probe()
        window = vulnerability_window(probe_store, red)
        factors = {n: probe_store.shard_factor(n) for n in probe_store.metas}
        for spec in faults:
            leaves, red = apply_fault(probe_store.metas, leaves, red, spec,
                                      factors=factors)
        state = StoreState(leaves=dict(leaves), red=red, step=crash.step)
        # One directory per replay: the manager's keep-last-k GC must never
        # collect a checkpoint another replay of this sweep just wrote.
        mgr = CheckpointManager(
            f"{self.ckpt_dir}/crash_{plan.phase}_{plan.occurrence}",
            device=probe_store.device)
        t0 = time.perf_counter()
        mgr.save(crash.step, state, blocking=True)
        t1 = time.perf_counter()
        # ----- restart: fresh process, fresh store, verified restore -----
        store2 = self.make_store()
        restored = mgr.restore_verified(
            _struct(state), store2,
            leaves_of=lambda st: st.leaves,
            replace_leaves=lambda st, lv: dataclasses.replace(
                st, leaves=dict(lv)),
            step=crash.step)
        seconds = {"drive_s": drive_s, "save_s": t1 - t0,
                   "restore_s": time.perf_counter() - t1}
        win_sets = {n: set(np.flatnonzero(m).tolist())
                    for n, m in window.blocks.items() if m.any()}
        if restored is None:
            return CrashOutcome(plan=plan, step=crash.step,
                                classification="rejected", diverged={},
                                window=win_sets, seconds=seconds)
        diverged = self._block_diff(probe_store, restored.leaves, pristine)
        in_window = all(
            window.contains(name, b)
            for name, blks in diverged.items() for b in blks)
        # Forward progress: the restarted store must bring the restored
        # state back to full coverage and a clean scrub.
        red2 = store2.flush(restored.leaves, restored.red,
                            step=int(restored.step))
        scrub_after = store2.scrub_check(restored.leaves, red2)
        if not diverged:
            cls = "recovered_bitwise"
        elif in_window:
            cls = "lost_within_window"
        else:
            cls = "FAILED"
        if scrub_after != 0:
            cls = "FAILED"
        return CrashOutcome(plan=plan, step=crash.step, classification=cls,
                            diverged=diverged, window=win_sets,
                            scrub_after_flush=int(scrub_after), seconds=seconds)

    @staticmethod
    def _block_diff(store, got: Mapping[str, torch.Tensor],
                    want: Mapping[str, torch.Tensor]) -> Dict[str, Set[int]]:
        """Blocks whose restored bits differ from the pristine crash view,
        by global block id (sharded leaves shard by shard, through each
        shard's local lane view)."""
        out: Dict[str, Set[int]] = {}
        for name, meta in store.protected_metas.items():
            eng = store.engine_for(name)
            a = eng.lanes_by_shard(got[name], name)
            b = eng.lanes_by_shard(want[name].to(a.device), name)
            bad = torch.nonzero((a != b).any(dim=2).reshape(-1)).flatten().tolist()
            if bad:
                out[name] = set(bad)
        return out

    # -------------------------------------------------------------- sweeps
    def sweep(self, faults_for: Optional[Callable[[CrashPlan], Sequence[FaultSpec]]] = None,
              require_phases: Sequence[str] = (),
              only_phases: Sequence[str] = ()) -> List[CrashOutcome]:
        """Crash at every enumerated phase occurrence; every outcome must be
        recoverable or provably lost within the window.

        ``require_phases`` asserts the workload actually exercised the
        named phases before sweeping (a too-tame workload would pass
        vacuously); ``only_phases`` restricts the replayed crashes to the
        named phases (still enumerated from the full run).
        """
        fired = self.enumerate_phases()
        have = {p for p, _ in fired}
        missing = set(require_phases) - have
        if missing:
            raise AssertionError(
                f"workload never reached phases {sorted(missing)}; "
                f"fired={sorted(have)}")
        keep = set(only_phases)
        outcomes = []
        for phase, occ in fired:
            if keep and phase not in keep:
                continue
            plan = CrashPlan(phase, occ)
            faults = tuple(faults_for(plan)) if faults_for else ()
            outcomes.append(self.run_crash(plan, faults))
        return outcomes
