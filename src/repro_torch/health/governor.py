"""Freshness-SLO health governor: breaker state machine + escalation ladder.

The port of ``repro.health.governor``: host logic, the same ladder,
breaker and reports.  Two places differ, both because the port's store is
eager and, on the card, runs its update on a side CUDA stream in place:
rung 3's ``admit`` is a no-op while ``torch.compile`` traces (the
reference's check for a jax tracer), and rung 1 hands the abandoned
update to the store (``ProtectedStore._abandon``), which keeps its
completion event so that every later reader of the group's checksums and
parity is ordered after it.

The paper's headline contract is a *tunable knob between performance and
quicker redundancy* — ``max_vulnerable_steps``/``_seconds`` on
:class:`repro_torch.core.RedundancyPolicy`.  Without enforcement that knob is
best-effort: a wedged async dispatch, a straggler storm, or a
rebuild/remesh monopolizing the tick ladder can silently blow the
deadline.  The :class:`HealthGovernor` is the enforcement layer.  It is
owned by :class:`repro_torch.core.ProtectedStore` (constructed in ``attach``
when ``policy.health`` is set; ``None`` by default — zero overhead when
off) and hooks the tick at three points: ``begin_tick`` (reset per-tick
scratch), the per-group ladder probes inside the group loop, and
``end_tick`` (age audit, breaker transitions, ``TickReport.health``).

Per monitored (vilamb) group it tracks:

* **vulnerability age** — steps and wall-clock since the group's last
  adopted redundancy update (the store's ``last_update_step/_time``
  clocks),
* **in-flight dispatch latency** — wall-clock age of the group's
  ``_Pending`` async update,
* **starvation** — patrol starvation streak and active rebuild/remesh,
  surfaced on :class:`HealthReport` for operators and the autotuner.

and drives a per-group breaker ``HEALTHY -> DEGRADED -> CRITICAL`` with
hysteresis on recovery (``recovery_ticks`` calm ticks step the breaker
*down one level*; escalation is immediate).  The escalation ladder:

1. **retry** — a pending older than ``dispatch_timeout_s`` whose fit
   flags are still not ready is abandoned (the group's freshness clocks
   roll back to their pre-dispatch values so the deadline keeps counting
   from the oldest unprotected write) and re-dispatched after a bounded
   exponential backoff (:mod:`repro_torch.health.backoff`), at most
   ``dispatch_retry_attempts`` times within ``retry_total_s``;
2. **forced resolve** — within ``deadline_margin_steps``/``_s`` of the
   deadline the tick stops speculating: the in-flight update is resolved
   blocking and a fresh update dispatched, so the deadline is met *early*
   rather than missed;
3. **backpressure** — once rung 1 exhausts (or the deadline is actually
   violated) foreground writes are admission-controlled in ``on_write``:
   ``backpressure="error"`` raises :class:`BackpressureError`,
   ``"spin"`` applies a bounded per-write sleep (``backpressure_spin_s``)
   so the device can drain.  Host-side only — while ``torch.compile``
   traces a step admission is a no-op (the compiled step never blocks);
4. **sync escalation** — the group temporarily abandons the async
   pipeline and runs a blocking update *every tick* (the sync-policy
   equivalent for vilamb groups: zero vulnerability window at the cost
   of per-tick stall) until the breaker recovers to HEALTHY.

Every rung fires a :class:`HealthAction` and every breaker transition is
surfaced on ``TickReport.health`` (:class:`HealthReport`).  Only when the
ladder is exhausted and a group's age still exceeds its deadline does the
governor raise :class:`FreshnessViolationError`
(``violation_mode="raise"``) or record it on ``HealthReport.violations``
(``"report"``) — a deadline miss is *never* silent.

During an elastic remesh the store's group loop is skipped wholesale —
the one window where the ladder above cannot run — and the store's tick
calls ``remesh_overdue`` and, after draining the migration and running a
blocking update on the new geometry, ``note_remesh_drain``
(``remesh_drain``, rung 2).
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List, Optional, Tuple

import torch

from .backoff import backoff_delay

__all__ = [
    "HEALTHY", "DEGRADED", "CRITICAL", "BREAKER_STATES",
    "HealthPolicy", "HealthAction", "HealthReport",
    "BackpressureError", "FreshnessViolation", "FreshnessViolationError",
    "HealthGovernor",
]

HEALTHY = "healthy"
DEGRADED = "degraded"
CRITICAL = "critical"
BREAKER_STATES = (HEALTHY, DEGRADED, CRITICAL)
_LEVEL = {HEALTHY: 0, DEGRADED: 1, CRITICAL: 2}


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Governor knobs (``RedundancyPolicy.health``; the reference's
    fields, defaults and validation)."""
    # Rung 1: wedged-dispatch timeout + bounded exponential retry backoff.
    # The backoff knobs share read_verified's read_retry_* semantics in
    # the reference (both draw from the backoff module).
    dispatch_timeout_s: float = 0.5        # 0 disables rung 1
    dispatch_retry_attempts: int = 3
    retry_backoff_s: float = 0.005
    retry_backoff_cap_s: float = 0.1
    retry_jitter_frac: float = 0.25
    retry_total_s: float = 0.5
    # Rung 2: force a blocking resolve this many steps / seconds *before*
    # the group's max_vulnerable_* deadline would expire.
    deadline_margin_steps: int = 1
    deadline_margin_s: float = 0.0
    # Rung 3: foreground admission control once the breaker is CRITICAL.
    backpressure: str = "spin"             # none | error | spin
    backpressure_spin_s: float = 0.002
    # Rung 4: blocking update every tick until recovery.
    sync_escalation: bool = True
    # Hysteresis: calm ticks required to step the breaker down one level.
    recovery_ticks: int = 3
    # Mid-remesh enforcement: drain the migration when a margin expires
    # (True) vs keep the bounded window and report the violation (False).
    remesh_drain: bool = True
    violation_mode: str = "raise"          # raise | report
    jitter_seed: int = 0

    def __post_init__(self):
        if self.backpressure not in ("none", "error", "spin"):
            raise ValueError(
                f"backpressure must be none|error|spin, got "
                f"{self.backpressure!r}")
        if self.violation_mode not in ("raise", "report"):
            raise ValueError(
                f"violation_mode must be raise|report, got "
                f"{self.violation_mode!r}")


@dataclasses.dataclass(frozen=True)
class HealthAction:
    """One escalation-ladder rung firing for one group on one tick."""
    group: str
    rung: int          # 1=retry 2=forced_resolve/remesh_drain 3=backpressure 4=sync
    kind: str
    step: int
    detail: str = ""


@dataclasses.dataclass(frozen=True)
class FreshnessViolation:
    """One group whose vulnerability age exceeded its deadline at tick end."""
    group: str
    step: int
    age_steps: int
    age_seconds: float
    deadline_steps: int
    deadline_seconds: float


class BackpressureError(RuntimeError):
    """Foreground write rejected by rung-3 admission control.

    Raised from ``on_write`` (host path only) while one or more groups'
    breakers are CRITICAL and ``HealthPolicy.backpressure == "error"``.
    The write was NOT recorded — back off and retry, or switch the policy
    to ``"spin"`` for transparent throttling.
    """

    def __init__(self, groups: Tuple[str, ...]):
        self.groups = tuple(groups)
        super().__init__(
            "foreground write backpressured: breaker CRITICAL for group(s) "
            + ", ".join(self.groups))


class FreshnessViolationError(RuntimeError):
    """The escalation ladder was exhausted and a freshness deadline is
    still blown — the typed, never-silent end of the line."""

    def __init__(self, violations: Tuple[FreshnessViolation, ...]):
        self.violations = tuple(violations)
        msg = "; ".join(
            f"{v.group}: age {v.age_steps} steps/{v.age_seconds:.3f}s vs "
            f"deadline {v.deadline_steps} steps/{v.deadline_seconds:.3f}s"
            for v in self.violations)
        super().__init__(f"freshness deadline violated after escalation "
                         f"ladder exhausted: {msg}")


@dataclasses.dataclass
class HealthReport:
    """Per-tick governor observability (``TickReport.health``)."""
    step: int
    states: Dict[str, str] = dataclasses.field(default_factory=dict)
    # (group, from_state, to_state) breaker transitions this tick.
    transitions: Tuple[Tuple[str, str, str], ...] = ()
    actions: Tuple[HealthAction, ...] = ()
    # group -> (age_steps, age_seconds) at tick end.
    ages: Dict[str, Tuple[int, float]] = dataclasses.field(
        default_factory=dict)
    violations: Tuple[FreshnessViolation, ...] = ()
    # Rung-3 admissions throttled/rejected since the previous tick.
    backpressure_events: int = 0
    # Starvation surface (mirrors TickReport; here so one object carries
    # the whole health picture for operators and the autotuner).
    patrol_starved_ticks: int = 0
    rebuild_active: bool = False
    remesh_active: bool = False

    @property
    def worst(self) -> str:
        return max(self.states.values(), key=_LEVEL.__getitem__,
                   default=HEALTHY)


@dataclasses.dataclass
class _GroupHealth:
    """Mutable per-group breaker bookkeeping (keyed by group label, so it
    survives remesh adoption's group-object swap)."""
    state: str = HEALTHY
    calm: int = 0
    retries: int = 0
    retry_spent_s: float = 0.0
    sync_escalated: bool = False
    backpressure: bool = False
    acted: bool = False        # per-tick scratch: any ladder rung fired


class HealthGovernor:
    """Breaker + escalation ladder for one :class:`ProtectedStore`.

    The store calls (in tick order): ``begin_tick`` -> per group
    ``check_pending`` / ``within_margin`` / ``is_sync_escalated`` ->
    (``note_forced_resolve`` / ``note_remesh_drain`` as rungs fire) ->
    ``end_tick``.  ``admit`` hooks ``on_write``.
    """

    def __init__(self, store, hp: Optional[HealthPolicy] = None):
        if hp is None:
            cand = getattr(store.policy, "health", None)
            hp = cand if isinstance(cand, HealthPolicy) else HealthPolicy()
        self.store = store
        self.hp = hp
        self._groups: Dict[str, _GroupHealth] = {}
        self._rng = random.Random(hp.jitter_seed)
        self._sleep = time.sleep           # injectable (tests, benches)
        self._step = 0
        self._now = time.monotonic()
        self._actions: List[HealthAction] = []
        self._violations: List[FreshnessViolation] = []
        self._transitions: List[Tuple[str, str, str]] = []
        self._bp_events = 0
        self.last_report: Optional[HealthReport] = None

    # ------------------------------------------------------------- lookup

    def group(self, label: str) -> _GroupHealth:
        gh = self._groups.get(label)
        if gh is None:
            gh = self._groups[label] = _GroupHealth()
        return gh

    def is_sync_escalated(self, label: str) -> bool:
        gh = self._groups.get(label)
        return gh is not None and gh.sync_escalated

    def backpressure_groups(self) -> Tuple[str, ...]:
        return tuple(l for l, gh in self._groups.items() if gh.backpressure)

    # ------------------------------------------------------ tick lifecycle

    def begin_tick(self, step: int, now: float) -> None:
        self._step, self._now = step, now
        self._actions = []
        self._violations = []
        self._transitions = []
        for gh in self._groups.values():
            gh.acted = False

    def _act(self, label: str, rung: int, kind: str, detail: str = "",
             *, counts: bool = True) -> None:
        self._actions.append(HealthAction(label, rung, kind, self._step,
                                          detail))
        if counts:
            self.group(label).acted = True

    def _escalate(self, label: str, target: str) -> None:
        gh = self.group(label)
        if _LEVEL[target] > _LEVEL[gh.state]:
            self._transitions.append((label, gh.state, target))
            gh.state = target
        gh.calm = 0

    # Rung 1 ----------------------------------------------------------------

    def check_pending(self, g) -> bool:
        """Timeout a wedged in-flight update; abandon, backoff, escalate.

        Returns True when a pending was abandoned: the tick must
        re-dispatch ``g`` *this tick* (the periodic ``due`` check is
        step-aligned, so waiting for it would let the breaker cool down
        between retries and the retry budget would never be consumed).
        Abandoning rolls the group's freshness clocks back to their
        pre-dispatch values; the live view's epoch shadow keeps every
        block covered by the abandoned update conservatively dirty, so
        no coverage is lost."""
        hp = self.hp
        p = g.pending
        if p is None or hp.dispatch_timeout_s <= 0.0:
            return False
        # dispatched_at stamps the batched dispatch: an update stuck on
        # the side stream behind a wedged device ages — and abandons —
        # exactly like a launched-but-unfinished one.
        age = time.monotonic() - p.dispatched_at
        if age < hp.dispatch_timeout_s:
            return False
        from ..core import store as store_mod       # patched in tests
        if store_mod._ready(p.done):
            return False                 # slow but done: resolve, don't kill
        gh = self.group(g.label)
        # Roll the freshness clocks back to the oldest unprotected write
        # (min: a step-counter rebase may already have zeroed them).
        g.last_update_step = min(g.last_update_step, p.prev_step)
        g.last_update_time = min(g.last_update_time, p.prev_time)
        # On the card the abandoned update keeps writing the live view's
        # checksums and parity in place: the store keeps its completion
        # event, and orders every later reader (and a blocking pass) after
        # it.  The retry runs on the same side stream, so stream order
        # covers it.
        self.store._abandon(g)
        gh.retries += 1
        if gh.retries > hp.dispatch_retry_attempts:
            # Rung 1 exhausted: escalate to backpressure + sync escalation.
            self._escalate(g.label, CRITICAL)
            self._act(g.label, 1, "retry_exhausted",
                      f"attempt {gh.retries} > {hp.dispatch_retry_attempts}")
            if hp.backpressure != "none" and not gh.backpressure:
                gh.backpressure = True
                self._act(g.label, 3, "backpressure_on")
            if hp.sync_escalation and not gh.sync_escalated:
                gh.sync_escalated = True
                self._act(g.label, 4, "sync_escalate")
            return True
        self._escalate(g.label, DEGRADED)
        delay = backoff_delay(gh.retries, hp.retry_backoff_s,
                              cap=hp.retry_backoff_cap_s,
                              jitter_frac=hp.retry_jitter_frac,
                              rng=self._rng)
        if hp.retry_total_s > 0.0:
            delay = min(delay, max(0.0, hp.retry_total_s - gh.retry_spent_s))
        self._act(g.label, 1, "retry_timeout",
                  f"attempt {gh.retries}, pending age {age:.3f}s, "
                  f"backoff {delay * 1e3:.1f}ms")
        if delay > 0.0:
            self._sleep(delay)
            gh.retry_spent_s += delay
        return True

    # Rung 2 ----------------------------------------------------------------

    def within_margin(self, g, step: int, now: float) -> bool:
        """True when ``g`` is within the configured margin of its
        freshness deadline — the tick must stop speculating."""
        hp, lp = self.hp, g.policy
        if (lp.max_vulnerable_steps > 0 and hp.deadline_margin_steps > 0
                and step - g.last_update_step
                >= lp.max_vulnerable_steps - hp.deadline_margin_steps):
            return True
        if (lp.max_vulnerable_seconds > 0 and hp.deadline_margin_s > 0
                and now - g.last_update_time
                >= lp.max_vulnerable_seconds - hp.deadline_margin_s):
            return True
        return False

    def note_forced_resolve(self, label: str, step: int) -> None:
        self._escalate(label, DEGRADED)
        self._act(label, 2, "forced_resolve",
                  "margin expiring: in-flight update resolved blocking")

    # Remesh hole ----------------------------------------------------------

    def remesh_overdue(self, step: int, now: float) -> Tuple[str, ...]:
        """Vilamb groups whose margin (or deadline) expired while the
        group loop is suspended by an active remesh."""
        out = []
        for g in self.store._protected():
            lp = g.policy
            if lp.mode != "vilamb":
                continue
            if not (lp.max_vulnerable_steps > 0
                    or lp.max_vulnerable_seconds > 0):
                continue
            hit = self.within_margin(g, step, now)
            hit |= (lp.max_vulnerable_steps > 0
                    and step - g.last_update_step >= lp.max_vulnerable_steps)
            hit |= (lp.max_vulnerable_seconds > 0
                    and now - g.last_update_time >= lp.max_vulnerable_seconds)
            if hit:
                out.append(g.label)
        return tuple(out)

    def note_remesh_drain(self, label: str, step: int) -> None:
        self._escalate(label, DEGRADED)
        self._act(label, 2, "remesh_drain",
                  "migration drained synchronously: freshness SLO beats "
                  "the bounded per-tick window")

    # Rung 3 ----------------------------------------------------------------

    def admit(self, red) -> None:
        """``on_write`` admission control.  Host path only: while
        ``torch.compile`` traces the step this is a no-op (the compiled
        step must never block).  The port's ``on_write`` is eager, so the
        reference's check for a jax tracer among ``red``'s leaves becomes
        ``torch.compiler.is_compiling()``."""
        flagged = self.backpressure_groups()
        if not flagged:
            return
        if torch.compiler.is_compiling():
            return
        self._bp_events += 1
        if self.hp.backpressure == "error":
            raise BackpressureError(flagged)
        if self.hp.backpressure == "spin" and self.hp.backpressure_spin_s > 0:
            self._sleep(self.hp.backpressure_spin_s)

    # ---------------------------------------------------------- end of tick

    def end_tick(self, report, step: int, now: float) -> None:
        """Audit every monitored group's age, run the breaker, attach
        :class:`HealthReport` to ``report``; raise on exhausted ladder."""
        hp = self.hp
        states: Dict[str, str] = {}
        ages: Dict[str, Tuple[int, float]] = {}
        for g in self.store._protected():
            lp = g.policy
            if lp.mode != "vilamb":
                continue
            gh = self.group(g.label)
            age_steps = max(0, step - g.last_update_step)
            age_s = max(0.0, now - g.last_update_time)
            ages[g.label] = (age_steps, age_s)
            violated = (
                (lp.max_vulnerable_steps > 0
                 and age_steps > lp.max_vulnerable_steps)
                or (lp.max_vulnerable_seconds > 0
                    and age_s > lp.max_vulnerable_seconds))
            if violated:
                self._violations.append(FreshnessViolation(
                    g.label, step, age_steps, age_s,
                    lp.max_vulnerable_steps, lp.max_vulnerable_seconds))
                # Ladder exhausted for this tick: engage rungs 3+4 so the
                # *next* ticks recover, and trip the breaker.
                if hp.backpressure != "none" and not gh.backpressure:
                    gh.backpressure = True
                    self._act(g.label, 3, "backpressure_on",
                              "deadline violated")
                if hp.sync_escalation and not gh.sync_escalated:
                    gh.sync_escalated = True
                    self._act(g.label, 4, "sync_escalate",
                              "deadline violated")
                self._escalate(g.label, CRITICAL)
            elif gh.acted:
                # Some rung fired: the tick was not calm.  Rung >= 3 means
                # CRITICAL; rung 1/2 alone means DEGRADED (escalations
                # already applied where they fired; this just resets calm).
                gh.calm = 0
            else:
                gh.calm += 1
                if gh.state != HEALTHY and gh.calm >= hp.recovery_ticks:
                    down = HEALTHY if gh.state == DEGRADED else DEGRADED
                    self._transitions.append((g.label, gh.state, down))
                    gh.state = down
                    gh.calm = 0
                    if gh.state != CRITICAL and gh.backpressure:
                        gh.backpressure = False
                        self._act(g.label, 3, "backpressure_off",
                                  counts=False)
                    if gh.state == HEALTHY:
                        gh.sync_escalated = False
                        gh.retries = 0
                        gh.retry_spent_s = 0.0
            states[g.label] = gh.state
        rep = HealthReport(
            step=step, states=states,
            transitions=tuple(self._transitions),
            actions=tuple(self._actions), ages=ages,
            violations=tuple(self._violations),
            backpressure_events=self._bp_events,
            patrol_starved_ticks=int(report.patrol_starved_ticks),
            rebuild_active=(report.rebuild is not None
                            and not report.rebuild.done),
            remesh_active=(report.remesh is not None
                           and not report.remesh.done))
        self._bp_events = 0
        report.health = rep
        self.last_report = rep
        if self._violations and hp.violation_mode == "raise":
            raise FreshnessViolationError(tuple(self._violations))
