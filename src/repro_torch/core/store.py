"""ProtectedStore — the library facade that owns the redundancy lifecycle.

Callers hand over any nested dict of tensors and interact with three calls:

  * ``store.attach(tree)``              declare what is protected and how
  * ``store.on_write(red, events=...)`` record each write batch
  * ``store.tick(leaves, red, step)``   once per host step; schedules
    Algorithm-1 updates, scrubbing with the paper's double-check,
    straggler back-off, and freshness deadlines

plus ``flush`` for the preemption/battery path.  Policies are declarative
and per leaf group: params may run ``sync`` (Pangolin-analogue inline
diff) while a heap runs ``vilamb``.  Each distinct resolved policy becomes
one :class:`~repro_torch.core.engine.RedundancyEngine`.

This is the blocking tick: a due group's update runs before ``tick``
returns.  The store runs on the GPU unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import collections
import dataclasses
import fnmatch
import statistics
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import torch

from ..common import flatten_dict, resolve_device
from . import policy as policy_mod
from . import workqueue
from .blocks import (DEFAULT_LANES_PER_BLOCK, DEFAULT_STRIPE_DATA_BLOCKS,
                     BlockMeta, make_meta)
from .engine import ALL, RedundancyConfig, RedundancyEngine
from .state import LeafRedundancy, RedundancyState

MODES = ("none", "sync", "vilamb")


# --------------------------------------------------------------------- policy
@dataclasses.dataclass(frozen=True)
class LeafPolicy:
    """Redundancy policy for one leaf group.

    ``max_vulnerable_steps`` / ``max_vulnerable_seconds`` bound how long
    blocks may stay vulnerable before an update is forced, however the
    straggler governor has stretched the period.  0 disables.
    """
    mode: str = "vilamb"                 # none | sync | vilamb
    period_steps: int = 8                # Algorithm-1 period T (vilamb)
    scrub_period_steps: int = 0          # 0 = no scheduled scrubbing
    max_vulnerable_steps: int = 0        # freshness deadline, in steps
    max_vulnerable_seconds: float = 0.0  # freshness deadline, wall clock
    # CPU work-queue capacity (fraction of each leaf's stripes); None
    # inherits RedundancyPolicy.work_queue_frac, <= 0 disables the queue.
    work_queue_frac: Optional[float] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"unknown redundancy mode {self.mode!r} (want one of {MODES})")


@dataclasses.dataclass(frozen=True)
class RedundancyPolicy:
    """Declarative store-wide policy: per-leaf rules + shared geometry.

    ``rules`` are ``(fnmatch_pattern, LeafPolicy)`` pairs, first match wins;
    unmatched leaves get ``default``.
    """
    default: LeafPolicy = LeafPolicy()
    rules: Tuple[Tuple[str, LeafPolicy], ...] = ()
    lanes_per_block: int = DEFAULT_LANES_PER_BLOCK
    stripe_data_blocks: int = DEFAULT_STRIPE_DATA_BLOCKS
    work_queue_frac: float = workqueue.DEFAULT_QUEUE_FRAC
    # Straggler governor: stretch periods under sustained slowdown, shrink
    # back once step times renormalize.
    straggler_factor: float = 3.0
    straggler_window: int = 20
    straggler_recovery_steps: int = 10
    period_cap: int = 4096
    # The overlap pipeline is not ported: True raises at store construction
    # rather than silently running the blocking tick.
    async_tick: bool = False

    def leaf_policy(self, name: str) -> LeafPolicy:
        for pattern, lp in self.rules:
            if fnmatch.fnmatchcase(name, pattern):
                return lp
        return self.default

    @classmethod
    def single(cls, mode: str, period_steps: int = 8,
               scrub_period_steps: int = 0, max_vulnerable_steps: int = 0,
               max_vulnerable_seconds: float = 0.0, **kw) -> "RedundancyPolicy":
        """One policy for every leaf (a one-group store)."""
        return cls(default=LeafPolicy(
            mode=mode, period_steps=period_steps,
            scrub_period_steps=scrub_period_steps,
            max_vulnerable_steps=max_vulnerable_steps,
            max_vulnerable_seconds=max_vulnerable_seconds), **kw)

    @classmethod
    def from_spec(cls, spec: str, default_mode: str = "vilamb",
                  period_steps: int = 8, scrub_period_steps: int = 0,
                  max_vulnerable_steps: int = 0, **kw) -> "RedundancyPolicy":
        """Parse ``"params/*=sync,m/*=vilamb:16,v/*=none"`` into rules.

        Each clause is ``pattern=mode[:period]``; omitted periods inherit
        ``period_steps``.  An empty spec yields a single-mode policy.
        """
        rules: List[Tuple[str, LeafPolicy]] = []
        for clause in filter(None, (c.strip() for c in spec.split(","))):
            pattern, _, rhs = clause.partition("=")
            if not rhs:
                raise ValueError(f"bad policy clause {clause!r} "
                                 "(want pattern=mode[:period])")
            mode, _, per = rhs.partition(":")
            rules.append((pattern.strip(), LeafPolicy(
                mode=mode.strip(), period_steps=int(per) if per else period_steps,
                scrub_period_steps=scrub_period_steps,
                max_vulnerable_steps=max_vulnerable_steps)))
        return cls(default=LeafPolicy(
            mode=default_mode, period_steps=period_steps,
            scrub_period_steps=scrub_period_steps,
            max_vulnerable_steps=max_vulnerable_steps), rules=tuple(rules), **kw)


# ------------------------------------------------------------------- governor
class StragglerGovernor:
    """Period back-off with recovery.

    Under sustained slowdown (a step > ``factor`` x the rolling median) the
    update period is stretched (doubled, capped); after ``recovery_steps``
    consecutive normal steps the stretch is halved back.
    """

    def __init__(self, factor: float = 3.0, window: int = 20,
                 recovery_steps: int = 10, max_scale: int = 512):
        self.factor = factor
        self.recovery_steps = recovery_steps
        self.max_scale = max_scale
        self.times: collections.deque = collections.deque(maxlen=window)
        self.scale = 1
        self._calm = 0

    def observe(self, dt: float) -> int:
        """Record one step time; returns the current period multiplier."""
        self.times.append(dt)
        if len(self.times) < self.times.maxlen:
            return self.scale
        med = statistics.median(self.times)
        if dt > self.factor * med:
            self.scale = min(self.scale * 2, self.max_scale)
            self._calm = 0
        elif self.scale > 1:
            self._calm += 1
            if self._calm >= self.recovery_steps:
                self.scale = max(1, self.scale // 2)
                self._calm = 0
        return self.scale


@dataclasses.dataclass
class TickReport:
    """What one ``tick`` did (host-side observability)."""
    step: int
    updated: Tuple[str, ...] = ()          # group labels that ran Algorithm 1
    deadline_fired: Tuple[str, ...] = ()   # subset forced by freshness deadline
    scrubbed: Tuple[str, ...] = ()
    mismatches: int = 0
    alarms: int = 0


@dataclasses.dataclass
class _Group:
    label: str
    policy: LeafPolicy
    names: Tuple[str, ...]
    engine: Optional[RedundancyEngine]     # None for mode == "none"
    last_update_step: int = 0
    last_update_time: float = dataclasses.field(default_factory=time.monotonic)


# ---------------------------------------------------------------------- store
class ProtectedStore:
    """Facade owning the redundancy lifecycle of one tree of tensors."""

    def __init__(self, policy: Optional[RedundancyPolicy] = None,
                 device: Union[str, torch.device, None] = None):
        self.policy = policy or RedundancyPolicy()
        if self.policy.async_tick:
            raise NotImplementedError(
                "the overlap-pipelined tick (async_tick=True) is not ported "
                "yet: ROADMAP.md, Queue 1 item 7 (the overlap pipeline)")
        self.device = resolve_device(device, "ProtectedStore")
        self.groups: Dict[str, _Group] = {}
        self.corruption_alarms = 0
        self._none_metas: Dict[str, BlockMeta] = {}
        self._governor = StragglerGovernor(
            factor=self.policy.straggler_factor,
            window=self.policy.straggler_window,
            recovery_steps=self.policy.straggler_recovery_steps)
        self._copy_rate: Optional[float] = None

    # ------------------------------------------------------------ construction
    def attach(self, tree: Any) -> "ProtectedStore":
        """Declare the protected tree (tensors on the store's device, or
        :class:`~repro_torch.core.blocks.ShapeDtype` structs).

        Nested dicts are flattened to ``a/b/c`` paths — the namespace the
        policy rules match against.  Returns ``self`` for chaining.
        """
        flat = flatten_dict(tree)
        for name, leaf in flat.items():
            dev = getattr(leaf, "device", self.device)
            if torch.device(dev) != self.device:
                raise ValueError(f"leaf {name!r} lies on {dev}, the store on "
                                 f"{self.device}")
        by_policy: Dict[LeafPolicy, List[str]] = {}
        for name in flat:
            by_policy.setdefault(self.policy.leaf_policy(name), []).append(name)
        self.groups = {}
        self._none_metas = {}
        for i, (lp, names) in enumerate(by_policy.items()):
            label = f"g{i}:{lp.mode}"
            engine = None
            if lp.mode == "none":
                for n in names:
                    self._none_metas[n] = make_meta(
                        flat[n], lanes_per_block=self.policy.lanes_per_block,
                        stripe_data_blocks=self.policy.stripe_data_blocks)
            else:
                cfg = RedundancyConfig(
                    mode=lp.mode, lanes_per_block=self.policy.lanes_per_block,
                    stripe_data_blocks=self.policy.stripe_data_blocks,
                    work_queue_frac=(
                        lp.work_queue_frac if lp.work_queue_frac is not None
                        else self.policy.work_queue_frac))
                engine = RedundancyEngine({n: flat[n] for n in names}, cfg,
                                          device=self.device)
            self.groups[label] = _Group(label, lp, tuple(names), engine)
        return self

    # ---------------------------------------------------------------- structure
    @property
    def metas(self) -> Dict[str, BlockMeta]:
        out = dict(self._none_metas)
        out.update(self.protected_metas)
        return out

    @property
    def protected_metas(self) -> Dict[str, BlockMeta]:
        """Metas of leaves that actually carry redundancy arrays."""
        out: Dict[str, BlockMeta] = {}
        for g in self._protected():
            out.update(g.engine.metas)
        return out

    def leaf_policy(self, name: str) -> LeafPolicy:
        for g in self.groups.values():
            if name in g.names:
                return g.policy
        raise KeyError(name)

    def engine_for(self, name: str) -> Optional[RedundancyEngine]:
        for g in self.groups.values():
            if name in g.names:
                return g.engine
        return None

    def _protected(self) -> List[_Group]:
        return [g for g in self.groups.values() if g.engine is not None]

    @property
    def has_sync(self) -> bool:
        return any(g.policy.mode == "sync" for g in self._protected())

    @property
    def has_periodic(self) -> bool:
        return any(g.policy.mode == "vilamb" for g in self._protected())

    @property
    def protects(self) -> bool:
        return bool(self._protected())

    def expand_events(self, sparse_events: Mapping[str, Any]) -> Dict[str, Any]:
        """Suffix-keyed sparse events -> full-path events, defaulting ALL.

        ``{"moe/wi": mask}`` fans out to every protected leaf whose path
        suffix (after the first ``/``) matches; unmatched leaves are marked
        fully dirty.
        """
        events: Dict[str, Any] = {}
        for g in self._protected():
            for name in g.names:
                _, _, suffix = name.partition("/")
                ev = sparse_events.get(suffix)
                events[name] = ev if ev is not None else ALL
        return events

    # ----------------------------------------------------------------- lifecycle
    def init(self, tree: Any) -> RedundancyState:
        """Full redundancy computation (paper: file-creation time)."""
        leaves = flatten_dict(tree)
        red: RedundancyState = {}
        for g in self._protected():
            red.update(g.engine.init({n: leaves[n] for n in g.names}))
        return red

    def on_write(self, red: RedundancyState,
                 events: Optional[Mapping[str, Any]] = None,
                 old: Optional[Mapping[str, torch.Tensor]] = None,
                 new: Optional[Mapping[str, torch.Tensor]] = None,
                 row_diffs: Optional[Mapping[str, Tuple]] = None
                 ) -> RedundancyState:
        """Record writes.

        Per leaf group: ``vilamb`` ORs ``events`` (dirty marks) into the
        bitvectors; ``sync`` applies the Pangolin inline diff from
        ``old``/``new`` (or the sparse ``row_diffs`` fast path
        ``{name: (rows, old_rows, new_rows)}`` when rows map 1:1 to blocks,
        which updates checksums and parity in place); ``none`` passes
        through.  Leaves absent from ``events`` are left unmarked.
        """
        events = dict(events or {})
        row_diffs = dict(row_diffs or {})
        out = dict(red)
        for g in self._protected():
            red_sub = {n: out[n] for n in g.names}
            if g.policy.mode == "vilamb":
                evs = {n: events[n] for n in g.names if n in events}
                if evs:
                    out.update(g.engine.mark_dirty(red_sub, evs))
            elif all(n in row_diffs for n in g.names):
                for n in g.names:
                    rows, o, v = row_diffs[n]
                    out[n] = g.engine.sync_update_rows(n, out[n], rows, o, v)
            elif old is not None and new is not None:
                out.update(g.engine.sync_update(
                    {n: old[n] for n in g.names},
                    {n: new[n] for n in g.names}, red_sub))
            else:
                raise ValueError(
                    f"sync leaves {g.names} need old=/new= (or row_diffs=) "
                    "in on_write")
        return out

    def _dispatch_blocking(self, g: _Group, sub, red_sub) -> RedundancyState:
        """Queued update when the live dirty stripes fit the CPU work queues
        (a host-side check), the full update otherwise; on the card the
        fused kernel serves both.  Bitwise-identical either way."""
        if g.engine.has_queue and g.engine.queue_fits(red_sub):
            return g.engine.redundancy_step_queued(sub, red_sub)
        return g.engine.redundancy_step(sub, red_sub)

    def tick(self, leaves: Union[Mapping[str, torch.Tensor], Callable[[], Any]],
             red: RedundancyState, step: int, *,
             step_time: Optional[float] = None,
             scrub_period: Optional[int] = None
             ) -> Tuple[RedundancyState, TickReport]:
        """One host-step heartbeat: schedule Algorithm 1 + scrubbing.

        Owns the ``step % T`` update cadence per vilamb group (stretched by
        the straggler governor, bounded by the freshness deadline) and
        scrubbing with the paper's double-check.  ``step_time`` feeds the
        governor; ``scrub_period`` overrides every group's scrub cadence.
        ``leaves`` may be the flat leaf mapping or a zero-arg callable
        returning it.  Callers must adopt the returned state: on the card a
        due update refreshes checksums and parity in place.
        """
        step = int(step)
        if step_time is not None:
            self._governor.observe(step_time)
        report = TickReport(step=step)
        out = dict(red)
        updated: List[str] = []
        deadline: List[str] = []
        scrub_groups: List[_Group] = []
        now = time.monotonic()
        materialized = None if callable(leaves) else leaves

        def sub_of(g):
            nonlocal materialized
            if materialized is None:
                materialized = leaves()
            return {n: materialized[n] for n in g.names}

        for g in self._protected():
            lp = g.policy
            if step < g.last_update_step:
                # The step counter restarted: rebase so deadlines keep meaning.
                g.last_update_step = 0
            sp = scrub_period if scrub_period is not None else lp.scrub_period_steps
            if lp.mode == "vilamb":
                eff = min(lp.period_steps * self._governor.scale,
                          self.policy.period_cap)
                due = policy_mod.should_update(step, eff)
                overdue = (
                    (lp.max_vulnerable_steps > 0
                     and step - g.last_update_step >= lp.max_vulnerable_steps)
                    or (lp.max_vulnerable_seconds > 0
                        and now - g.last_update_time >= lp.max_vulnerable_seconds))
                if due or overdue:
                    out.update(self._dispatch_blocking(
                        g, sub_of(g), {n: out[n] for n in g.names}))
                    g.last_update_step = step
                    g.last_update_time = now
                    updated.append(g.label)
                    if overdue and not due:
                        deadline.append(g.label)
            if sp and policy_mod.should_scrub(step, sp):
                scrub_groups.append(g)
        for g in scrub_groups:
            mm, alarms = self._scrub_group(g, sub_of(g), out)
            report.scrubbed += (g.label,)
            report.mismatches += mm
            report.alarms += alarms
        report.updated = tuple(updated)
        report.deadline_fired = tuple(deadline)
        return out, report

    def flush(self, leaves: Mapping[str, torch.Tensor], red: RedundancyState,
              step: Optional[int] = None) -> RedundancyState:
        """Battery/preemption flush: force Algorithm 1 on every vilamb group
        now (paper §3.3).  Sync groups are current by construction.  Pass
        ``step`` when known so the steps deadline does not fire a spurious
        pass right after the flush."""
        out = dict(red)
        now = time.monotonic()
        for g in self._protected():
            if g.policy.mode == "vilamb":
                out.update(self._dispatch_blocking(
                    g, {n: leaves[n] for n in g.names},
                    {n: out[n] for n in g.names}))
                g.last_update_time = now
                if step is not None:
                    g.last_update_step = int(step)
        return out

    def settle(self, red: RedundancyState,
               leaves: Optional[Mapping[str, torch.Tensor]] = None,
               step: Optional[int] = None) -> RedundancyState:
        """Adopt every in-flight update into ``red``.  The blocking tick
        leaves none in flight and runs no background drain, so this returns
        ``red`` as it is; callers written against the overlapped store call
        it all the same."""
        return dict(red)

    def take_repaired(self) -> Dict[str, torch.Tensor]:
        """Leaves replaced by a background drain since the last call: none
        under the blocking tick."""
        return {}

    def redundancy_step(self, leaves: Mapping[str, torch.Tensor],
                        red: RedundancyState) -> RedundancyState:
        """Algorithm 1 on every vilamb group, without touching the schedule."""
        out = dict(red)
        for g in self._protected():
            if g.policy.mode == "vilamb":
                out.update(g.engine.redundancy_step(
                    {n: leaves[n] for n in g.names},
                    {n: out[n] for n in g.names}))
        return out

    # ------------------------------------------------------- verify + recover
    def _scrub_group(self, g: _Group, sub, red) -> Tuple[int, int]:
        """Scrub one group given its leaf sub-dict (double-check protocol)."""
        red_sub = {n: red[n] for n in g.names}

        def count() -> int:
            mm = g.engine.scrub(sub, red_sub)
            return int(sum(int(v.sum()) for v in mm.values()))

        total = count()
        alarms = 0
        if total:
            # Double-check (paper §3.4): quiesce in-flight work, re-verify
            # before raising the alarm.
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            total = count()
            if total:
                alarms = 1
                self.corruption_alarms += 1
        return total, alarms

    def scrub(self, leaves: Mapping[str, torch.Tensor], red: RedundancyState
              ) -> Dict[str, torch.Tensor]:
        """Per-leaf mismatch masks over clean blocks (no double-check)."""
        out: Dict[str, torch.Tensor] = {}
        for g in self._protected():
            out.update(g.engine.scrub({n: leaves[n] for n in g.names},
                                      {n: red[n] for n in g.names}))
        return out

    def scrub_check(self, leaves: Mapping[str, torch.Tensor],
                    red: RedundancyState) -> int:
        """Scrub all protected groups with the double-check protocol."""
        return sum(self._scrub_group(g, {n: leaves[n] for n in g.names}, red)[0]
                   for g in self._protected())

    def verify_meta(self, red: RedundancyState) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for g in self._protected():
            out.update(g.engine.verify_meta({n: red[n] for n in g.names}))
        return out

    def recover_block(self, leaf: torch.Tensor, r: LeafRedundancy, name: str,
                      block_id: int) -> Tuple[torch.Tensor, bool]:
        """Rebuild one block from parity, in place (see
        :meth:`RedundancyEngine.recover_block`)."""
        engine = self.engine_for(name)
        if engine is None:
            raise KeyError(f"{name} is not parity-protected")
        return engine.recover_block(leaf, r, name, block_id)

    def vulnerable_masks(self, red: RedundancyState) -> Dict[str, torch.Tensor]:
        """Per-leaf bool[n_blocks] masks of the vulnerability window."""
        out: Dict[str, torch.Tensor] = {}
        for g in self._protected():
            out.update(g.engine.vulnerable_masks({n: red[n] for n in g.names}))
        return out

    # ------------------------------------------------------------- accounting
    def dirty_stats(self, red: RedundancyState) -> Dict[str, Dict[str, Any]]:
        """Per-leaf dirty/vulnerable counts."""
        out: Dict[str, Dict[str, Any]] = {}
        for g in self._protected():
            out.update(g.engine.dirty_stats({n: red[n] for n in g.names}))
        return out

    def copy_bytes_per_sec(self) -> float:
        """Device-to-device copy rate (bytes read + written per second),
        measured once on the card with CUDA events over a 256 MiB copy."""
        if self._copy_rate is None:
            if self.device.type != "cuda":
                raise ValueError("no memory rate is measured on the CPU: "
                                 "pass bytes_per_sec to estimate_flush")
            n = 256 << 20
            src = torch.empty((n,), dtype=torch.uint8, device=self.device)
            dst = torch.empty_like(src)
            dst.copy_(src)
            reps = 5
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                dst.copy_(src)
            end.record()
            end.synchronize()
            self._copy_rate = 2 * n * reps / (start.elapsed_time(end) / 1e3)
        return self._copy_rate

    def estimate_flush(self, red: RedundancyState,
                       bytes_per_sec: Optional[float] = None
                       ) -> policy_mod.FlushEstimate:
        """Size the preemption flush (battery analogue, paper §4.7), at
        ``bytes_per_sec`` or the card's measured copy rate."""
        stats = {n: {k: int(v) for k, v in s.items()}
                 for n, s in self.dirty_stats(red).items()}
        metas = self.metas
        rate = bytes_per_sec if bytes_per_sec is not None else self.copy_bytes_per_sec()
        return policy_mod.estimate_flush(
            stats, {n: metas[n].bytes_per_block for n in stats},
            self.policy.stripe_data_blocks, rate)
