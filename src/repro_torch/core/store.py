"""ProtectedStore — the library facade that owns the redundancy lifecycle.

Callers hand over any nested dict of tensors and interact with three calls:

  * ``store.attach(tree)``              declare what is protected and how
  * ``store.on_write(red, events=...)`` record each write batch
  * ``store.tick(leaves, red, step)``   once per host step; schedules
    Algorithm-1 updates, scrubbing with the paper's double-check,
    straggler back-off, and freshness deadlines

plus ``flush`` for the preemption/battery path and ``settle`` to adopt
in-flight updates.  Policies are declarative and per leaf group: params
may run ``sync`` (Pangolin-analogue inline diff) while a heap runs
``vilamb``.  Each distinct resolved policy becomes one
:class:`~repro_torch.core.engine.RedundancyEngine`.

The default tick is overlap-pipelined (``RedundancyPolicy.async_tick``,
``REPRO_ASYNC_TICK=0`` selects the blocking tick): a due tick swaps the
dirty epochs and launches the update on the store's side CUDA stream,
and a later tick adopts it.  The update refreshes ``checksums`` and
``parity`` in place, so while it is in flight the live view carries the
pending update's own arrays.  Stream-ordering rule: ``red``'s
``checksums``, ``parity`` and ``meta_ck`` are ordered after an in-flight
update only on the stream that called ``settle``, ``flush`` or an
adopting ``tick`` (or a store reader such as ``verify_meta``, which
makes its stream wait on the update on the device); any other stream
must be ordered after that call, or call ``await_inflight`` (which
adopts nothing), before it reads them.  The store runs on
the GPU unless the caller passes ``device="cpu"``, where dispatch runs
to completion and the live view keeps the previous epoch's arrays, as
the reference's does.

Sharded stores (``ProtectedStore(policy, mesh=make_mesh(...))`` and
``attach(tree, specs=)``): each leaf's redundancy is sharded like the
leaf over the mesh axes its PartitionSpec uses, in global block space
(shard ``s``'s local block ``b`` is global block ``s * n_blocks + b``;
``shard_factor`` gives a leaf's shard count), with no collectives: the
reference's ``shard_map`` semantics.  Every shard lives on the mesh's one
device, and each kernel takes every shard of a leaf in one launch.

Two background duties ride on the tick, each off unless the policy asks:
the scrub patroller (``patrol_bytes_per_tick > 0``, :mod:`repro_torch.scrub`)
and the freshness-SLO health governor (``health``,
:mod:`repro_torch.health`).
"""
from __future__ import annotations

import collections
import dataclasses
import fnmatch
import os
import statistics
import time
import weakref
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..common import flatten_dict, resolve_device
from ..common.device import to_device
from . import bits, blocks, checksum
from . import policy as policy_mod
from . import workqueue
from .blocks import (DEFAULT_LANES_PER_BLOCK, DEFAULT_STRIPE_DATA_BLOCKS,
                     BlockMeta, ShapeDtype, make_meta)
from .engine import ALL, RedundancyConfig, RedundancyEngine, local_shape
from .state import LeafRedundancy, RedundancyState

MODES = ("none", "sync", "vilamb")


def _async_tick_default() -> bool:
    """Default of ``RedundancyPolicy.async_tick``: the overlap pipeline,
    unless ``REPRO_ASYNC_TICK=0`` (the reference's lever for running a
    suite on the blocking tick without touching call sites that pass the
    knob explicitly)."""
    return os.environ.get("REPRO_ASYNC_TICK", "1").lower() not in (
        "0", "false", "no")


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
    # Overlap pipeline: a due tick costs the foreground one dispatch on the
    # side stream, with one update in flight per group (later due ticks
    # coalesce into it).  ``async_tick=False`` selects the blocking tick.
    async_tick: bool = dataclasses.field(default_factory=_async_tick_default)
    # Run every update variant once at attach (``warmup``), so that the
    # first due tick pays no kernel build or first-launch cost.
    precompile: bool = True
    # Scrub patroller (repro_torch.scrub): ``patrol_bytes_per_tick`` > 0
    # enables a continuous low-priority verify cursor over block space; each
    # probe checksums at most that many bytes per tick.  Detected corruption
    # is repaired from parity at ``patrol_repair_per_tick`` blocks a tick.
    # Probes run on quiet ticks, and after ``patrol_max_starved_ticks``
    # consecutive probe-less ticks on a busy one too (0 disables the floor;
    # ``TickReport.patrol_starved_ticks`` shows the streak).  A sharded
    # store's patroller also keeps cross-shard parity of each dim0-sharded
    # leaf and rebuilds a lost shard from it, paced at
    # ``rebuild_bytes_per_tick`` (0 = 4x the patrol budget); a probe window
    # whose mismatches on one shard reach ``shard_loss_threshold`` of its
    # clean blocks (and at least ``shard_loss_min_blocks``) declares that
    # shard lost.  Priority: foreground writes > due redundancy ticks >
    # rebuild > patrol.
    patrol_bytes_per_tick: int = 0
    patrol_repair_per_tick: int = 1
    patrol_max_starved_ticks: int = 32
    rebuild_bytes_per_tick: int = 0
    shard_loss_threshold: float = 0.5
    shard_loss_min_blocks: int = 4
    # Elastic remesh (repro_torch.remesh): ``store.remesh(new_mesh)``
    # re-stripes every protected leaf onto a grown or shrunk mesh over
    # bounded per-tick migration windows of ``remesh_bytes_per_tick`` bytes
    # a shard a leaf (0 = 4x the patrol budget; if that is also 0 the whole
    # leaf migrates in one window).  Priority: foreground > due ticks >
    # rebuild > remesh > patrol.
    remesh_bytes_per_tick: int = 0
    # Degraded reads (``store.read_verified``): bounded retries when a block
    # can be neither verified nor reconstructed (a transiently vulnerable
    # stripe may settle meanwhile), with the delays of
    # repro_torch.health.backoff.backoff_schedule: exponential from
    # ``read_retry_backoff_s``, capped per delay (0 = uncapped), within a
    # total budget (0 = unbudgeted), jitter only ever shrinking a delay.
    read_retry_attempts: int = 3
    read_retry_backoff_s: float = 0.0
    read_retry_backoff_cap_s: float = 0.0
    read_retry_total_s: float = 0.0
    read_retry_jitter_frac: float = 0.0
    # Freshness-SLO health governor (repro_torch.health): a HealthPolicy (or
    # True for defaults) arms per-group breakers and the escalation ladder
    # (wedged-dispatch retry, margin-forced blocking resolve, on_write
    # backpressure, temporary sync escalation) that enforces
    # max_vulnerable_steps/_seconds.  None (the default) keeps it off.
    health: Optional[Any] = None

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
    # Overlap pipeline: due ticks folded into a still-in-flight update, and
    # groups whose speculative queued dispatch overflowed (the full
    # recompute ran on resolution).
    coalesced: Tuple[str, ...] = ()
    overflowed: Tuple[str, ...] = ()
    # Scrub patroller: leaves probed this tick, mismatches its landed probe
    # found, and the streak of probe-less ticks.  ``repaired`` maps leaf
    # name -> the leaf after the patroller's parity repairs, which the
    # caller adopts (in place, so usually the caller's own tensor; a new
    # one where the leaf's lane view is a padded copy).  ``unrecoverable``
    # carries repro_torch.core.repairs.UnrecoverableBlock records.
    patrolled: Tuple[str, ...] = ()
    patrol_mismatches: int = 0
    patrol_starved_ticks: int = 0
    repaired: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    unrecoverable: Tuple[Any, ...] = ()
    # The active shard rebuild's repro_torch.scrub.RebuildStatus and the
    # active remesh migration's repro_torch.remesh.RemeshStatus (None = none
    # running; on the adoption tick the final status, ``done`` True).
    rebuild: Optional[Any] = None
    remesh: Optional[Any] = None
    # Health governor (repro_torch.health.HealthReport; None when off).
    health: Optional[Any] = None


def _ready(x) -> bool:
    """Non-blocking readiness probe: a CUDA event's ``query()``; None (the
    CPU, where a dispatch runs to completion) is ready."""
    query = getattr(x, "query", None)
    return True if query is None else bool(query())


@dataclasses.dataclass
class _Pending:
    """One in-flight overlapped Algorithm-1 update (per group).

    ``red`` holds the update's outputs (on the card the checksums and
    parity are the live view's own tensors, refreshed in place on the side
    stream); ``done`` is the completion event recorded on the side stream
    after the batch (None on the CPU).  ``fits`` is this group's fit bit,
    folded to a host bool at dispatch (on the card a host True: the fused
    kernel serves every dispatch and nothing overflows).  A failed
    dispatch lands in ``error`` and re-raises at resolution.
    """
    red: Optional[Dict[str, LeafRedundancy]]
    fits: Optional[bool]
    queued: bool
    step: int
    coalesced: int = 0
    error: Optional[BaseException] = None
    done: Any = None
    # Health-governor bookkeeping: the dispatch's wall clock (wedged-update
    # detection) and the group's freshness clocks as they stood before this
    # dispatch (abandoning the update rolls back to them).
    dispatched_at: float = dataclasses.field(default_factory=time.monotonic)
    prev_step: int = 0
    prev_time: float = 0.0


@dataclasses.dataclass
class _Group:
    label: str
    policy: LeafPolicy
    names: Tuple[str, ...]
    engine: Optional[RedundancyEngine]     # None for mode == "none"
    last_update_step: int = 0
    last_update_time: float = dataclasses.field(default_factory=time.monotonic)
    # Overlap pipeline: at most one in-flight update, and the speculation
    # signal (did the last consumed snapshot fit the CPU work queues?).
    # Pessimistic start: the full update is always correct; the first
    # resolved fit signal or a flush's exact check flips it.
    pending: Optional[_Pending] = None
    predicted_fits: bool = False
    # The completion event of the last update the health governor abandoned
    # (the card only): it keeps rewriting the live checksums and parity in
    # place, so readers wait for it until a later dispatch's event, recorded
    # behind it on the side stream, takes its place.
    abandoned: Any = None


# ---------------------------------------------------------------------- store
class ProtectedStore:
    """Facade owning the redundancy lifecycle of one tree of tensors."""

    def __init__(self, policy: Optional[RedundancyPolicy] = None,
                 device: Union[str, torch.device, None] = None,
                 mesh: Any = None):
        self.policy = policy or RedundancyPolicy()
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device, "ProtectedStore")
        if mesh is not None and torch.device(mesh.device) != self.device:
            raise ValueError(f"the mesh lies on {mesh.device}, the store on "
                             f"{self.device}")
        self.mesh = mesh
        self.groups: Dict[str, _Group] = {}
        self.corruption_alarms = 0
        self._none_metas: Dict[str, BlockMeta] = {}
        self._governor = StragglerGovernor(
            factor=self.policy.straggler_factor,
            window=self.policy.straggler_window,
            recovery_steps=self.policy.straggler_recovery_steps)
        self._copy_rate: Optional[float] = None
        # Overlap pipeline: the side stream the updates run on (the card
        # only; made by warmup or the first dispatch).
        self._side: Optional[torch.cuda.Stream] = None
        # Lifecycle phase hooks: host-level observation points (crash
        # replay, tests).  Empty = one truthiness check on the hot paths.
        self._phase_hooks: List[Callable[[str, Dict[str, Any]], None]] = []
        # Background duties, built by attach when the policy asks.
        self.patroller = None
        self._health = None
        # Elastic remesh (repro_torch.remesh): a queued geometry change,
        # the active migration, and the mesh-geometry epoch, bumped at every
        # adoption (cross-shard parity images carry the epoch they were
        # folded under).
        self._remesh_request: Optional[Tuple[Any, Dict[str, Any]]] = None
        self._remesh = None
        self.geometry_version = 0
        # The declared leaves (global shapes) and their specs: a remesh
        # builds its new engines from them.
        self._structs: Dict[str, ShapeDtype] = {}
        self._specs: Dict[str, Any] = {}
        # Leaves pasted by a settle/flush-time rebuild drain: callers adopt
        # them via ``take_repaired``.  The paste is in place, so these are
        # the caller's own tensors: held weakly, they pin no memory the
        # caller has let go of.
        self._drained: Dict[str, "weakref.ref[torch.Tensor]"] = {}

    # -------------------------------------------------------------- phase hooks
    def add_phase_hook(self, fn: Callable[[str, Dict[str, Any]], None]) -> None:
        """Register ``fn(phase, info)`` to fire at lifecycle phases.

        Phases: ``on_write``; ``dispatcher_enqueue`` (the tick is about to
        dispatch the batched update of every due group); ``dispatch``
        (per group, right after the batch was launched and the epoch-swapped
        live view adopted); ``coalesce`` (a due tick folded into the
        in-flight update); ``dispatcher_join`` (about to wait for a
        pending update; the reference's names, kept for its crash-replay
        hooks); ``adopt`` / ``adopt_forced`` (lazy vs
        deadline- or scrub-forced resolution); ``blocking_update``;
        ``scrub``; ``tick``; ``flush``; ``settle``.  ``info['red']`` is the
        live redundancy view at that instant.  Exceptions raised by a hook
        propagate.  Hooks fire at host level only, never inside a step that
        ``torch.compile`` traces.
        """
        self._phase_hooks.append(fn)

    def remove_phase_hook(self, fn) -> None:
        self._phase_hooks.remove(fn)

    def _phase(self, name: str, **info) -> None:
        if torch.compiler.is_compiling():
            return
        for fn in list(self._phase_hooks):
            fn(name, info)

    # ------------------------------------------------------------ construction
    def attach(self, tree: Any, specs: Optional[Mapping[str, Any]] = None
               ) -> "ProtectedStore":
        """Declare the protected tree (tensors on the store's device, or
        :class:`~repro_torch.core.blocks.ShapeDtype` structs).

        Nested dicts are flattened to ``a/b/c`` paths — the namespace the
        policy rules match against.  ``specs`` maps those paths to
        PartitionSpecs (:mod:`repro_torch.dist`) for sharded redundancy on
        the store's mesh.  Returns ``self`` for chaining.
        """
        flat = flatten_dict(tree)
        specs = dict(specs or {})
        if specs and self.mesh is None:
            raise ValueError("specs= needs a store built with mesh=")
        for name, leaf in flat.items():
            dev = getattr(leaf, "device", self.device)
            if torch.device(dev) != self.device:
                raise ValueError(f"leaf {name!r} lies on {dev}, the store on "
                                 f"{self.device}")
        self._structs = {n: ShapeDtype(tuple(v.shape), v.dtype) for n, v in flat.items()}
        self._specs = specs
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
                        ShapeDtype(local_shape(flat[n].shape, specs.get(n), self.mesh),
                                   flat[n].dtype),
                        lanes_per_block=self.policy.lanes_per_block,
                        stripe_data_blocks=self.policy.stripe_data_blocks)
            else:
                cfg = RedundancyConfig(
                    mode=lp.mode, lanes_per_block=self.policy.lanes_per_block,
                    stripe_data_blocks=self.policy.stripe_data_blocks,
                    work_queue_frac=(
                        lp.work_queue_frac if lp.work_queue_frac is not None
                        else self.policy.work_queue_frac))
                engine = RedundancyEngine(
                    {n: flat[n] for n in names}, cfg, device=self.device,
                    mesh=self.mesh, specs={n: specs[n] for n in names if n in specs})
            self.groups[label] = _Group(label, lp, tuple(names), engine)
        if self.policy.precompile:
            self.warmup()
        self.patroller = None
        if self.policy.patrol_bytes_per_tick > 0 and self.has_periodic:
            # Runtime imports: both packages build on repro_torch.core.
            from ..scrub import ScrubPatroller
            self.patroller = ScrubPatroller(self)
        self._health = None
        if self.policy.health:
            from ..health import HealthGovernor, HealthPolicy
            hp = self.policy.health
            self._health = HealthGovernor(
                self, hp if isinstance(hp, HealthPolicy) else None)
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

    def shard_factor(self, name: str) -> int:
        """Shards a leaf's redundancy arrays concatenate (1 = machine-local).

        Global block space for sharded leaves: shard ``s``'s local block
        ``b`` is global block ``s * meta.n_blocks + b``, the indexing that
        scrub masks, ``vulnerable_masks``, fault injection and
        ``recover_block`` share.
        """
        eng = self.engine_for(name)
        return 1 if eng is None else eng.shard_factor(name)

    def red_structs(self, global_: bool = True) -> RedundancyState:
        """The redundancy state's shapes (``ShapeDtype`` per field)."""
        out: RedundancyState = {}
        for g in self._protected():
            out.update(g.engine.red_structs(global_))
        return out

    def red_specs(self) -> Dict[str, LeafRedundancy]:
        """The redundancy arrays' PartitionSpecs (the reference's
        ``red_shardings``' specs)."""
        return {n: g.engine.red_spec(n) for g in self._protected() for n in g.names}

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
        through.  Leaves absent from ``events`` are left unmarked.  With the
        health governor on, a write while some group's breaker is CRITICAL
        is throttled or rejected (``BackpressureError``) before anything is
        recorded.
        """
        if self._health is not None:
            # Rung-3 admission control (a no-op while torch.compile traces).
            self._health.admit(red)
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
        if self._phase_hooks:
            self._phase("on_write", red=dict(out))
        return out

    # ------------------------------------------------------ dispatch machinery
    def _async_group(self, g: _Group) -> bool:
        """Does this group take the overlap-pipelined tick?"""
        return (g.engine is not None and g.policy.mode == "vilamb"
                and self.policy.async_tick)

    def _side_stream(self) -> Optional[torch.cuda.Stream]:
        """The store's side stream (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def warmup(self) -> "ProtectedStore":
        """Run every Algorithm-1 variant a vilamb group can dispatch once.

        Runs at ``attach`` (``RedundancyPolicy.precompile``) so that the
        first due tick pays no first-use cost: on the card that is the
        kernel library's build and load, the side stream's creation and
        the first launch of every kernel and torch op of the tick (the
        epoch swap, the update on the side stream, the blocking update of
        ``flush`` and the scrub).  Each group's variants run through an
        engine of the group's configuration over a small zero-dirty leaf,
        since the protected leaves may be declared without data.  Returns
        ``self`` for chaining.
        """
        for g in self._protected():
            if g.policy.mode != "vilamb":
                continue
            cfg = g.engine.config
            n_blocks = 8 * cfg.stripe_data_blocks
            probe = RedundancyEngine(
                {"probe": ShapeDtype((n_blocks, cfg.lanes_per_block), torch.float32)},
                cfg, device=self.device)
            leaf = {"probe": torch.zeros((n_blocks, cfg.lanes_per_block),
                                         dtype=torch.float32, device=self.device)}
            red = probe.init(leaf)
            variants = (False, True) if g.engine.has_queue else (False,)
            if self._async_group(g):
                for queued in variants:
                    self._swap(red)                 # the epoch swap's ops
                    _, _, done = self._update_many([(probe, queued)], (leaf,), (red,))
                    if done is not None:
                        torch.cuda.current_stream(self.device).wait_event(done)
            for queued in variants:
                red = (probe.redundancy_step_queued if queued
                       else probe.redundancy_step)(leaf, red)
            probe.scrub(leaf, red)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _dispatch_blocking(self, g: _Group, sub, red_sub) -> RedundancyState:
        """Blocking dispatch (flush, the blocking tick): the queued update
        when the live dirty stripes fit the CPU work queues (an exact
        host-side check), the full update otherwise; on the card the fused
        kernel serves both.  Bitwise identical either way.  The exact fit
        answer seeds the speculation of later overlapped dispatches.  On the
        card the pass rewrites the checksums and parity in place on the
        current stream, so it first waits (on the device) for any update of
        the group still running on the side stream, an abandoned one
        included."""
        self._await_update(g)
        queued = g.engine.has_queue and g.engine.queue_fits(red_sub)
        g.predicted_fits = queued or not g.engine.has_queue
        if queued:
            return g.engine.redundancy_step_queued(sub, red_sub)
        return g.engine.redundancy_step(sub, red_sub)

    @staticmethod
    def _swap(red_sub: RedundancyState):
        """The epoch swap of one group's live view, on the current stream:
        per leaf the epoch-A snapshot ``dirty | shadow`` (the live
        ``shadow`` while the update runs) and a fresh zero epoch-B bitmap
        (the live ``dirty`` the foreground marks into meanwhile)."""
        return ({n: r.dirty | r.shadow for n, r in red_sub.items()},
                {n: torch.zeros_like(r.dirty) for n, r in red_sub.items()})

    def _update_many(self, jobs, subs, red_subs):
        """Every due group's overlapped update, as one batch.

        ``jobs`` pairs each group's engine with its queued-vs-full choice.
        On the card the batch runs on the side stream after everything the
        current stream has queued (the epoch swap, every earlier write),
        and a completion event is recorded behind it.  Tensors that cross
        streams are recorded with the stream that uses them, so the caching
        allocator never hands their memory out while that stream may still
        touch it: the leaves and the input redundancy, read or written on
        the side stream, and the outputs, read on the current stream after
        adoption.  Tensors the batch makes and uses only on the side stream
        (the lane copies, K3's ticket and scratch) need no record: their
        memory is reused only by later work of that same stream.  Returns ``(outs,
        fits, done)``: per group the update's outputs, the stacked host fit
        vector, and the completion event (None on the CPU).
        """
        side = self._side_stream()
        done = None
        if side is not None:
            main = torch.cuda.current_stream(self.device)
            side.wait_stream(main)
        with torch.cuda.stream(side):             # no-op on the CPU
            res = [eng.redundancy_step_async(sub, rs, queued=q)
                   for (eng, q), sub, rs in zip(jobs, subs, red_subs)]
            if side is not None:
                # A blocking-sync event: a host waiting on it (sync_inflight)
                # sleeps instead of spinning a core.
                done = torch.cuda.Event(blocking=True)
                done.record(side)
        if side is not None:
            for sub, rs, (out, _) in zip(subs, red_subs, res):
                for leaf in sub.values():
                    leaf.record_stream(side)
                for r in rs.values():
                    for t in (r.checksums, r.parity, r.dirty, r.shadow):
                        t.record_stream(side)
                for r in out.values():
                    for t in (r.meta_ck, r.dirty, r.shadow):
                        t.record_stream(main)
        # One column a device (one machine-local): a group with no queue has
        # the host value True, which holds for every device.
        n_dev = self.mesh.size if self.mesh is not None else 1
        fits = [torch.as_tensor(f).reshape(-1).expand(n_dev) for _, f in res]
        return tuple(out for out, _ in res), torch.stack(fits), done

    def sync_inflight(self) -> "ProtectedStore":
        """Wait on the host until every in-flight update has finished on
        the device (a determinism hook for tests and replays that want
        "adopt, never coalesce" schedules)."""
        for g in self._protected():
            ev = self._inflight_event(g)
            if ev is not None:
                ev.synchronize()
        return self

    def _dispatch_async_many(self, items: List[Tuple[_Group, bool, int, float]],
                             get_leaves, out: RedundancyState,
                             step: int) -> RedundancyState:
        """Overlapped batched dispatch; returns the groups' live view.

        Every due group's update runs in one batch on the side stream
        (``_update_many``), dispatched here on the tick thread: torch's
        inference mode, under which serving ticks, is thread-local.  The
        fit bits are folded to host bools at once (on the card they are
        host values already), and a later tick probes the completion event
        when it resolves.  The live view carries a fresh epoch-B dirty
        bitmap and ``shadow`` = snapshot A, so scrub, recovery and
        accounting treat the in-flight blocks as vulnerable until adoption.  Its checksums, parity and meta-checksum are the
        previous epoch's where the update wrote new tensors (the CPU) and
        the pending's own where it refreshed the old ones in place (the
        card).  A dispatch that raises (a failed build or launch) is kept
        in the pendings and re-raises at resolution; the tick never turns
        into a blocking one on its own.  Each item carries the group's
        freshness clocks as they stood before the tick bumped them: the
        health governor's abandon rolls back to these.
        """
        lv = get_leaves()
        subs = tuple({n: lv[n] for n in g.names} for g, *_ in items)
        red_subs = tuple({n: out[n] for n in g.names} for g, *_ in items)
        swaps = [self._swap(rs) for rs in red_subs]
        outs, fits, done, error = None, None, None, None
        try:
            outs, fits, done = self._update_many(
                [(g.engine, q) for g, q, *_ in items], subs, red_subs)
        except Exception as e:      # re-raised by _resolve
            error = e
        host = None if error is not None else np.asarray(fits)
        for i, (g, queued, prev_step, prev_time) in enumerate(items):
            g.pending = _Pending(
                red=None if outs is None else outs[i],
                # The AND-fold over a sharded group's per-device flags runs
                # here, on the host, never in a device program.
                fits=None if host is None else workqueue.fold_fits_host(host[i]),
                queued=queued, step=step, error=error, done=done,
                prev_step=prev_step, prev_time=prev_time)
            if done is not None:
                g.abandoned = None      # ``done`` is recorded behind it
        view: RedundancyState = {}
        for i, ((g, *_), (snaps, fresh), rs) in enumerate(zip(items, swaps, red_subs)):
            for n in g.names:
                base = rs[n]
                if outs is not None and outs[i][n].checksums is base.checksums:
                    base = outs[i][n]       # refreshed in place: no old epoch
                view[n] = dataclasses.replace(base, dirty=fresh[n], shadow=snaps[n])
        return view

    def _resolve(self, g: _Group, red_sub: RedundancyState, *, wait: bool):
        """Adopt a group's in-flight update into the live view, if resolvable.

        Returns ``(red_sub', overflowed, deferred)``, or ``(None, False, 0)``
        while the update is in flight and ``wait`` is False.  ``wait``
        adopts whether or not the update has finished (forced by a
        deadline, a scrub, ``settle`` or ``flush``).  A dispatch that raised
        re-raises here.  On the card the current stream waits for the
        update's completion event (on the device: the host does not block
        on it).  The adopted arrays are
        the update's outputs with the live epoch-B dirty bitmap carried
        over; the update's ``shadow = overflowed ? snapshot : 0`` keeps a
        mispredicted queued dispatch's blocks marked, and ``overflowed``
        tells the caller to run the full recompute.  ``deferred`` counts
        due ticks coalesced while the update was outstanding.
        """
        p = g.pending
        if p is None:
            return red_sub, False, 0
        if not wait and not _ready(p.done):
            return None, False, 0
        if p.error is not None:
            g.pending = None
            raise p.error
        self._await_update(g)
        fits = p.fits                  # folded at dispatch
        g.predicted_fits = fits
        adopted = {n: dataclasses.replace(p.red[n], dirty=red_sub[n].dirty)
                   for n in g.names}
        g.pending = None
        return adopted, (p.queued and not fits), p.coalesced

    @staticmethod
    def _inflight_event(g: _Group):
        """The completion event of ``g``'s update still in flight on the
        side stream, or of the last one the health governor abandoned
        (None on the CPU, or when nothing is in flight)."""
        p = g.pending
        if p is not None and p.error is None and p.done is not None:
            return p.done
        return g.abandoned

    def _await_update(self, g: _Group) -> None:
        """Order the current stream after ``g``'s in-flight update (or the
        abandoned one), on the device, before it reads the group's
        checksums, parity or meta-checksum."""
        ev = self._inflight_event(g)
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)

    def _abandon(self, g: _Group) -> None:
        """Drop ``g``'s in-flight update (the health governor's rung 1).

        The reference drops the update's output arrays.  On the card the
        live view's checksums and parity are the very tensors the update
        rewrites in place on the side stream, so it keeps running: its
        completion event stays on the group (``abandoned``) and orders every
        later reader and blocking pass after it.  The live ``shadow`` still
        marks the update's snapshot, so the next update covers those blocks.
        """
        p, g.pending = g.pending, None
        if p is not None and p.error is None and p.done is not None:
            g.abandoned = p.done

    def settle(self, red: RedundancyState,
               leaves: Optional[Mapping[str, torch.Tensor]] = None,
               step: Optional[int] = None) -> RedundancyState:
        """Adopt every in-flight update into ``red``.

        No new periodic pass is scheduled (that is ``flush``).  With
        ``leaves``, an active shard rebuild is drained first (its remaining
        paste windows complete, so a checkpoint taken now never sees a
        half-pasted shard; adopt the pasted leaves via
        :meth:`take_repaired`), and a mispredicted speculative queued
        update is repaired at once with the full recompute; without them
        its blocks stay marked (shadow) for the next pass.  Ticks coalesced behind the in-flight
        update fold into the next due tick.  ``step`` (``None`` = unknown,
        never step 0) stamps the ``dispatcher_join`` phase.  The returned
        arrays are ordered after the adopted updates on the calling stream.
        """
        out = dict(red)
        if leaves is not None:
            leaves = self._drain_background(dict(leaves), out, step=step)
        for g in self._protected():
            if g.pending is None:
                continue
            if self._phase_hooks:
                info = {} if step is None else {"step": int(step)}
                self._phase("dispatcher_join", red=dict(out), group=g.label, **info)
            red_sub, overflowed, _ = self._resolve(
                g, {n: out[n] for n in g.names}, wait=True)
            out.update(red_sub)
            if overflowed and leaves is not None:
                # The full recompute through the overlapped variant, which
                # writes new tensors on the CPU (the only place a queue, and
                # so an overflow, exists): settle also backs the read-only
                # scrub paths, whose callers keep using their own red.
                repaired, fits = g.engine.redundancy_step_async(
                    {n: leaves[n] for n in g.names}, {n: out[n] for n in g.names})
                g.predicted_fits = workqueue.fold_fits_host(fits)
                out.update(repaired)
        if self._phase_hooks:
            self._phase("settle", red=dict(out))
        return out

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
        returning it.

        On the overlap pipeline (the default) a due tick costs the
        foreground the epoch swap and one batched dispatch on the side
        stream: the returned state carries a fresh dirty bitmap and the
        consumed snapshot in ``shadow``, and the update is adopted lazily
        by a later tick once its completion event fired (or at once when a
        deadline or a scrub forces settled state, and by ``flush``,
        ``settle`` and the scrub calls).  A mispredicted queued dispatch
        (CPU work queues only) keeps its snapshot marked and runs the full
        recompute at resolution (``report.overflowed``).  At most one
        update per group is in flight; due ticks arriving meanwhile
        coalesce (``report.coalesced``).  A scheduled scrub runs after the
        dispatch and reads the checksums while the update refreshes the
        in-flight blocks' entries, which it masks out.

        Then the background duties, when the policy asks for them: the scrub
        patroller (a probe on quiet ticks, paced repairs, and on a sharded
        store cross-shard parity and one window a tick of an active shard
        rebuild; callers adopt ``report.repaired``), and the health
        governor, which watches each vilamb group's freshness and
        escalates (``report.health``): a
        wedged in-flight update is abandoned and re-dispatched, a group
        within its deadline margin stops speculating, a CRITICAL breaker
        backpressures ``on_write``, and a group that exhausted its retries
        runs a blocking update every tick until it recovers.

        Callers must adopt the returned state: it is the only live lineage.
        """
        step = int(step)
        if step_time is not None:
            self._governor.observe(step_time)
        report = TickReport(step=step)
        out = dict(red)
        updated, deadline, coalesced, overflowed = [], [], [], []
        to_dispatch: List[Tuple[_Group, bool, int, float]] = []
        scrub_groups: List[_Group] = []
        now = time.monotonic()
        materialized = None if callable(leaves) else leaves

        def get_leaves():
            nonlocal materialized
            if materialized is None:
                materialized = leaves()
            return materialized

        def sub_of(g):
            lv = get_leaves()
            return {n: lv[n] for n in g.names}

        hg = self._health
        if hg is not None:
            hg.begin_tick(step, now)
        # During a remesh migration the group loop is skipped: the old
        # redundancy stays frozen (the truth a crash restores) while writes
        # keep marking it through on_write, and the migrator recomputes the
        # new geometry's redundancy from the data window by window; an
        # update of the old geometry would race the migration for nothing.
        for g in (() if self._remesh is not None else self._protected()):
            lp = g.policy
            if step < g.last_update_step:
                # The step counter restarted: rebase so deadlines keep meaning.
                g.last_update_step = 0
            sp = scrub_period if scrub_period is not None else lp.scrub_period_steps
            scrub_due = bool(sp and policy_mod.should_scrub(step, sp))
            if lp.mode == "vilamb":
                margin = sync_esc = retry = False
                if hg is not None:
                    # Rung 1: a wedged in-flight update is abandoned (the
                    # freshness clocks roll back to before its dispatch) and
                    # re-dispatched below this tick, after a bounded backoff:
                    # ``due`` is step-aligned, so waiting for the next period
                    # would let the breaker cool down between retries.
                    retry = hg.check_pending(g)
                    sync_esc = hg.is_sync_escalated(g.label)
                    margin = hg.within_margin(g, step, now)
                eff = min(lp.period_steps * self._governor.scale,
                          self.policy.period_cap)
                due = policy_mod.should_update(step, eff)
                overdue = (
                    (lp.max_vulnerable_steps > 0
                     and step - g.last_update_step >= lp.max_vulnerable_steps)
                    or (lp.max_vulnerable_seconds > 0
                        and now - g.last_update_time >= lp.max_vulnerable_seconds))
                if self._async_group(g) and not sync_esc:
                    # Resolve lazily (waiting only when a deadline, a scrub
                    # or, rung 2, the governor's deadline margin forces
                    # settled state), then keep at most one update in flight.
                    had_pending = g.pending is not None
                    forced = overdue or scrub_due or margin
                    if had_pending and forced and self._phase_hooks:
                        self._phase("dispatcher_join", red=dict(out),
                                    group=g.label, step=step)
                    res, ovf, deferred = self._resolve(
                        g, {n: out[n] for n in g.names}, wait=forced)
                    if res is None:
                        # Still in flight: fold this due tick into it.  The
                        # deadline clock keeps running, so a stuck update is
                        # eventually force-resolved via overdue.
                        if due:
                            g.pending.coalesced += 1
                            coalesced.append(g.label)
                            updated.append(g.label)
                            if self._phase_hooks:
                                self._phase("coalesce", red=dict(out),
                                            group=g.label, step=step)
                    else:
                        out.update(res)
                        if had_pending and self._phase_hooks:
                            self._phase("adopt_forced" if forced else "adopt",
                                        red=dict(out), group=g.label, step=step,
                                        overflowed=ovf)
                        if (had_pending and margin and hg is not None
                                and not (overdue or scrub_due)):
                            hg.note_forced_resolve(g.label, step)
                        if ovf:
                            overflowed.append(g.label)
                        if ovf or due or overdue or deferred or margin or retry:
                            # The clocks before the bump below: rung 1's
                            # abandon rolls back to them.
                            to_dispatch.append(
                                (g, bool(not ovf and g.engine.has_queue
                                         and g.predicted_fits),
                                 g.last_update_step, g.last_update_time))
                            g.last_update_step = step
                            g.last_update_time = now
                            if due or overdue or margin:
                                updated.append(g.label)
                            if overdue and not due:
                                deadline.append(g.label)
                elif sync_esc or due or overdue or margin:
                    if g.pending is not None:
                        # Rung 4 engaged with an update still in flight:
                        # adopt it first, or its later adoption would
                        # clobber the blocking pass's newer checksums.
                        if self._phase_hooks:
                            self._phase("dispatcher_join", red=dict(out),
                                        group=g.label, step=step)
                        red_sub, _, _ = self._resolve(
                            g, {n: out[n] for n in g.names}, wait=True)
                        out.update(red_sub)
                    out.update(self._dispatch_blocking(
                        g, sub_of(g), {n: out[n] for n in g.names}))
                    g.last_update_step = step
                    g.last_update_time = now
                    updated.append(g.label)
                    if self._phase_hooks:
                        self._phase("blocking_update", red=dict(out),
                                    group=g.label, step=step)
                    if overdue and not due:
                        deadline.append(g.label)
            if scrub_due:
                scrub_groups.append(g)
        if to_dispatch:
            if self._phase_hooks:
                self._phase("dispatcher_enqueue", red=dict(out), step=step,
                            groups=tuple(g.label for g, *_ in to_dispatch))
            out.update(self._dispatch_async_many(to_dispatch, get_leaves, out, step))
            if self._phase_hooks:
                for g, *_ in to_dispatch:
                    self._phase("dispatch", red=dict(out), group=g.label,
                                step=step, queued=g.pending.queued)
        for g in scrub_groups:
            mm, alarms = self._scrub_group(g, sub_of(g), out)
            report.scrubbed += (g.label,)
            report.mismatches += mm
            report.alarms += alarms
            if self._phase_hooks:
                self._phase("scrub", red=dict(out), group=g.label, step=step,
                            mismatches=mm)
        report.updated = tuple(updated)
        report.deadline_fired = tuple(deadline)
        report.coalesced = tuple(coalesced)
        report.overflowed = tuple(overflowed)
        # The remesh slot, between rebuild and patrol on the ladder: a
        # queued request starts once no rebuild is active or pending (loss
        # recovery first); while it migrates the patroller, whose parity is
        # the old mesh's, is skipped (a fresh one is built at adoption).
        ran_remesh = False
        if (self._remesh is None and self._remesh_request is not None
                and (self.patroller is None
                     or (self.patroller.rebuild is None
                         and not self.patroller._pending_loss))):
            self._remesh_start(get_leaves(), out, step, report)
        if self._remesh is not None:
            lv = dict(get_leaves())
            lv.update(report.repaired)
            self._remesh_step(lv, out, report, step)
            ran_remesh = True
        if hg is not None and ran_remesh:
            # The group loop was skipped this tick, the one window the
            # ladder above cannot cover.  A group whose freshness margin
            # expired mid-migration drains the remaining windows at once
            # (remesh_drain, rung 2) and then runs a blocking update on the
            # new geometry; with remesh_drain off the migration keeps its
            # bound and end_tick reports the violation.
            forced = hg.remesh_overdue(step, now)
            if forced and self._remesh is not None and hg.hp.remesh_drain:
                lv = dict(get_leaves())
                lv.update(report.repaired)
                while self._remesh is not None:
                    self._remesh_step(lv, out, report, step)
            if forced and self._remesh is None:
                lv = dict(get_leaves())
                lv.update(report.repaired)
                extra = []
                for g in self._protected():
                    if g.policy.mode != "vilamb" or g.label not in forced:
                        continue
                    out.update(self._dispatch_blocking(
                        g, {n: lv[n] for n in g.names},
                        {n: out[n] for n in g.names}))
                    g.last_update_step = step
                    g.last_update_time = now
                    extra.append(g.label)
                    hg.note_remesh_drain(g.label, step)
                report.updated = report.updated + tuple(extra)
                report.deadline_fired = report.deadline_fired + tuple(extra)
                updated.extend(extra)
        if self.patroller is not None and not ran_remesh:
            # Low-priority background duty, after every foreground decision:
            # the patroller sees the post-dispatch live view (in-flight
            # blocks are shadow-marked, so probes skip them) and dispatches
            # a probe only on quiet ticks; a queued remesh counts as busy
            # (it ranks above patrol).  Its repairs land in report.repaired,
            # which callers adopt.
            self.patroller.on_tick(
                get_leaves, out, step, report,
                busy=bool(updated) or self._remesh_request is not None)
        if hg is not None:
            # Age audit and breaker transitions; attaches report.health and
            # raises FreshnessViolationError only when the ladder is
            # exhausted and a deadline is still blown (violation_mode).
            hg.end_tick(report, step, now)
        if self._phase_hooks:
            self._phase("tick", red=dict(out), step=step, report=report)
        return out, report

    def flush(self, leaves: Mapping[str, torch.Tensor], red: RedundancyState,
              step: Optional[int] = None) -> RedundancyState:
        """Battery/preemption flush: force Algorithm 1 on every vilamb group
        now (paper §3.3).  Sync groups are current by construction.  An
        active shard rebuild is drained first (adopt the pasted leaves via
        :meth:`take_repaired`), then an in-flight update is adopted, so the
        result equals the blocking tick's flush bit for bit.  Pass
        ``step`` when known so the steps deadline does not fire a spurious
        pass right after the flush."""
        out = dict(red)
        leaves = self._drain_background(dict(leaves), out, step=step)
        now = time.monotonic()
        info = {} if step is None else {"step": int(step)}
        for g in self._protected():
            if g.policy.mode == "vilamb":
                if g.pending is not None:
                    # An overflowed speculative dispatch left its blocks
                    # marked (shadow), so the forced pass below covers them.
                    if self._phase_hooks:
                        self._phase("dispatcher_join", red=dict(out),
                                    group=g.label, **info)
                    red_sub, _, _ = self._resolve(
                        g, {n: out[n] for n in g.names}, wait=True)
                    out.update(red_sub)
                out.update(self._dispatch_blocking(
                    g, {n: leaves[n] for n in g.names},
                    {n: out[n] for n in g.names}))
                g.last_update_time = now
                if step is not None:
                    g.last_update_step = int(step)
        if self._phase_hooks:
            self._phase("flush", red=dict(out), **info)
        return out

    # ------------------------------------------------------------ elastic remesh
    def remesh(self, new_mesh: Any, specs: Optional[Mapping[str, Any]] = None) -> None:
        """Queue an elastic geometry change: grow or shrink the mesh by
        re-striping every protected leaf incrementally
        (:mod:`repro_torch.remesh`).

        No stop-the-world re-attach: the migration runs over bounded
        per-tick windows (``RedundancyPolicy.remesh_bytes_per_tick``),
        starting on the next ``tick`` once no shard rebuild is active or
        pending, and reports a ``RemeshStatus`` on ``TickReport.remesh``;
        it takes ``ceil(n_blocks / window)`` ticks for the largest leaf.
        ``specs`` overrides leaves' PartitionSpecs on the new mesh (default:
        the specs given at ``attach``, valid whenever the new mesh keeps the
        axis names).

        Raises :class:`~repro_torch.remesh.RemeshInProgressError` when a
        remesh is already queued or migrating, and
        :class:`~repro_torch.remesh.RemeshGeometryError` when a leaf does
        not split evenly onto the new mesh or a group's mode (``sync``) has
        no online migration.
        """
        from ..remesh import RemeshInProgressError, validate_remesh
        if self._remesh is not None or self._remesh_request is not None:
            raise RemeshInProgressError("a remesh is already queued or in progress")
        new_specs = dict(self._specs)
        new_specs.update(specs or {})
        validate_remesh(self, new_mesh, new_specs)
        self._remesh_request = (new_mesh, new_specs)

    @property
    def remeshing(self) -> bool:
        """True while a remesh is queued or migrating."""
        return self._remesh is not None or self._remesh_request is not None

    def _remesh_start(self, leaves: Mapping[str, torch.Tensor], out, step: int,
                      report) -> None:
        """Begin the queued migration: adopt the in-flight overlapped updates
        against the OLD geometry (a mispredicted one repaired at once with
        the full recompute), then build the migrator.  The leaves stay
        where they are (every shard lies on the one device); they come back
        on ``report.repaired`` as the reference's moved arrays do."""
        from ..remesh import RemeshMigrator
        new_mesh, new_specs = self._remesh_request
        self._remesh_request = None
        for g in self._protected():
            if g.pending is None:
                continue
            if self._phase_hooks:
                self._phase("dispatcher_join", red=dict(out), group=g.label, step=step)
            red_sub, ovf, _ = self._resolve(g, {n: out[n] for n in g.names}, wait=True)
            out.update(red_sub)
            if ovf:
                repaired, fits = g.engine.redundancy_step_async(
                    {n: leaves[n] for n in g.names}, {n: out[n] for n in g.names})
                g.predicted_fits = workqueue.fold_fits_host(fits)
                out.update(repaired)
        self._remesh = RemeshMigrator(self, new_mesh, new_specs, leaves, out, step)
        report.repaired.update(self._remesh.moved)
        report.remesh = self._remesh.status

    def _remesh_step(self, leaves, out, report, step: Optional[int]) -> None:
        """One bounded migration window; on the tick the last one lands, the
        adoption (the new redundancy, engines, groups and mesh, a fresh
        patroller, ``geometry_version`` bumped)."""
        m = self._remesh
        m.step_once(leaves, out, report, step)
        if m.status.done:
            m.adopt(out, report)
            self._remesh = None

    def _drain_background(self, leaves: Dict[str, torch.Tensor],
                          out: Dict[str, Any], step: Optional[int] = None
                          ) -> Dict[str, torch.Tensor]:
        """Run an active shard rebuild, then an active remesh migration, to
        completion, synchronously — settle and flush call this before
        adopting, so a checkpoint taken mid-rebuild or mid-migration never
        persists a half-pasted shard or a half-migrated geometry.  Mutates
        ``out`` (dirty marks; the new geometry's redundancy wholesale at a
        remesh adoption) and returns the leaves; the pasted leaves (the
        caller's own tensors, written in place) are also held, weakly, for
        :meth:`take_repaired`.  A remesh still queued behind a rebuild is
        left queued: it starts on the next tick.  ``step`` stays None when
        the caller gave none (the crash phases then fill in their own)."""
        pat = self.patroller
        if pat is not None and pat.rebuild is not None:
            rep = TickReport(step=0 if step is None else int(step))
            pat.drain_rebuild(leaves, out, rep, step)
            leaves.update(rep.repaired)
            self._drained.update(
                {n: weakref.ref(t) for n, t in rep.repaired.items()})
        if self._remesh is not None:
            rep = TickReport(step=0 if step is None else int(step))
            while self._remesh is not None:
                self._remesh_step(leaves, out, rep, step)
            leaves.update(rep.repaired)
            self._drained.update(
                {n: weakref.ref(t) for n, t in rep.repaired.items()})
        return leaves

    def take_repaired(self) -> Dict[str, torch.Tensor]:
        """Leaves pasted or moved by a settle/flush-time drain (rebuild
        paste windows, remesh migration windows) since the last call.
        Callers that settle or flush mid-rebuild or mid-migration adopt
        these (the port pastes in place and moves nothing, so they are the
        caller's own tensors, and a leaf the caller has since let go of is
        left out; the patroller's repairs and a migration's moved leaves
        during ticks come back on ``TickReport.repaired``)."""
        held, self._drained = self._drained, {}
        out = {n: r() for n, r in held.items()}
        return {n: t for n, t in out.items() if t is not None}

    def redundancy_step(self, leaves: Mapping[str, torch.Tensor],
                        red: RedundancyState) -> RedundancyState:
        """Algorithm 1 on every vilamb group, without touching the schedule.
        Bypasses the overlap pipeline: ``settle`` first if an update is in
        flight, or its later adoption would roll checksums back."""
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
            # Double-check (paper §3.4): quiesce in-flight work (the side
            # stream's update too), re-verify before raising the alarm.
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            total = count()
            if total:
                alarms = 1
                self.corruption_alarms += 1
        return total, alarms

    def scrub(self, leaves: Mapping[str, torch.Tensor], red: RedundancyState
              ) -> Dict[str, torch.Tensor]:
        """Per-leaf mismatch masks over clean blocks (no double-check).

        In-flight updates are settled first (with the full fallback after
        a misprediction), so the masks are the blocking tick's.  The
        caller's ``red`` stays a conservative view (in-flight blocks
        marked) until the next tick or flush adopts."""
        red = self.settle(red, leaves)
        out: Dict[str, torch.Tensor] = {}
        for g in self._protected():
            out.update(g.engine.scrub({n: leaves[n] for n in g.names},
                                      {n: red[n] for n in g.names}))
        return out

    def scrub_check(self, leaves: Mapping[str, torch.Tensor],
                    red: RedundancyState) -> int:
        """Scrub all protected groups with the double-check protocol, after
        settling in-flight updates (the blocking tick's count)."""
        red = self.settle(red, leaves)
        return sum(self._scrub_group(g, {n: leaves[n] for n in g.names}, red)[0]
                   for g in self._protected())

    def await_inflight(self) -> "ProtectedStore":
        """Order the current stream after every in-flight update, on the
        device (no host wait, no adoption, so the schedule is unchanged).

        The rule for readers of ``red`` outside the store (a checkpoint, a
        copy to the host): on the card a due tick's update refreshes the
        live view's checksums and parity in place on the side stream, so
        call this on the stream that reads them first.  What is read is
        then the live view after the update: new checksums, parity and
        meta-checksum, with ``shadow`` still marking the in-flight blocks
        (consistent and conservative).  A no-op on the CPU."""
        for g in self._protected():
            self._await_update(g)
        return self

    def verify_meta(self, red: RedundancyState) -> Dict[str, torch.Tensor]:
        """Checksum-of-checksums check per leaf; an in-flight update's
        checksums are read only after it finished (a device-side wait)."""
        out: Dict[str, torch.Tensor] = {}
        for g in self._protected():
            self._await_update(g)
            out.update(g.engine.verify_meta({n: red[n] for n in g.names}))
        return out

    def recover_block(self, leaf: torch.Tensor, r: LeafRedundancy, name: str,
                      block_id: int) -> Tuple[torch.Tensor, bool]:
        """Rebuild one block from parity, in place (see
        :meth:`RedundancyEngine.recover_block`); never from parity an
        in-flight update is still rewriting (a device-side wait)."""
        for g in self._protected():
            if name in g.names:
                self._await_update(g)
                return g.engine.recover_block(leaf, r, name, block_id)
        raise KeyError(f"{name} is not parity-protected")

    def read_verified(self, leaves: Mapping[str, torch.Tensor], red: RedundancyState,
                      name: str, block_ids) -> Dict[int, np.ndarray]:
        """Degraded-mode verified read: per requested **global** block, data
        that is provably current (never stale or in-flight garbage), even
        while a shard is lost or a remesh migrates.

        Per block, in order: (1) a block inside the vulnerability window
        (``dirty | shadow``) returns the current data, since writes land in
        the leaf before its redundancy (unless its write was in flight when
        its shard was lost to an active rebuild: a named pre-loss
        casualty); (2) a clean block whose checksum verifies returns the
        current data; (3) otherwise the block is reconstructed, from the
        active rebuild's image when its shard is the lost one, else from
        its XOR stripe (the ``recover_block`` rule: every other member
        clean), and the reconstruction is admitted only if it verifies
        against the stored checksum.  Blocks left unverified retry after
        the ``read_retry_*`` backoff; when the budget is spent
        :class:`~repro_torch.core.repairs.UnrecoverableReadError` is raised
        with ``read_timeout`` records at each block's global stripe.

        Returns ``{global_block_id: uint32 lane row (lanes_per_block,)}``.
        Each attempt gathers on the device and fetches, in turn: the
        ``dirty | shadow`` bits of the requested blocks' stripes
        (:meth:`_read_live`); the requested blocks' lane rows, with the
        stored and fresh checksums of those outside the window, one
        checksum launch each at its own block offset (:meth:`_read_rows`);
        and the reconstructions with their checksums
        (:meth:`_read_candidates`).  The leaf and its bitvectors are never
        copied whole and never written (a reconstruction is computed
        beside the leaf).  Any shard split works, a strided one too (the
        reference reads dim-0 row ranges only).  In-flight updates are
        waited for on the device first: they rewrite checksums and parity
        in place.
        """
        from ..health.backoff import backoff_schedule
        from .repairs import UnrecoverableBlock, UnrecoverableReadError
        group = next((g for g in self._protected() if name in g.names), None)
        if group is None:
            raise KeyError(f"{name} is not parity-protected")
        eng = group.engine
        meta = eng.metas[name]
        k, nb = eng.shard_factor(name), meta.n_blocks
        P = meta.stripe_data_blocks
        splits = eng.splits(name)
        want = [int(b) for b in block_ids]
        for b in want:
            if not 0 <= b < k * nb:
                raise IndexError(f"{name}: global block {b} out of range "
                                 f"(0..{k * nb - 1})")
        pol = self.policy
        attempts = max(1, int(pol.read_retry_attempts))
        delays = backoff_schedule(
            attempts - 1, float(pol.read_retry_backoff_s),
            cap=float(pol.read_retry_backoff_cap_s),
            total=float(pol.read_retry_total_s),
            jitter_frac=float(pol.read_retry_jitter_frac))
        results: Dict[int, np.ndarray] = {}
        for attempt in range(attempts):
            pending = [b for b in want if b not in results]
            if not pending:
                break
            if attempt and delays[attempt - 1] > 0:
                time.sleep(delays[attempt - 1])
            leaf, r = leaves[name], red[name]
            self._await_update(group)
            reb = self.patroller.rebuild if self.patroller is not None else None
            if reb is not None and reb.name != name:
                reb = None
            sl = [divmod(b, nb) for b in pending]
            live, others_live = self._read_live(r, meta, sl)
            check = [i for i in range(len(sl)) if not live[i]]
            rows_h, fresh, stored = self._read_rows(leaf, r, meta, splits, pending, sl, check)
            stored_of = dict(zip((pending[i] for i in check), stored.tolist()))
            mismatch = []
            for i, (b, (s, lb)) in enumerate(zip(pending, sl)):
                on_lost = reb is not None and reb.shard == s
                if live[i]:
                    # The leaf holds the newest write, unless that write was
                    # in flight when the shard was lost (its data died).
                    if not (on_lost and bool(reb.preloss[lb])):
                        results[b] = rows_h[i].copy()
                    continue
                mismatch.append((b, s, lb, on_lost, others_live[i]))
            for j, i in enumerate(check):
                if fresh[j] == stored[j]:
                    results[pending[i]] = rows_h[i].copy()
            mismatch = [m for m in mismatch if m[0] not in results]
            # Reconstruct, and admit only what verifies: the rebuild's image
            # first (a block of the lost shard its parity row vouches for),
            # then the XOR stripe.
            recon = [(b, s, lb) for b, s, lb, on_lost, _ in mismatch
                     if on_lost and bool(reb.eligible[lb]) and not bool(reb.written[lb])]
            if recon:
                cand = reb.recon[torch.as_tensor([lb for _, _, lb in recon],
                                                 device=leaf.device)]
                cand_h, ck_h = self._read_candidates(cand, [lb for _, _, lb in recon])
                for i, (b, _, _) in enumerate(recon):
                    if ck_h[i] == stored_of[b]:
                        results[b] = cand_h[i].copy()
            stripe = [(b, s, lb) for b, s, lb, _, busy in mismatch
                      if b not in results and not busy]
            if stripe:
                cands = []
                for b, s, lb in stripe:
                    sid = lb // P
                    n = min(P, nb - sid * P)
                    win = blocks.shard_window_lanes(leaf, meta, splits, sid * P, n)[s]
                    acc = r.parity[s * meta.n_stripes + sid].clone()
                    for j in range(n):
                        if sid * P + j != lb:
                            acc ^= win[j]
                    cands.append(acc)
                cand_h, ck_h = self._read_candidates(torch.stack(cands),
                                                     [lb for _, _, lb in stripe])
                for i, (b, _, _) in enumerate(stripe):
                    if ck_h[i] == stored_of[b]:
                        results[b] = cand_h[i].copy()
        missing = [b for b in want if b not in results]
        if missing:
            recs = tuple(UnrecoverableBlock(name, blocks.global_stripe_id(meta, b), (b,),
                                            "read_timeout") for b in missing)
            raise UnrecoverableReadError(name, recs)
        return {b: results[b] for b in want}

    @staticmethod
    def _read_live(r: LeafRedundancy, meta: BlockMeta,
                   sl: List[Tuple[int, int]]) -> Tuple[np.ndarray, np.ndarray]:
        """For each ``(shard, local block)`` of ``sl``: is it in the window
        (``dirty | shadow``), and is another member of its stripe?  Only the
        words holding the stripes' bits are read, on the device; one host
        copy of ``len(sl) * stripe_data_blocks`` bits."""
        P, nb = meta.stripe_data_blocks, meta.n_blocks
        s = np.array([x for x, _ in sl], np.int64)
        lb = np.array([y for _, y in sl], np.int64)
        mem = (lb // P * P)[:, None] + np.arange(P)[None]          # (n, P) stripe members
        valid = mem < nb
        m = np.minimum(mem, nb - 1)
        dev = r.dirty.device
        word = to_device(s[:, None] * meta.n_dirty_words + m // bits.WORD_BITS, dev)
        shift = to_device((m % bits.WORD_BITS).astype(np.int32), dev)
        hot = (bits.gather(r.dirty, word, shift)
               | bits.gather(r.shadow, word, shift)).cpu().numpy() & valid
        own = mem == lb[:, None]
        return hot[own], (hot & ~own).any(axis=1)

    @staticmethod
    def _read_rows(leaf: torch.Tensor, r: LeafRedundancy, meta: BlockMeta, splits,
                   pending: List[int], sl: List[Tuple[int, int]],
                   check: List[int]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One host copy of the lane rows of the blocks ``pending`` (global
        ids; ``sl`` their ``(shard, local block)``) and, for the positions
        ``check`` (the blocks outside the window), their fresh checksums
        (one checksum launch a block, at its own block offset) and stored
        ones.  Returns ``(rows, fresh, stored)`` as uint32."""
        if (not blocks.is_strided(splits)
                and meta.n_elems == meta.padded_lanes * meta.elems_per_word):
            # Row-range shards filling their blocks: the whole-shard window
            # is a view of the leaf, global block g its row g; one gather.
            lanes = blocks.shard_window_lanes(leaf, meta, splits, 0, meta.n_blocks)
            rows = lanes.reshape(-1, lanes.shape[-1])[to_device(np.asarray(pending),
                                                                leaf.device)]
        else:
            rows = torch.stack([blocks.shard_window_lanes(leaf, meta, splits, lb, 1)[s, 0]
                                for s, lb in sl])
        parts = [rows.reshape(-1)]
        if check:
            parts += [checksum.block_checksums(rows[i:i + 1], sl[i][1]) for i in check]
            parts.append(r.checksums[torch.as_tensor([pending[i] for i in check],
                                                     device=leaf.device)])
        both = torch.cat(parts).cpu().numpy().view(np.uint32)
        n, c = rows.numel(), len(check)
        return both[:n].reshape(rows.shape), both[n:n + c], both[n + c:]

    @staticmethod
    def _read_candidates(cand: torch.Tensor,
                         lbs: List[int]) -> Tuple[np.ndarray, np.ndarray]:
        """One host copy of reconstructed lane rows and their checksums,
        each at its own local block offset ``lbs[i]``."""
        cks = [checksum.block_checksums(cand[i:i + 1], lb) for i, lb in enumerate(lbs)]
        both = torch.cat([cand.reshape(-1)] + cks).cpu().numpy().view(np.uint32)
        n = cand.numel()
        return both[:n].reshape(cand.shape), both[n:]

    def repair(self, leaves: Mapping[str, torch.Tensor], red: RedundancyState,
               mismatches: Mapping[str, Any],
               details: Optional[List[Any]] = None) -> Tuple[Dict, int, int]:
        """Parity-rebuild every detected-corrupt block, in place; returns
        ``(leaves, n_fixed, n_lost)`` (see
        :func:`~repro_torch.ckpt.failure.repair_corruption`).  Each rebuild
        goes through :meth:`recover_block`, so it never reads parity that
        an in-flight update is still rewriting.  ``details`` (optional
        list) collects one :class:`~repro_torch.core.repairs.UnrecoverableBlock`
        per refused stripe."""
        from ..ckpt.failure import repair_corruption
        return repair_corruption(self, leaves, red, mismatches, details=details)

    def declare_shard_lost(self, name: str, shard: int,
                           red: Optional[RedundancyState] = None) -> None:
        """Tell the patroller a shard of ``name`` is lost (operator signal).

        The patroller normally detects wholesale shard corruption from its
        own probes (``shard_loss_threshold``); this is the explicit path
        for known losses (a device dropped out).  Needs the patroller
        (``patrol_bytes_per_tick > 0``); the rebuild starts on the next
        ``tick``.  Pass the current ``red`` when it is in hand: its
        ``dirty | shadow`` marks snapshot which blocks had writes in flight
        at the declaration (their data died with the shard: reported
        unrecoverable), so foreground writes landing after it still count
        as fresh.  A leaf with no cross-shard parity (machine-local, or
        not dim0-sharded) raises the reference's ``ValueError``; a second
        shard of a leaf still rebuilding raises
        :class:`~repro_torch.scrub.ShardLossConflictError`."""
        if self.patroller is None:
            raise RuntimeError(
                "declare_shard_lost needs the scrub patroller "
                "(set RedundancyPolicy.patrol_bytes_per_tick > 0)")
        if self.remeshing:
            # The patroller and its cross-shard parity are built fresh at a
            # remesh adoption: a loss queued now would vanish with them.
            raise RuntimeError(
                f"{name}: cannot declare a shard lost while a remesh is "
                "queued or migrating; re-declare after TickReport.remesh "
                "reports done")
        self.patroller.declare_shard_lost(name, shard, red)

    def inject(self, leaves: Mapping[str, torch.Tensor], red: RedundancyState,
               spec) -> Tuple[Dict[str, torch.Tensor], RedundancyState]:
        """Apply one ``repro_torch.faults.FaultSpec`` functionally (test and
        battery hook), placed in block-lane space against this store's
        geometry (global block space under a mesh: the owning shard's rows
        are corrupted).  Returns new ``(leaves, red)``; the written leaf or field
        is a copy and the inputs are untouched.  The copies are ordered
        after every in-flight update (``await_inflight``): on the card the
        update refreshes the live view's checksums and parity in place."""
        from ..faults.inject import apply_fault
        self.await_inflight()
        return apply_fault(self.metas, leaves, red, spec,
                           factors={n: self.shard_factor(n) for n in self.metas})

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
