"""The port's overlap-pipelined tick against the reference's, on the CPU.

The same numpy writes drive ``repro.core.ProtectedStore`` and
``repro_torch`` with ``async_tick=True`` on both sides.  After every tick
the whole redundancy state and the ``TickReport`` fields ``updated``,
``coalesced``, ``overflowed`` and ``deadline_fired`` must agree bit for
bit, with the reference's resolver thread on and off, through
coalescing, misprediction, and ``flush``/``scrub_check`` mid-flight.  The
port resolves inline (on the card readiness is a completion event's
``query()``, and on the CPU a dispatch runs to completion), so it starts
no thread.  Before a tick that should adopt (never coalesce), the
reference's resolver jobs are waited for, each wait bounded.  The cases
mirror tests/test_async_tick.py and tests/test_dispatcher.py (the
patroller's case waits for the scrub slice).
"""
import faulthandler
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core.store as jstore_mod
import repro_torch.core.store as tstore_mod
from _torch_helpers import assert_red_equal, jnp_leaves
from repro.core import ALL as JALL
from repro.core import LeafPolicy as JLeafPolicy
from repro.core import ProtectedStore as JStore
from repro.core import RedundancyPolicy as JPolicy
from repro_torch.core import (ALL, LeafPolicy, ProtectedStore, RedundancyEngine,
                              RedundancyPolicy, bits, convert)

WAIT_S = 30.0          # bound of every event wait and thread join below
REPORT_FIELDS = ("updated", "coalesced", "overflowed", "deadline_fired")


@pytest.fixture(autouse=True)
def watchdog():
    """A wait inside a store that never returns ends this worker after two
    minutes instead of holding the whole test run."""
    faulthandler.dump_traceback_later(120, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _np_leaves(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((24, 200)).astype(np.float32),
            "e": rng.standard_normal((16, 64)).astype(np.float32)
            .astype(ml_dtypes.bfloat16)}


def _policies(period=3, frac=0.5, rules=(), dispatcher_thread=True, **kw):
    """The same policy for both packages (``rules``: (pattern, LeafPolicy
    kwargs) pairs).  ``dispatcher_thread`` is the reference's alone.  The
    reference compiles its programs at first use unless ``precompile`` is
    asked for (the same programs, fewer of them)."""
    kw = dict(dict(lanes_per_block=128, work_queue_frac=frac, async_tick=True), **kw)
    lp = dict(mode="vilamb", period_steps=period)
    for k in ("max_vulnerable_steps", "scrub_period_steps"):
        if k in kw:
            lp[k] = kw.pop(k)
    jkw = dict(dict(precompile=False, dispatcher_thread=dispatcher_thread), **kw)
    return (JPolicy(default=JLeafPolicy(**lp),
                    rules=tuple((p, JLeafPolicy(**r)) for p, r in rules), **jkw),
            RedundancyPolicy(default=LeafPolicy(**lp),
                             rules=tuple((p, LeafPolicy(**r)) for p, r in rules), **kw))


def _wait_resolvers(jstore):
    """The reference's resolver jobs, each wait bounded."""
    for g in jstore.groups.values():
        p = g.pending
        if p is not None and p.launched is not None:
            assert p.launched.wait(WAIT_S), f"resolver job of {g.label} never ran"


class Pair:
    """The reference's store and the port's, driven by the same numpy
    writes and compared after every step."""

    def __init__(self, seed=0, **policy_kw):
        jpol, tpol = _policies(**policy_kw)
        self.state = _np_leaves(seed)
        self.js = JStore(jpol).attach(self.jl())
        self.ts = ProtectedStore(tpol, device="cpu").attach(self.tl())
        assert [g.label for g in self.js.groups.values()] == \
            [g.label for g in self.ts.groups.values()]
        self.jred, self.tred = self.js.init(self.jl()), self.ts.init(self.tl())
        self.check("init")

    def jl(self):
        """The reference's leaves: copies, since ``jnp.asarray`` aliases a
        numpy buffer on the CPU and ``write`` updates ``state`` in place
        while a dispatched update may not have read it yet."""
        return jnp_leaves(self.state)

    def tl(self):
        return convert.leaves_from_numpy(self.state, device="cpu")

    def check(self, msg):
        assert_red_equal(self.jred, self.tred, msg)

    def groups(self):
        return list(self.js.groups.values()), list(self.ts.groups.values())

    def write(self, rows, delta=0.5, leaf="w"):
        """Add ``delta`` to ``rows`` of ``leaf`` and mark them dirty (ALL for
        ``rows=None``: every element)."""
        if rows is None:
            self.state[leaf] = (self.state[leaf].astype(np.float32) + 1).astype(
                self.state[leaf].dtype)
            jev, tev = JALL, ALL
        else:
            rows = np.asarray(rows)
            self.state[leaf][rows] += np.asarray(delta, self.state[leaf].dtype)
            ev = np.zeros(self.state[leaf].shape[0], bool)
            ev[rows] = True
            jev, tev = jnp.asarray(ev), torch.from_numpy(ev)
        self.jred = self.js.on_write(self.jred, events={leaf: jev})
        self.tred = self.ts.on_write(self.tred, events={leaf: tev})
        self.check("on_write")

    def sync(self):
        """Both stores: every resolver job ran and every update finished."""
        _wait_resolvers(self.js)
        for s in (self.js, self.ts):
            s.sync_inflight()

    def tick(self, step, sync=True, **kw):
        if sync:
            self.sync()
        self.jred, jrep = self.js.tick(self.jl(), self.jred, step, **kw)
        self.tred, trep = self.ts.tick(self.tl(), self.tred, step, **kw)
        self.check(f"tick {step}")
        for f in REPORT_FIELDS + ("scrubbed", "mismatches", "alarms"):
            assert getattr(jrep, f) == getattr(trep, f), (step, f)
        return trep

    def settle(self, with_leaves=True):
        kw = dict(leaves=(self.jl(), self.tl())) if with_leaves else {}
        self.jred = self.js.settle(self.jred, *(kw["leaves"][:1] if kw else ()))
        self.tred = self.ts.settle(self.tred, *(kw["leaves"][1:] if kw else ()))
        self.check("settle")

    def flush(self, step=None):
        self.jred = self.js.flush(self.jl(), self.jred, step=step)
        self.tred = self.ts.flush(self.tl(), self.tred, step=step)
        self.check("flush")

    def scrub_total(self):
        tm = self.ts.scrub(self.tl(), self.tred)
        jm = self.js.scrub(self.jl(), self.jred)
        for n in jm:
            np.testing.assert_array_equal(np.asarray(jm[n]), tm[n].numpy(), n)
        return sum(int(m.sum()) for m in tm.values())

    def stop(self):
        self.js._stop_dispatcher()


@pytest.fixture()
def mkpair():
    """Pair factory that joins the reference's resolver threads at teardown."""
    pairs = []

    def make(**kw):
        pairs.append(Pair(**kw))
        return pairs[-1]

    yield make
    for p in pairs:
        p.stop()


def _port_blocking(writes, flush_step=None, **policy_kw):
    """The port's store on the blocking tick through ``writes``, (step,
    rows, delta) triples of ``w`` row writes, each ticked unless its step is
    None; flushed at ``flush_step`` when given.  Returns the state."""
    _, tpol = _policies(**dict(policy_kw, async_tick=False))
    state = _np_leaves()
    ts = ProtectedStore(tpol, device="cpu").attach(convert.leaves_from_numpy(state, "cpu"))
    red = ts.init(convert.leaves_from_numpy(state, "cpu"))
    for step, rows, delta in writes:
        ev = np.zeros(24, bool)
        ev[rows] = True
        state["w"][rows] += np.float32(delta)
        red = ts.on_write(red, events={"w": torch.from_numpy(ev)})
        if step is not None:
            red, _ = ts.tick(convert.leaves_from_numpy(state, "cpu"), red, step)
    if flush_step is not None:
        red = ts.flush(convert.leaves_from_numpy(state, "cpu"), red, step=flush_step)
    return red


def test_async_tick_defaults_like_the_reference(monkeypatch):
    for value in ("1", "0", "false"):
        monkeypatch.setenv("REPRO_ASYNC_TICK", value)
        assert RedundancyPolicy().async_tick == JPolicy().async_tick == (value == "1")
    monkeypatch.delenv("REPRO_ASYNC_TICK")
    pol = RedundancyPolicy()
    assert (pol.async_tick, pol.precompile) == (True, True)
    ProtectedStore(pol, device="cpu")            # no longer raises


# ------------------------------------------- tests/test_async_tick.py mirror

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_async_end_state_bitwise_identical_to_blocking(mkpair, seed):
    """Random sparse workloads: equal to the reference after every tick;
    the settled state equals the port's blocking tick."""
    pair = mkpair(seed=0)
    rng = np.random.default_rng(seed)
    writes = []
    for step in range(1, 10):
        rows = rng.choice(24, size=rng.integers(1, 5), replace=False)
        writes.append((step, rows, 0.25 * step))
        pair.write(rows, 0.25 * step)
        pair.tick(step)
    pair.settle()
    assert_red_equal(pair.jred, _port_blocking(writes), "settled vs blocking")
    assert pair.scrub_total() == 0


def test_flush_mid_flight_matches_blocking(mkpair):
    pair = mkpair(period=2)
    pair.write([1, 5], 1.5)
    pair.tick(2)                                  # update in flight
    pair.write([9], 3.0)
    pair.flush(step=3)
    assert all(g.pending is None for g in pair.ts.groups.values())
    blocking = _port_blocking([(2, [1, 5], 1.5), (None, [9], 3.0)], flush_step=3,
                              period=2)
    assert_red_equal(pair.jred, blocking, "flush mid-flight vs blocking flush")


def test_scrub_check_mid_flight_matches_blocking(mkpair):
    """A corrupted clean block is found mid-flight, in-flight blocks stay
    skipped, and the count equals the reference's."""
    pair = mkpair(period=2)
    pair.write([0], 1.0)
    pair.tick(2)                                  # update in flight
    lanes = pair.state["w"].reshape(-1).view(np.uint32)
    lanes[20 * 128 + 3] += np.uint32(99)          # block 20 of w, a clean one
    mm = pair.ts.scrub(pair.tl(), pair.tred)
    assert np.flatnonzero(mm["w"].numpy()).tolist() == [20]
    assert pair.scrub_total() == 1
    assert pair.js.scrub_check(pair.jl(), pair.jred) == \
        pair.ts.scrub_check(pair.tl(), pair.tred) == 1
    pair.check("after scrub_check")               # the callers' red untouched


def test_speculative_misprediction_is_bitwise_safe(mkpair):
    """A queued dispatch launched on a wrong fit prediction overflows and
    settles, through the full fallback, to the blocking bits."""
    pair = mkpair(period=1)
    for gs in pair.groups():
        gs[0].predicted_fits = True               # force the misprediction
    pair.write(None, leaf="w")
    pair.write(None, leaf="e")
    pair.tick(1)                                  # queued, overflows
    p = pair.groups()[1][0].pending
    assert p is not None and p.queued
    rep = pair.tick(2)                            # resolves -> full fallback
    assert rep.overflowed
    assert pair.groups()[1][0].predicted_fits is False
    pair.settle()
    assert pair.scrub_total() == 0


def test_scrub_after_overflow_leaves_callers_red_usable(mkpair):
    """settle's overflow repair, run from the read-only scrub path, leaves
    the caller's red tickable on the same lineage."""
    pair = mkpair(period=1)
    for gs in pair.groups():
        gs[0].predicted_fits = True
    pair.write(None, leaf="w")
    pair.write(None, leaf="e")
    pair.tick(1)                                  # in flight, will overflow
    pair.sync()
    assert pair.js.scrub_check(pair.jl(), pair.jred) == 0
    assert pair.ts.scrub_check(pair.tl(), pair.tred) == 0
    pair.check("after scrub_check")
    pair.write([2], 0.5)
    pair.tick(2)
    pair.settle()
    assert pair.scrub_total() == 0


def test_in_flight_blocks_stay_conservatively_marked(mkpair):
    """Between dispatch and resolution the live view keeps the consumed
    snapshot in shadow and a fresh epoch-B dirty bitmap."""
    pair = mkpair(period=2)
    pair.write([0, 3], 1.0)
    pair.tick(2)
    assert pair.groups()[1][0].pending is not None
    assert int(bits.popcount(pair.tred["w"].dirty)) == 0
    assert int(bits.popcount(pair.tred["w"].shadow)) > 0
    stats = pair.ts.dirty_stats(pair.tred)
    assert int(stats["w"]["dirty_blocks"]) > 0


def test_coalescing_folds_due_ticks_into_inflight_update(mkpair, monkeypatch):
    """Due ticks arriving while an update is outstanding coalesce; the
    deferred update dispatches on resolution."""
    pair = mkpair(period=1)
    pair.write([0], 1.0)
    pair.tick(1)                                  # dispatch
    tg = pair.groups()[1][0]
    first = tg.pending
    assert first is not None
    pair.sync()
    monkeypatch.setattr(jstore_mod, "_ready", lambda x: False)
    monkeypatch.setattr(tstore_mod, "_ready", lambda x: False)
    rep = pair.tick(2, sync=False)                # due, but "in flight"
    assert rep.coalesced and rep.updated
    assert tg.pending is first and first.coalesced == 1
    monkeypatch.undo()
    rep = pair.tick(3)                            # resolves, deferred fires
    assert tg.pending is not None and tg.pending.step == 3
    pair.settle()
    assert pair.scrub_total() == 0


def test_no_queue_fits_round_trip_on_async_hot_path(mkpair, monkeypatch):
    """A due tick never runs the host-side queue_fits check."""
    pair = mkpair(period=1)

    def boom(*a, **k):
        raise AssertionError("queue_fits called on the async hot path")

    for gs in pair.groups():
        for g in gs:
            monkeypatch.setattr(g.engine, "queue_fits", boom)
    for step in range(1, 6):
        pair.write([step % 24], 0.5)
        pair.tick(step)
    monkeypatch.undo()
    pair.settle()
    assert pair.scrub_total() == 0


def test_attach_precompiles_update_variants(monkeypatch):
    """attach runs every variant the reference warms (the overlapped pair
    and the blocking pair for flush); nothing without precompile."""
    ran = []
    for name in ("redundancy_step_async", "redundancy_step", "redundancy_step_queued"):
        orig = getattr(RedundancyEngine, name)

        def spy(self, leaves, red, *a, orig=orig, name=name, **kw):
            ran.append((name, kw.get("queued", a[0] if a else False)))
            return orig(self, leaves, red, *a, **kw)

        monkeypatch.setattr(RedundancyEngine, name, spy)
    variants = {("redundancy_step_async", False): "async_full",
                ("redundancy_step_async", True): "async_queued",
                ("redundancy_step", False): "full",
                ("redundancy_step_queued", False): "queued"}
    for async_on, precompile in ((True, True), (False, True), (True, False)):
        jpol, tpol = _policies(async_tick=async_on, precompile=precompile)
        js = JStore(jpol).attach(jnp_leaves(_np_leaves()))
        ran.clear()
        ProtectedStore(tpol, device="cpu").attach(convert.leaves_from_numpy(_np_leaves(), "cpu"))
        label = next(iter(js.groups))
        want = {v for (l, v) in js._jit_update if l == label}
        assert {variants[r] for r in ran} == want, (async_on, precompile)


def test_blocking_flush_seeds_speculation(mkpair):
    pair = mkpair(period=4)
    assert [gs[0].predicted_fits for gs in pair.groups()] == [False, False]
    pair.write([0], 1.0)                          # sparse: fits
    pair.flush(step=0)
    assert [gs[0].predicted_fits for gs in pair.groups()] == [True, True]


def test_deadline_forces_resolution_and_update(mkpair, monkeypatch):
    """An overdue deadline block-resolves the in-flight update rather than
    coalescing past it."""
    pair = mkpair(period=100, max_vulnerable_steps=2)
    pair.write(None, leaf="w")
    rep = pair.tick(2)                            # overdue -> dispatch
    assert rep.updated and rep.deadline_fired
    pair.sync()
    monkeypatch.setattr(jstore_mod, "_ready", lambda x: False)
    monkeypatch.setattr(tstore_mod, "_ready", lambda x: False)
    pair.write(None, leaf="w")
    rep = pair.tick(4, sync=False)                # overdue again: no coalescing
    assert rep.updated and not rep.coalesced
    assert pair.groups()[1][0].pending.step == 4


# ------------------------------------------- tests/test_dispatcher.py mirror

def _threads():
    return {t for t in threading.enumerate() if t.is_alive()}


def _ref_dispatch_threads():
    return {t for t in _threads() if t.name == "repro-dispatch"}


def test_multigroup_due_tick_is_one_batched_launch(mkpair):
    """Two due vilamb groups -> one batched update per due tick, sharing one
    completion event (the reference: one stacked fits vector and one
    resolver event)."""
    pair = mkpair(period=2, rules=(("e", dict(mode="vilamb", period_steps=2,
                                              work_queue_frac=0.0)),))
    ts = pair.ts
    groups = ts._protected()
    assert len(groups) == 2
    calls = []
    orig = ts._update_many
    ts._update_many = lambda jobs, subs, reds: (calls.append(len(jobs)),
                                                orig(jobs, subs, reds))[1]
    for step in (1, 2, 3, 4):
        pair.write([step], 0.5, leaf="w")
        pair.write([step], 0.5, leaf="e")
        n = len(calls)
        pair.tick(step)
        if step % 2 == 0:
            assert calls[n:] == [2], calls
            p0, p1 = (g.pending for g in groups)
            assert p0.done is p1.done and p0.step == p1.step == step
            assert isinstance(p0.fits, bool) and isinstance(p1.fits, bool)
            j0, j1 = (g.pending for g in pair.js._protected())
            assert j0.fits is j1.fits and j0.launched is j1.launched
        else:
            assert len(calls) == n
    pair.settle()
    assert pair.scrub_total() == 0


@pytest.mark.parametrize("thread_on", [True, False])
def test_dispatcher_modes_bitwise_identical(mkpair, thread_on):
    """The port equals the reference after every tick in each of the
    reference's resolver modes, and settles to the blocking tick's state."""
    pair = mkpair(period=2, dispatcher_thread=thread_on)
    writes = []
    for step in range(1, 8):
        rows = [(step * 3) % 24, (step * 7) % 24]
        writes.append((step, rows, 0.25 * step))
        pair.write(rows, 0.25 * step)
        pair.tick(step)
    pair.settle()
    assert pair.scrub_total() == 0
    assert_red_equal(pair.jred, _port_blocking(writes, period=2), "settled vs blocking")


class _CountingFits:
    """Stand-in for the stacked fit vector that counts host conversions."""

    def __init__(self, arr):
        self._arr = np.asarray(arr)
        self.conversions = 0
        self.shape = self._arr.shape

    def __array__(self, dtype=None, copy=None):
        self.conversions += 1
        return self._arr if dtype is None else self._arr.astype(dtype)


def test_inline_fallback_fetch_happens_at_dispatch_not_resolve(mkpair):
    """The port folds the fit signal at dispatch (as the reference's inline
    mode does); _resolve reads the host bool and never converts the vector
    again."""
    pair = mkpair(period=1, dispatcher_thread=False)
    ts = pair.ts
    proxies = []
    orig = ts._update_many

    def wrapped(jobs, subs, reds):
        outs, fits, done = orig(jobs, subs, reds)
        proxies.append(_CountingFits(fits))
        return outs, proxies[-1], done

    ts._update_many = wrapped
    pair.write([1], 0.5)
    pair.tick(1)                                  # dispatch
    p = pair.groups()[1][0].pending
    assert p is not None and proxies[-1].conversions == 1
    assert isinstance(p.fits, bool)
    pair.write([2], 0.5)
    rep = pair.tick(2)                            # adopts the pending
    assert rep.updated
    assert proxies[0].conversions == 1


def test_threaded_resolve_reads_cached_host_bool(mkpair, monkeypatch):
    """Adoption reads the host bool folded before it (the reference: by its
    resolver thread; the port: at dispatch): the fold is not re-run."""
    pair = mkpair(period=3, dispatcher_thread=True)
    for step in (1, 2, 3):                        # dispatches at step 3
        pair.write([step], 0.5)
        pair.tick(step)
    pair.sync()
    p = pair.groups()[1][0].pending
    assert p is not None and isinstance(p.fits, bool)

    def boom(row):
        raise AssertionError("fold_fits_host re-run at resolution")

    monkeypatch.setattr(jstore_mod.workqueue, "fold_fits_host", boom)
    monkeypatch.setattr(tstore_mod.workqueue, "fold_fits_host", boom)
    pair.tick(4)                                  # not due: adoption only
    assert pair.groups()[1][0].pending is None
    monkeypatch.undo()
    pair.settle()
    assert pair.scrub_total() == 0


def test_resolver_thread_lifecycle_bounded_by_flush(mkpair):
    """The reference's resolver thread starts at the first overlapped
    dispatch and flush joins it; the next dispatch makes a new one.  The
    port, driven beside it, starts no thread at any point."""
    pair = mkpair(period=1, dispatcher_thread=True)
    js = pair.js
    before = _threads() - _ref_dispatch_threads()
    assert js._dispatcher is None
    pair.write([0], 0.5)
    pair.tick(1)
    d = js._dispatcher
    assert d is not None and d.thread.is_alive()
    pair.flush(step=1)
    d.thread.join(WAIT_S)
    assert js._dispatcher is None and not d.thread.is_alive()
    pair.write([2], 0.5)
    pair.tick(2)
    assert js._dispatcher is not None and js._dispatcher is not d
    pair.settle()
    assert _threads() - _ref_dispatch_threads() <= before


@pytest.mark.parametrize("thread_on", [True, False])
def test_inline_mode_never_creates_thread(mkpair, thread_on):
    """The port resolves inline whatever the reference does: a dispatch,
    an adoption, a settle and a flush start no thread."""
    pair = mkpair(period=1, dispatcher_thread=thread_on)
    before = _threads() - _ref_dispatch_threads()
    for step in (1, 2):
        pair.write([step], 0.5)
        pair.tick(step)
        assert pair.groups()[1][0].pending is not None
    pair.settle()
    pair.flush(step=3)
    assert _threads() - _ref_dispatch_threads() <= before


def test_flush_step_zero_is_a_real_step_stamp(mkpair):
    """flush(step=0) stamps the freshness clock at step 0."""
    pair = mkpair(period=100, max_vulnerable_steps=2)
    for gs in pair.groups():
        gs[0].last_update_step = 5                # restored history
    pair.flush(step=0)
    assert [gs[0].last_update_step for gs in pair.groups()] == [0, 0]
    pair.write([0], 0.5)
    rep = pair.tick(1)
    assert not rep.deadline_fired
    rep = pair.tick(2)
    assert rep.deadline_fired


def test_settle_phase_stamps_step_zero_and_omits_unknown(mkpair):
    """settle(step=0) stamps its dispatcher_join phase with step 0; settle()
    without a step omits the key."""
    pair = mkpair(period=1, dispatcher_thread=True)
    seen = {"j": [], "t": []}
    pair.js.add_phase_hook(lambda ph, info: seen["j"].append((ph, info)))
    pair.ts.add_phase_hook(lambda ph, info: seen["t"].append((ph, info)))
    pair.write([0], 0.5)
    pair.tick(1)
    for store, red, key in ((pair.js, pair.jred, "j"), (pair.ts, pair.tred, "t")):
        store.settle(red, step=0)
        joins = [i for ph, i in seen[key] if ph == "dispatcher_join"]
        assert joins and joins[-1]["step"] == 0
    assert [ph for ph, _ in seen["j"]] == [ph for ph, _ in seen["t"]]
    for k in seen:
        seen[k].clear()
    pair.write([1], 0.5)
    pair.tick(2)
    for store, red, key in ((pair.js, pair.jred, "j"), (pair.ts, pair.tred, "t")):
        store.settle(red)
        joins = [i for ph, i in seen[key] if ph == "dispatcher_join"]
        assert joins and "step" not in joins[-1]
    assert [ph for ph, _ in seen["j"]] == [ph for ph, _ in seen["t"]]


class _NeverReady:
    """A completion event whose query never reports completion."""

    def query(self):
        return False


def test_pending_ready_probes_the_completion_event(mkpair):
    """Readiness is the completion event's ``query()`` (None, on the CPU,
    is ready): a lazy tick leaves a never-ready update in flight, and a
    forced resolution (settle) adopts it."""
    assert tstore_mod._ready(None) and not tstore_mod._ready(_NeverReady())
    pair = mkpair(period=1)
    pair.write([0], 0.5)
    pair.tick(1)
    tg = pair.groups()[1][0]
    tg.pending.done = _NeverReady()
    red_sub = {n: pair.tred[n] for n in tg.names}
    assert pair.ts._resolve(tg, red_sub, wait=False) == (None, False, 0)
    assert tg.pending is not None
    tg.pending.done = None           # the CPU's: nothing to order on
    pair.settle()
    assert tg.pending is None and pair.scrub_total() == 0


# --------------------------------------------------------- the port's own

@pytest.mark.parametrize("resolve", ["settle", "flush"])
def test_failed_dispatch_reraises_at_resolution(monkeypatch, resolve):
    """A dispatch that raises is kept in the pending and re-raised when it
    is resolved; the tick does not become a blocking one."""
    _, tpol = _policies(period=1)
    state = _np_leaves()
    ts = ProtectedStore(tpol, device="cpu").attach(convert.leaves_from_numpy(state, "cpu"))
    red = ts.init(convert.leaves_from_numpy(state, "cpu"))
    ev = torch.zeros(24, dtype=torch.bool)
    ev[3] = True
    red = ts.on_write(red, events={"w": ev})
    marked = int(bits.popcount(red["w"].dirty))
    eng = next(iter(ts.groups.values())).engine

    def fail(*a, **k):
        raise RuntimeError("update launch failed")

    monkeypatch.setattr(eng, "redundancy_step_async", fail)
    red, rep = ts.tick(convert.leaves_from_numpy(state, "cpu"), red, 1)
    assert rep.updated
    g = next(iter(ts.groups.values()))
    assert g.pending is not None and g.pending.error is not None
    assert int(bits.popcount(red["w"].shadow)) == marked > 0     # still marked
    with pytest.raises(RuntimeError, match="update launch failed"):
        if resolve == "settle":
            ts.settle(red)
        else:
            ts.flush(convert.leaves_from_numpy(state, "cpu"), red, step=2)
    assert g.pending is None
