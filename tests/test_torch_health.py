"""The port's health governor against the reference's, on the CPU.

The same seeded numpy leaves, writes and readiness schedule go through
``repro.health`` on the reference's store and ``repro_torch.health`` on the
port's: the per-tick reports (updated, deadline-fired and coalesced
groups; breaker states, transitions, ladder actions by rung and kind, ages
in steps, violations, backpressure events), the backoff sleeps the
governor asks for, and the redundancy after ``flush`` are equal, bit for
bit where they are bit patterns.  Readiness is patched in both packages
alike (``store._ready``; the reference's inline resolution, so no resolver
thread decides it).  ``backoff_delay``/``backoff_schedule`` give the
reference's floats exactly, jitter draws included.  Then the machine-local
tests of tests/test_health.py, ported (the chaos soak's two tests are
held against the reference in tests/test_torch_chaos.py;
``read_verified``'s retry sleeps and the governor's remesh drain in
tests/test_torch_remesh.py, a live rebuild's ``rebuild_active`` in
tests/test_torch_rebuild.py).
"""
import random
import time

import numpy as np
import pytest
import torch

from _torch_helpers import assert_red_equal, jnp_leaves
from repro.core import ProtectedStore as JStore
from repro.core import RedundancyPolicy as JPolicy
from repro.core import store as jstore_mod
from repro.health import HealthPolicy as JHealthPolicy
from repro.health import backoff as jbackoff
from repro_torch.core import ProtectedStore, RedundancyPolicy, convert
from repro_torch.core import store as store_mod
from repro_torch.core.store import TickReport
from repro_torch.health import (BackpressureError, CRITICAL, DEGRADED,
                                FreshnessViolationError, HEALTHY,
                                HealthPolicy, backoff_delay, backoff_schedule)

LANES = 64
N_ROWS = 16


def _np_leaves(n_rows=N_ROWS):
    return {"w": np.random.default_rng(0).standard_normal((n_rows, 512))
            .astype(np.float32)}


def _pol_kw(period, async_tick, pol_kw):
    return dict(period_steps=period, lanes_per_block=LANES,
                async_tick=async_tick, precompile=False, **pol_kw)


def _store(health=None, *, period=2, n_rows=N_ROWS, async_tick=True, **pol_kw):
    pol = RedundancyPolicy.single("vilamb", health=health,
                                  **_pol_kw(period, async_tick, pol_kw))
    lv = convert.leaves_from_numpy(_np_leaves(n_rows), "cpu")
    store = ProtectedStore(pol, device="cpu").attach(lv)
    red = store.init(lv)
    red = store.flush(lv, red, step=0)
    return store, lv, red


def _jstore(health=None, *, period=2, n_rows=N_ROWS, async_tick=True, **pol_kw):
    pol = JPolicy.single("vilamb", health=health, dispatcher_thread=False,
                         **_pol_kw(period, async_tick, pol_kw))
    lv = jnp_leaves(_np_leaves(n_rows))
    store = JStore(pol).attach(lv)
    red = store.init(lv)
    red = store.flush(lv, red, step=0)
    return store, lv, red


def _write(store, lv, red, rows=(0, 1)):
    w = lv["w"].clone()
    idx = torch.as_tensor(rows)
    w[idx] += 0.5
    ev = torch.zeros((w.shape[0],), dtype=torch.bool)
    ev[idx] = True
    return dict(lv, w=w), store.on_write(red, events={"w": ev})


def _jwrite(store, lv, red, rows=(0, 1)):
    import jax.numpy as jnp
    idx = jnp.asarray(rows)
    lv = dict(lv, w=lv["w"].at[idx].add(0.5))
    ev = jnp.zeros((lv["w"].shape[0],), bool).at[idx].set(True)
    return lv, store.on_write(red, events={"w": ev})


def _group(store):
    return next(iter(store.groups.values()))


# ------------------------------------------------- parity with the reference

def test_backoff_equals_reference():
    """Every delay and schedule equals the reference's float for float,
    the seeded jitter draws included."""
    for attempt in range(0, 8):
        for base, cap in ((0.0, 0.0), (0.01, 0.0), (0.005, 0.03), (0.2, 0.1)):
            for jit in (0.0, 0.25, 1.5):
                got = backoff_delay(attempt, base, cap=cap, jitter_frac=jit,
                                    rng=random.Random(attempt))
                want = jbackoff.backoff_delay(attempt, base, cap=cap,
                                              jitter_frac=jit,
                                              rng=random.Random(attempt))
                assert got == want, (attempt, base, cap, jit)
    for seed in (0, 1, 7):
        for kw in (dict(cap=0.02, total=0.035), dict(total=0.5, jitter_frac=0.25),
                   dict(cap=0.1, jitter_frac=0.5), {}):
            got = backoff_schedule(9, 0.01, seed=seed, **kw)
            assert got == jbackoff.backoff_schedule(9, 0.01, seed=seed, **kw), kw


def _health_trace(store, tick_write, lv, red, steps, wedged, patch, sleeps):
    """Drive ``steps`` ticks with a write each; readiness is False on the
    ``wedged`` steps.  Returns the per-tick records and the final state."""
    rec = []
    ready = {"on": True}
    patch(lambda x: ready["on"])
    store._health._sleep = sleeps.append
    for step in range(1, steps + 1):
        ready["on"] = step not in wedged
        lv, red = tick_write(lv, red)
        red, rep = store.tick(lv, red, step, step_time=0.01, scrub_period=0)
        h = rep.health
        rec.append({
            "updated": rep.updated, "deadline": rep.deadline_fired,
            "coalesced": rep.coalesced, "states": h.states,
            "transitions": h.transitions,
            "actions": [(a.group, a.rung, a.kind, a.step) for a in h.actions],
            "ages": {k: v[0] for k, v in h.ages.items()},
            "violations": [(v.group, v.step, v.age_steps) for v in h.violations],
            "bp_events": h.backpressure_events})
    ready["on"] = True
    return rec, lv, red


LADDERS = {
    # Rung 1 retries while wedged, exhaustion, rungs 3 and 4, recovery.
    "retry_exhaust": (dict(dispatch_timeout_s=1e-6, dispatch_retry_attempts=2,
                           retry_backoff_s=0.01, retry_jitter_frac=0.25,
                           backpressure="spin", backpressure_spin_s=0.001,
                           recovery_ticks=2, violation_mode="report"),
                      dict(period=2, max_vulnerable_steps=6), range(5, 13), 26),
    # Rung 1 off: the wedged update coalesces until the margin forces it.
    "margin": (dict(dispatch_timeout_s=0.0, deadline_margin_steps=2,
                    violation_mode="report"),
               dict(period=4, max_vulnerable_steps=6), range(3, 15), 20),
}


@pytest.mark.parametrize("ladder", sorted(LADDERS))
def test_health_reports_equal_reference(monkeypatch, ladder):
    """The governor's whole ladder, tick by tick, in both packages."""
    hp_kw, st_kw, wedged, steps = LADDERS[ladder]
    store, lv, red = _store(HealthPolicy(**hp_kw), **st_kw)
    jstore, jlv, jred = _jstore(JHealthPolicy(**hp_kw), **st_kw)
    sleeps, jsleeps = [], []
    got, lv, red = _health_trace(
        store, lambda a, b: _write(store, a, b), lv, red, steps, set(wedged),
        lambda f: monkeypatch.setattr(store_mod, "_ready", f), sleeps)
    want, jlv, jred = _health_trace(
        jstore, lambda a, b: _jwrite(jstore, a, b), jlv, jred, steps,
        set(wedged), lambda f: monkeypatch.setattr(jstore_mod, "_ready", f),
        jsleeps)
    for step, (g, w) in enumerate(zip(got, want), start=1):
        assert g == w, f"step {step}"
    assert sleeps == jsleeps                     # backoff draws included
    kinds = {a[2] for r in got for a in r["actions"]}
    if ladder == "retry_exhaust":
        assert {"retry_timeout", "retry_exhausted", "backpressure_on",
                "sync_escalate", "backpressure_off"} <= kinds, kinds
        assert got[-1]["states"] == {_group(store).label: HEALTHY}
    else:
        assert "forced_resolve" in kinds, kinds
    red = store.flush(lv, red, steps + 1)
    jred = jstore.flush(jlv, jred, steps + 1)
    assert_red_equal(jred, red, ladder)
    np.testing.assert_array_equal(np.asarray(jlv["w"]), lv["w"].numpy())


def test_violation_equals_reference():
    """An excursion past the deadline is reported with the same fields."""
    for mode in ("report", "raise"):
        reps = []
        for make in (_store, _jstore):
            store, _, _ = make(HealthPolicy(violation_mode=mode) if make is _store
                               else JHealthPolicy(violation_mode=mode),
                               max_vulnerable_steps=4)
            hg, g = store._health, _group(store)
            g.last_update_step = -10
            now = time.monotonic()
            hg.begin_tick(20, now)
            rep = TickReport(step=20)
            try:
                hg.end_tick(rep, 20, now)
                vs = rep.health.violations
            except RuntimeError as e:            # FreshnessViolationError
                vs = e.violations
            reps.append(([(v.group, v.step, v.age_steps, v.deadline_steps)
                          for v in vs], hg.group(g.label).state,
                         hg.group(g.label).backpressure,
                         hg.group(g.label).sync_escalated))
        assert reps[0] == reps[1], (mode, reps)


# ------------------------------------------------------ retry backoff (port)

def test_backoff_delay_exponential_and_cap():
    assert backoff_delay(1, 0.01) == pytest.approx(0.01)
    assert backoff_delay(2, 0.01) == pytest.approx(0.02)
    assert backoff_delay(3, 0.01) == pytest.approx(0.04)
    assert backoff_delay(4, 0.01, cap=0.03) == pytest.approx(0.03)
    assert backoff_delay(3, 0.0) == 0.0


def test_backoff_jitter_only_shrinks():
    rng = random.Random(7)
    for attempt in range(1, 6):
        base = backoff_delay(attempt, 0.01)
        jittered = backoff_delay(attempt, 0.01, jitter_frac=0.5, rng=rng)
        assert 0.5 * base <= jittered <= base


def test_backoff_schedule_total_budget():
    ds = backoff_schedule(3, 0.01, cap=0.02, total=0.035)
    assert ds == pytest.approx([0.01, 0.02, 0.005])
    assert backoff_schedule(3, 0.0) == [0.0, 0.0, 0.0]
    assert sum(backoff_schedule(10, 0.01, total=0.02)) <= 0.02 + 1e-9


# ------------------------------------------------- governor plumbing (port)

def test_governor_off_by_default():
    store, lv, red = _store(health=None)
    lv, red = _write(store, lv, red)
    red, rep = store.tick(lv, red, 1, scrub_period=0)
    assert rep.health is None
    assert store._health is None


def test_governor_on_reports_healthy():
    store, lv, red = _store(HealthPolicy(violation_mode="report"))
    label = _group(store).label
    for step in range(1, 5):
        lv, red = _write(store, lv, red)
        red, rep = store.tick(lv, red, step, step_time=0.01, scrub_period=0)
        assert rep.health is not None
        assert rep.health.states[label] == HEALTHY
        assert rep.health.worst == HEALTHY
    assert rep.health.ages[label][0] >= 0


def test_rung1_timeout_rolls_back_and_redispatches(monkeypatch):
    hp = HealthPolicy(dispatch_timeout_s=0.001, dispatch_retry_attempts=3,
                      retry_backoff_s=0.005, retry_jitter_frac=0.0,
                      violation_mode="report")
    store, lv, red = _store(hp)
    sleeps = []
    store._health._sleep = sleeps.append
    for step in (1, 2):
        lv, red = _write(store, lv, red)
        red, rep = store.tick(lv, red, step, step_time=0.01, scrub_period=0)
    g = _group(store)
    assert g.pending is not None
    prev = g.pending.prev_step
    monkeypatch.setattr(store_mod, "_ready", lambda done: False)
    g.pending.dispatched_at -= 10.0           # pending looks ancient
    red, rep = store.tick(lv, red, 3, step_time=0.01, scrub_period=0)
    acts = [(a.rung, a.kind) for a in rep.health.actions]
    assert (1, "retry_timeout") in acts
    assert rep.health.states[g.label] == DEGRADED
    assert sleeps == pytest.approx([0.005])    # bounded backoff slept
    # Re-dispatched this tick (a fresh pending), not at the next period.
    assert g.pending is not None
    assert g.pending.prev_step <= prev


def test_rung1_exhaustion_escalates_then_recovers(monkeypatch):
    hp = HealthPolicy(dispatch_timeout_s=1e-6, dispatch_retry_attempts=1,
                      retry_backoff_s=0.0, backpressure="spin",
                      backpressure_spin_s=0.0, recovery_ticks=2,
                      violation_mode="report")
    store, lv, red = _store(hp)
    hg = store._health
    hg._sleep = lambda s: None
    monkeypatch.setattr(store_mod, "_ready", lambda done: False)
    label = _group(store).label
    step, worst_seen = 1, []
    for _ in range(8):
        lv, red = _write(store, lv, red)
        red, rep = store.tick(lv, red, step, step_time=0.01, scrub_period=0)
        step += 1
        worst_seen.append(rep.health.states[label])
        if rep.health.states[label] == CRITICAL:
            break
    assert CRITICAL in worst_seen
    gh = hg.group(label)
    assert gh.sync_escalated and gh.backpressure
    kinds = {a.kind for a in rep.health.actions}
    assert {"retry_exhausted", "backpressure_on", "sync_escalate"} <= kinds
    seen = []
    for _ in range(12):
        lv, red = _write(store, lv, red)
        red, rep = store.tick(lv, red, step, step_time=0.01, scrub_period=0)
        step += 1
        seen.append(rep.health.states[label])
        if rep.health.states[label] == HEALTHY:
            break
    assert seen[-1] == HEALTHY
    assert DEGRADED in seen                    # hysteresis: one level at a time
    assert not hg.group(label).backpressure
    assert not hg.group(label).sync_escalated
    assert hg.group(label).retries == 0


def test_rung2_margin_forces_blocking_resolve(monkeypatch):
    hp = HealthPolicy(dispatch_timeout_s=0.0,       # rung 1 disabled
                      deadline_margin_steps=2, violation_mode="report")
    store, lv, red = _store(hp, period=4, max_vulnerable_steps=6)
    monkeypatch.setattr(store_mod, "_ready", lambda done: False)
    for step in range(1, 5):
        lv, red = _write(store, lv, red)
        red, rep = store.tick(lv, red, step, step_time=0.01, scrub_period=0)
    g = _group(store)
    assert g.pending is not None               # wedged probe: still in flight
    fired = None
    for step in range(5, 9):
        red, rep = store.tick(lv, red, step, step_time=0.01, scrub_period=0)
        if any(a.kind == "forced_resolve" for a in rep.health.actions):
            fired = step
            break
    assert fired == 8, fired
    acts = [(a.rung, a.kind) for a in rep.health.actions]
    assert (2, "forced_resolve") in acts
    assert rep.health.states[g.label] == DEGRADED
    assert not rep.deadline_fired              # met early, not missed


# ------------------------------------------- rung 3: admission control (port)

def test_backpressure_error_policy_raises_typed():
    hp = HealthPolicy(backpressure="error", violation_mode="report")
    store, lv, red = _store(hp)
    label = _group(store).label
    store._health.group(label).backpressure = True
    with pytest.raises(BackpressureError) as ei:
        _write(store, lv, red)
    assert label in ei.value.groups


def test_backpressure_spin_policy_bounded_stall():
    hp = HealthPolicy(backpressure="spin", backpressure_spin_s=0.002,
                      violation_mode="report")
    store, lv, red = _store(hp)
    spins = []
    store._health._sleep = spins.append
    store._health.group(_group(store).label).backpressure = True
    lv, red = _write(store, lv, red)           # no raise: bounded spin
    assert spins == [0.002]


def test_backpressure_noop_under_trace():
    """Admission control never blocks inside a compiled step: while
    torch.compile traces ``on_write`` it is a no-op (the reference's jax
    tracer check)."""
    hp = HealthPolicy(backpressure="error", violation_mode="report")
    store, lv, red = _store(hp)
    store._health.group(_group(store).label).backpressure = True
    ev = torch.zeros((lv["w"].shape[0],), dtype=torch.bool)
    ev[0] = True
    stepped = torch.compile(lambda r: store.on_write(r, events={"w": ev}),
                            backend="eager")
    red2 = stepped(red)                        # would raise on the host path
    assert red2 is not None
    assert store._health._bp_events == 0


# --------------------------------------------- violations are typed (port)

def _violating_governor(mode):
    store, lv, red = _store(HealthPolicy(violation_mode=mode),
                            max_vulnerable_steps=4)
    g = _group(store)
    g.last_update_step = -10                   # ancient unprotected write
    return store, store._health, g


def test_violation_reported_never_silent():
    store, hg, g = _violating_governor("report")
    now = time.monotonic()
    hg.begin_tick(20, now)
    rep = TickReport(step=20)
    hg.end_tick(rep, 20, now)
    assert rep.health.violations, "deadline excursion must be surfaced"
    v = rep.health.violations[0]
    assert v.group == g.label and v.age_steps == 30
    assert rep.health.states[g.label] == CRITICAL
    assert hg.group(g.label).backpressure or hg.group(g.label).sync_escalated


def test_violation_mode_raise_is_typed():
    store, hg, g = _violating_governor("raise")
    now = time.monotonic()
    hg.begin_tick(20, now)
    with pytest.raises(FreshnessViolationError) as ei:
        hg.end_tick(TickReport(step=20), 20, now)
    assert ei.value.violations[0].group == g.label


def test_health_policy_validation():
    with pytest.raises(ValueError):
        HealthPolicy(backpressure="bogus")
    with pytest.raises(ValueError):
        HealthPolicy(violation_mode="bogus")


# ---------------------- patrol starvation x governor backpressure (port)

def test_patrol_floor_survives_backpressure():
    """The patrol starvation floor keeps forcing probes while the governor
    applies backpressure, and the governor's report mirrors the streak."""
    hp = HealthPolicy(backpressure="spin", backpressure_spin_s=0.001,
                      violation_mode="report")
    bpb = LANES * 4
    pol = RedundancyPolicy.single(
        "vilamb", period_steps=1, lanes_per_block=LANES,
        patrol_bytes_per_tick=8 * bpb, patrol_max_starved_ticks=4,
        async_tick=False, precompile=False, health=hp)
    lv = convert.leaves_from_numpy(_np_leaves(32), "cpu")
    store = ProtectedStore(pol, device="cpu").attach(lv)
    red = store.init(lv)
    spins = []
    store._health._sleep = spins.append
    store._health.group(_group(store).label).backpressure = True
    for step in range(1, 31):
        lv, red = _write(store, lv, red, rows=(0, 1, 2, 3))
        red, rep = store.tick(lv, red, step, step_time=0.01, scrub_period=0)
        assert rep.updated, "tick unexpectedly quiet"
        assert rep.health.patrol_starved_ticks == rep.patrol_starved_ticks
    assert store.patroller.blocks_scanned >= 8   # floor forced probes
    assert rep.patrol_starved_ticks <= 4
    assert spins == [0.001] * 30                 # every admit spun, none raised
