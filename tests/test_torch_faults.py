"""The port's fault battery against the reference's, on the CPU.

The same seeded numpy leaves and schedules go through ``repro.faults`` and
``repro_torch.faults``: the injector's planned specs, every fault kind's
corrupted leaves and redundancy (inputs untouched in both packages), the
vulnerability window, the oracle's reports, the detection-latency records,
the fired crash-phase list, one crash outcome per distinct phase, the two
crash-plus-corruption cases, crash checkpoints restored across packages and
faults injected while an update is held in flight are all equal, bit for bit
where they are bit patterns (tolerance 0).  Then the machine-local tests of
tests/test_faults.py, ported; the whole crash sweep and the battery's CLI
run on the port alone.  Mirrors tests/test_faults.py.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_helpers import assert_red_equal, jnp_leaves, red_jax_to_numpy, u32
from repro import faults as jfaults
from repro.ckpt import CheckpointManager as JCkpt
from repro.core import ProtectedStore as JStore
from repro.core import RedundancyPolicy as JPolicy
from repro.faults import crashpoints as jcrash
from repro.faults import inject as jinject
from repro_torch import faults
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.failure import repair_corruption
from repro_torch.core import ALL, ProtectedStore, RedundancyPolicy, convert, mttdl
from repro_torch.core.state import FIELDS
from repro_torch.faults import (CrashPlan, CrashPointMachine, FaultInjector,
                                FaultSpec, check_detection, vulnerability_window)
from repro_torch.faults import __main__ as cli
from repro_torch.faults import crashpoints, inject
from repro_torch.faults.crashpoints import StoreState

SEED = int(os.environ.get("REPRO_TEST_SEED", "0"))


def _np_leaves():
    """The reference tests' shapes: w is 38 blocks of 128 lanes whose lane
    view is a padded copy; e fills its 4 blocks exactly (a view)."""
    rng = np.random.default_rng(SEED)
    return {"w": rng.standard_normal((24, 200)).astype(np.float32),
            "e": rng.standard_normal((16, 64)).astype(np.float32)
            .astype(ml_dtypes.bfloat16)}


def _leaves():
    return convert.leaves_from_numpy(_np_leaves(), "cpu")


def _jleaves():
    return jnp_leaves(_np_leaves())


def _policy_kw(async_on=True, period=2, scrub=0, deadline=0):
    return dict(period_steps=period, scrub_period_steps=scrub,
                max_vulnerable_steps=deadline, lanes_per_block=128,
                work_queue_frac=0.5, async_tick=async_on, precompile=False)


def _store(**kw):
    return ProtectedStore(RedundancyPolicy.single("vilamb", **_policy_kw(**kw)),
                          device="cpu").attach(_leaves())


def _jstore(**kw):
    return JStore(JPolicy.single("vilamb", **_policy_kw(**kw))).attach(_jleaves())


def _clean_state():
    store = _store()
    leaves = _leaves()
    return store, leaves, store.init(leaves)


def _leaf_bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return convert.leaves_to_numpy({"x": x})["x"].view(np.uint8)
    return np.asarray(x).view(np.uint8)


def _assert_leaves_equal(jl, tl, msg=""):
    assert set(jl) == set(tl)
    for n in jl:
        np.testing.assert_array_equal(_leaf_bytes(jl[n]), _leaf_bytes(tl[n]),
                                      err_msg=f"{msg} {n}")


def _spec(js) -> faults.FaultSpec:
    return FaultSpec(**dataclasses.asdict(js))


def _jspec(ts) -> jfaults.FaultSpec:
    return jfaults.FaultSpec(**dataclasses.asdict(ts))


def _write_rows(rng, n=24):
    return np.sort(rng.choice(n, size=int(rng.integers(1, 4)), replace=False))


def _step(pkg, store, leaves, red, rows, step):
    """One step of the oracle workload: 0.5 added to ``rows`` of w, their
    marks, the store's tick once the last update has landed."""
    if pkg == "torch":
        w = leaves["w"].clone()
        w[torch.as_tensor(rows)] += 0.5
        ev = torch.zeros(24, dtype=torch.bool)
        ev[torch.as_tensor(rows)] = True
    else:
        idx = jnp.asarray(rows)
        w = leaves["w"].at[idx].add(0.5)
        ev = jnp.zeros((24,), bool).at[idx].set(True)
    leaves = dict(leaves, w=w)
    red = store.on_write(red, events={"w": ev})
    # Adopt, never coalesce, in both packages: the port's CPU dispatch runs
    # to completion, while under load the reference's update of the last
    # due tick can still be in flight at the next one, which then coalesces
    # and leaves other blocks marked.
    store.sync_inflight()
    red, _ = store.tick(leaves, red, step)
    return leaves, red


def _drive(pkg, steps=6, seed=SEED, **kw):
    """The oracle workload (1-3 random rows of w a step) on a store of
    ``pkg`` ("torch" or "jax"); returns ``(store, leaves, red)``."""
    store = _store(**kw) if pkg == "torch" else _jstore(**kw)
    leaves = _leaves() if pkg == "torch" else _jleaves()
    red = store.init(leaves)
    rng = np.random.default_rng(seed)
    for step in range(1, steps + 1):
        leaves, red = _step(pkg, store, leaves, red, _write_rows(rng), step)
    return store, leaves, red


def _drive_both(steps=6, seed=SEED, **kw):
    return _drive("torch", steps, seed, **kw), _drive("jax", steps, seed, **kw)


@pytest.fixture(scope="module")
def driven():
    """Both packages after 6 steps of the oracle workload.  Injection never
    writes its inputs (checked below), so the tests share them."""
    return _drive_both()


# ------------------------------------------------------------ the injector
@pytest.mark.parametrize("kinds", [("data_bitflip",), ("data_bitflip", "torn_write"),
                                   ("stale_redundancy", "checksum_bitflip",
                                    "parity_bitflip", "meta_bitflip")])
def test_plan_equals_reference(driven, kinds):
    """``plan`` draws the reference's specs call for call, per leaf and
    over every leaf."""
    (ts, _, tr), (js, _, jr) = driven
    for leaf in (None, "w", "e"):
        want = jfaults.FaultInjector(js, seed=7).plan(16, kinds=kinds, leaf=leaf)
        got = FaultInjector(ts, seed=7).plan(16, kinds=kinds, leaf=leaf)
        assert got == [_spec(s) for s in want], leaf


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_plan_clean_blocks_equals_reference(seed):
    (ts, _, tr), (js, _, jr) = _drive_both(seed=seed)
    for n, kinds in ((4, ("data_bitflip",)),
                     (40, ("data_bitflip", "stale_redundancy"))):
        want = jfaults.FaultInjector(js, seed=seed).plan_clean_blocks(jr, n, kinds)
        got = FaultInjector(ts, seed=seed).plan_clean_blocks(tr, n, kinds)
        assert got == [_spec(s) for s in want]


KIND_SPECS = [
    ("data_bitflip", dict(block=5, lane=7, bit=31)),
    ("data_bitflip", dict(block=2, lane=3, payload=0xFFFFFFFF)),
    ("checksum_bitflip", dict(block=3, bit=31)),
    ("checksum_bitflip", dict(block=1, payload=0x7FC00000)),
    ("parity_bitflip", dict(block=3, lane=9, bit=30)),
    ("meta_bitflip", dict(bit=31)),
    ("torn_write", dict(block=3, blocks=(3, 4, 5))),
    ("stale_redundancy", dict(block=2, blocks=(2,), payload=0xFF800000)),
    ("shard_loss", dict(block=0)),
    ("mesh_shrink", dict(block=0, payload=0x80000001)),
    ("mesh_grow", dict(block=0)),
]


@pytest.mark.parametrize("leaf", ["w", "e"])
@pytest.mark.parametrize("kind,kw", KIND_SPECS,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(KIND_SPECS)])
def test_apply_fault_equals_reference(driven, kind, kw, leaf):
    """Every kind on a padded-copy leaf (w) and a lane-view leaf (e): bit
    equal leaves and redundancy, inputs untouched in both packages."""
    (ts, tl, tr), (js, jl, jr) = driven
    nb = ts.metas[leaf].n_blocks                    # e has 4 blocks
    kw = dict(kw, **{k: (tuple(b % nb for b in v) if k == "blocks" else v % nb)
                     for k, v in kw.items() if k in ("block", "blocks")})
    spec = FaultSpec(kind=kind, leaf=leaf, **kw)
    t_lv, t_red = convert.leaves_to_numpy(tl), convert.red_to_numpy(tr)
    j_lv, j_red = {k: np.array(v) for k, v in jl.items()}, red_jax_to_numpy(jr)
    tl2, tr2 = ts.inject(tl, tr, spec)
    jl2, jr2 = js.inject(jl, jr, _jspec(spec))
    _assert_leaves_equal(jl2, tl2, kind)
    assert_red_equal(jr2, tr2, kind)
    assert any(not np.array_equal(t_lv[n].view(np.uint8), _leaf_bytes(tl2[n]))
               for n in tl) or any(
        not np.array_equal(t_red[n][f], u32(getattr(tr2[n], f)))
        for n in tr for f in FIELDS), f"{kind} changed nothing"
    for n in tl:
        np.testing.assert_array_equal(t_lv[n].view(np.uint8), _leaf_bytes(tl[n]))
        np.testing.assert_array_equal(j_lv[n].view(np.uint8), _leaf_bytes(jl[n]))
    for n in tr:
        for f in FIELDS:
            np.testing.assert_array_equal(t_red[n][f], u32(getattr(tr[n], f)))
            np.testing.assert_array_equal(j_red[n][f].astype(np.uint32),
                                          u32(getattr(jr[n], f)))


def test_apply_fault_refuses_what_is_not_local():
    """A shard count the leaf does not have is refused as the reference
    refuses it (global-block addressing of a leaf that is not dim0-sharded
    that many ways); ids past the leaf's shards are refused too."""
    store, leaves, red = _clean_state()
    metas = store.metas
    jstore = _jstore()
    jleaves = _jleaves()
    jred = jstore.init(jleaves)
    with pytest.raises(ValueError) as want:
        jinject.apply_fault(jstore.metas, jleaves, jred,
                            jfaults.FaultSpec("data_bitflip", "w", 1), factors={"w": 2})
    with pytest.raises(ValueError) as got:
        faults.apply_fault(metas, leaves, red, FaultSpec("data_bitflip", "w", 1),
                           factors={"w": 2})
    assert str(got.value) == str(want.value) and "dim0-only sharding" in str(got.value)
    for kind in ("shard_loss", "mesh_shrink"):
        with pytest.raises(ValueError, match="addresses shard 1"):
            faults.apply_fault(metas, leaves, red, FaultSpec(kind, "w", 1))
    with pytest.raises(ValueError, match="addresses shard 1"):
        faults.apply_fault(metas, leaves, red,
                           FaultSpec("data_bitflip", "w", metas["w"].n_blocks))


def test_bits_to_mask_equals_reference():
    """Bit 31 and multi-shard layouts through int32-carried words."""
    rng = np.random.default_rng(SEED)
    words = rng.integers(0, 2**32, size=6, dtype=np.uint64).astype(np.uint32)
    words[0] = 0x80000001
    for n_bits, shards in ((70, 1), (180, 1), (90, 2), (64, 3)):
        want = jinject.bits_to_mask(words, n_bits, shards=shards)
        got = inject.bits_to_mask(words.view(np.int32), n_bits, shards=shards)
        np.testing.assert_array_equal(got, want)
    assert inject.bits_to_mask(words.view(np.int32), 32)[31]


# --------------------------------------------------------------- the oracle
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_oracle_equals_reference(seed):
    """Window, injected state and the oracle's report equal the reference's."""
    (ts, tl, tr), (js, jl, jr) = _drive_both(seed=seed)
    tw, jw = vulnerability_window(ts, tr), jfaults.vulnerability_window(js, jr)
    for n in jw.blocks:
        np.testing.assert_array_equal(tw.blocks[n], jw.blocks[n])
        np.testing.assert_array_equal(tw.stripes[n], jw.stripes[n])
    assert tw.n_vulnerable_stripes() == jw.n_vulnerable_stripes()
    kinds = ("data_bitflip", "stale_redundancy", "torn_write")
    tinj, jinj = FaultInjector(ts, seed=seed), jfaults.FaultInjector(js, seed=seed)
    specs = tinj.plan_clean_blocks(tr, 5, kinds[:2]) + tinj.plan(3, kinds)
    jspecs = jinj.plan_clean_blocks(jr, 5, kinds[:2]) + jinj.plan(3, kinds)
    assert specs == [_spec(s) for s in jspecs]
    tl2, tr2 = tinj.inject_many(tl, tr, specs)
    jl2, jr2 = jinj.inject_many(jl, jr, jspecs)
    assert tinj.log == specs
    _assert_leaves_equal(jl2, tl2)
    assert_red_equal(jr2, tr2)
    got = check_detection(ts, tl2, tr2, specs, window=tw)
    want = jfaults.check_detection(js, jl2, jr2, jspecs, window=jw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary() and got.ok == want.ok


def _latency_drive(store, pkg, plan):
    """``drive(step, leaves, red)`` over ``plan[step]`` rows; step 0 inits."""
    def drive(step, leaves, red):
        if step == 0:
            leaves = _leaves() if pkg == "torch" else _jleaves()
            return leaves, store.init(leaves)
        return _step(pkg, store, leaves, red, plan[step], step)
    return drive


def test_detection_latency_equals_reference():
    """Records (spec, steps, in-window flag) equal the reference's for a
    clean-block fault, an in-window one and a torn write, scrub every 4."""
    rng = np.random.default_rng(SEED)
    plan = {s: _write_rows(rng) for s in range(1, 13)}
    w_block = lambda row: row * 200 // 128          # first block of a row of w
    inject_at = {
        2: [FaultSpec("data_bitflip", "w", block=37, lane=2, bit=31)],
        5: [FaultSpec("data_bitflip", "w", block=w_block(int(plan[5][0])), lane=1, bit=3),
            FaultSpec("data_bitflip", "e", block=1, lane=9, bit=4)],
        9: [FaultSpec("torn_write", "e", block=1, blocks=(1, 2))],
    }
    ts, js = _store(period=3), _jstore(period=3)
    got = faults.oracle.measure_detection_latency(ts, _latency_drive(ts, "torch", plan),
                                           inject_at, 12, 4)
    want = jfaults.oracle.measure_detection_latency(
        js, _latency_drive(js, "jax", plan),
        {s: [_jspec(x) for x in v] for s, v in inject_at.items()}, 12, 4)
    key = lambda r: (dataclasses.astuple(r.spec), r.injected_step, r.detected_step,
                     r.in_window_at_injection, r.latency_steps)
    assert [key(r) for r in got] == [key(r) for r in want]
    assert any(r.in_window_at_injection for r in got)
    assert any(r.latency_steps for r in got)


# ---------------------------------------------------------- crash machine
def _machine(pkg, tmp, **kw):
    kw.setdefault("steps", 6)
    kw.setdefault("scrub_every", 5)
    kw.setdefault("hold_inflight_steps", (3, 4))
    if pkg == "torch":
        return CrashPointMachine(lambda: _store(period=2, deadline=3), _leaves,
                                 tmp, seed=SEED, **kw)
    return jfaults.CrashPointMachine(lambda: _jstore(period=2, deadline=3),
                                     _jleaves, tmp, seed=SEED, **kw)


@pytest.fixture(scope="module")
def machines(tmp_path_factory):
    """The reference's and the port's machine over the same workload, and
    the reference's fired (phase, occurrence) list."""
    t = _machine("torch", tmp_path_factory.mktemp("torch_crash"))
    j = _machine("jax", tmp_path_factory.mktemp("jax_crash"))
    return t, j, j.enumerate_phases()


def _outcome(o):
    return ((o.plan.phase, o.plan.occurrence), o.step, o.classification,
            o.diverged, o.window, o.scrub_after_flush)


def test_fired_phases_equal_reference(machines):
    """The port fires the reference's 26 (phase, occurrence) entries, in
    order: dispatcher_enqueue and dispatcher_join included, though the
    port launches and waits on its own thread."""
    t, _, want = machines
    got = t.enumerate_phases()
    assert got == want
    assert len(got) == 26 and len({p for p, _ in got}) == 11


DISTINCT_PHASES = ("init", "on_write", "tick", "dispatcher_enqueue", "dispatch",
                   "coalesce", "dispatcher_join", "adopt_forced", "scrub",
                   "adopt", "flush")


@pytest.mark.parametrize("phase", DISTINCT_PHASES)
def test_crash_outcome_equals_reference(machines, phase):
    """One crash at the first firing of each distinct phase: the same step,
    classification, diverged and window blocks and post-flush scrub."""
    t, j, _ = machines
    got = t.run_crash(CrashPlan(phase, 0))
    want = j.run_crash(jfaults.CrashPlan(phase, 0))
    assert _outcome(got) == _outcome(want)
    assert got.ok and set(got.seconds) == {"drive_s", "save_s", "restore_s"}


def _corruption_blocks(t):
    """The last dispatch crash, a block of w in a stripe with no window
    block, and the first window block of w (the port's probe)."""
    fired = t.enumerate_phases()
    plan = [CrashPlan(p, o) for p, o in fired if p == "dispatch"][-1]
    window_w = t.run_crash(plan).window.get("w", set())
    meta = t._probe().protected_metas["w"]
    sw = meta.stripe_data_blocks
    clean = [b for b in range(meta.n_blocks)
             if all(v // sw != b // sw for v in window_w)]
    return plan, clean[0], sorted(window_w)


@pytest.mark.parametrize("where", ["outside", "inside"])
def test_crash_with_corruption_equals_reference(machines, where):
    """A bit flipped in the persisted state of the last dispatch crash,
    outside the window (repaired on restore) or inside it (bounded loss),
    classifies as the reference's does."""
    t, j, _ = machines
    plan, clean, window_w = _corruption_blocks(t)
    block = clean if where == "outside" else window_w[0]
    spec = FaultSpec(kind="data_bitflip", leaf="w", block=block, lane=3, bit=7)
    got = t.run_crash(plan, faults=(spec,))
    want = j.run_crash(jfaults.CrashPlan(plan.phase, plan.occurrence),
                       faults=(_jspec(spec),))
    assert _outcome(got) == _outcome(want)
    assert got.classification == ("recovered_bitwise" if where == "outside"
                                  else "lost_within_window")


def _inflight_both():
    """Both stores right after a due tick whose update is held in flight."""
    (ts, tl, tr), (js, jl, jr) = _drive_both(steps=1)
    tr = ts.on_write(tr, events={"w": ALL})
    jr = js.on_write(jr, events={"w": ALL})
    tr, trep = ts.tick(tl, tr, 2)
    jr, jrep = js.tick(jl, jr, 2)
    assert trep.updated and jrep.updated
    assert all(g.pending is not None for g in ts.groups.values())
    return (ts, tl, tr), (js, jl, jr)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_crash_checkpoint_restores_across_packages(tmp_path, direction):
    """A StoreState written mid-flight by either package restores bitwise
    in the other: the same manifest (key paths, order, shapes, dtypes,
    file checksums) and the same arrays."""
    (ts, tl, tr), (js, jl, jr) = _inflight_both()
    tstate = StoreState(leaves=tl, red=tr, step=2)
    jstate = jcrash.StoreState(leaves=jl, red=jr, step=jnp.asarray(2, jnp.int32))
    CheckpointManager(tmp_path / "t", device="cpu").save(2, tstate, store=ts)
    JCkpt(tmp_path / "j").save(2, jstate, blocking=True)
    mt = json.loads((tmp_path / "t/step_2/manifest.json").read_text())
    mj = json.loads((tmp_path / "j/step_2/manifest.json").read_text())
    assert mt == mj
    src = tmp_path / ("j" if direction == "jax_to_torch" else "t")
    if direction == "jax_to_torch":
        got = CheckpointManager(src, device="cpu").restore_into(
            crashpoints._struct(tstate))
        assert got.step == 2
        _assert_leaves_equal(jl, got.leaves)
        assert_red_equal(jr, got.red)
    else:
        got = JCkpt(src).restore_into(jax.eval_shape(lambda: jstate))
        assert int(got.step) == 2
        _assert_leaves_equal(got.leaves, tl)
        assert_red_equal(got.red, tr)


@pytest.mark.parametrize("kind", ["checksum_bitflip", "meta_bitflip"])
def test_inflight_redundancy_fault_equals_reference(kind):
    """A redundancy fault injected into the live view while the update is
    held in flight: caught by verify_meta before adoption in both; after
    ``settle`` both packages hold equal red, the fault-free adoption's (the
    adopted arrays are the update's, which the injection never touched)."""
    (ts, tl, tr), (js, jl, jr) = _inflight_both()
    spec = FaultSpec(kind=kind, leaf="w", block=5, bit=31)
    _, tr2 = ts.inject(tl, tr, spec)
    _, jr2 = js.inject(jl, jr, _jspec(spec))
    assert_red_equal(jr2, tr2, "injected")
    assert not bool(ts.verify_meta(tr2)["w"]) and not bool(js.verify_meta(jr2)["w"])
    got, want = ts.settle(tr2, tl, step=2), js.settle(jr2, jl, step=2)
    assert_red_equal(want, got, "settled")
    (ts0, tl0, tr0), _ = _inflight_both()
    assert_red_equal(want, ts0.settle(tr0, tl0, step=2), "fault-free settle")
    assert all(bool(v) for v in ts.verify_meta(got).values())


# ------------------------------------ tests/test_faults.py, on the port alone
def test_injector_deterministic_from_seed():
    store, _, red = _clean_state()
    a = FaultInjector(store, seed=7).plan(8, kinds=("data_bitflip", "torn_write"))
    b = FaultInjector(store, seed=7).plan(8, kinds=("data_bitflip", "torn_write"))
    assert a == b
    c = FaultInjector(store, seed=8).plan(8, kinds=("data_bitflip", "torn_write"))
    assert a != c
    x = FaultInjector(store, seed=7).plan_clean_blocks(red, 4)
    y = FaultInjector(store, seed=7).plan_clean_blocks(red, 4)
    assert x == y


@pytest.mark.parametrize("kind", ["data_bitflip", "torn_write", "stale_redundancy"])
def test_data_faults_detected_by_scrub(kind):
    """Every data-side fault kind on a clean store is caught, exactly."""
    store, leaves, red = _clean_state()
    inj = FaultInjector(store, seed=SEED)
    spec = dataclasses.replace(
        inj.plan(1, kinds=(kind,), leaf="w")[0], block=5,
        blocks=(5, 6) if kind == "torn_write" else
        ((5,) if kind == "stale_redundancy" else ()))
    lv2, red2 = store.inject(leaves, red, spec)
    mm = store.scrub(lv2, red2)
    got = set(torch.nonzero(mm["w"]).flatten().tolist())
    assert got == set(spec.touched_blocks), (kind, got)
    assert int(mm["e"].sum()) == 0


def test_redundancy_side_faults_caught_by_meta_or_repair():
    store, leaves, red = _clean_state()
    # checksum corruption: the block scrubs as mismatching AND the
    # checksum-of-checksums flags the leaf
    _, red_ck = store.inject(leaves, red, FaultSpec(
        kind="checksum_bitflip", leaf="w", block=3, bit=5))
    assert not bool(store.verify_meta(red_ck)["w"])
    mm = store.scrub(leaves, red_ck)
    assert torch.nonzero(mm["w"]).flatten().tolist() == [3]
    # meta corruption alone: data scrubs clean, meta check trips
    _, red_mc = store.inject(leaves, red, FaultSpec(
        kind="meta_bitflip", leaf="w", bit=1))
    assert not bool(store.verify_meta(red_mc)["w"])
    assert sum(int(v.sum()) for v in store.scrub(leaves, red_mc).values()) == 0
    # parity corruption: silent for scrub, but a repair through that stripe
    # must produce data the post-repair scrub rejects (never silent success)
    _, red_par = store.inject(leaves, red, FaultSpec(
        kind="parity_bitflip", leaf="w", block=8, lane=2, bit=9))
    lv_bad, _ = store.inject(leaves, red_par, FaultSpec(
        kind="data_bitflip", leaf="w", block=8, lane=1, bit=1))
    mm = store.scrub(lv_bad, red_par)
    repaired, fixed, lost = repair_corruption(store, lv_bad, red_par, mm)
    assert (fixed, lost) == (1, 0)
    mm2 = store.scrub(repaired, red_par)
    assert int(mm2["w"].sum()) > 0   # bad parity -> bad rebuild


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_oracle_full_detection_no_false_positives(seed):
    """100% detection of single-stripe corruptions outside the window, zero
    false positives, across seeds."""
    store, leaves, red = _drive("torch", seed=seed)
    inj = FaultInjector(store, seed=seed)
    specs = inj.plan_clean_blocks(red, n=5, kinds=("data_bitflip",
                                                   "stale_redundancy"))
    assert specs, "workload dirtied every stripe; shrink the write set"
    window = vulnerability_window(store, red)
    lv2, red2 = inj.inject_many(leaves, red, specs)
    rep = check_detection(store, lv2, red2, specs, window=window)
    assert rep.ok, rep.summary()
    want = {(s.leaf, b) for s in specs for b in s.touched_blocks}
    assert sum(len(v) for v in rep.expected.values()) == len(want)
    assert not any(rep.in_window.values())


def test_oracle_in_window_corruption_is_classified_not_flagged():
    """A corruption under a live dirty mark is invisible to scrub (stale
    checksum): the oracle classifies it in-window, not as a miss."""
    store, leaves, red = _clean_state()
    ev = torch.zeros(24, dtype=torch.bool)
    ev[0] = True
    red = store.on_write(red, events={"w": ev})
    window = vulnerability_window(store, red)
    dirty_block = int(np.flatnonzero(window.blocks["w"])[0])
    spec = FaultSpec(kind="data_bitflip", leaf="w", block=dirty_block,
                     lane=1, bit=3)
    lv2, red2 = store.inject(leaves, red, spec)
    rep = check_detection(store, lv2, red2, [spec], window=window)
    assert rep.ok
    assert rep.in_window == {"w": {dirty_block}}
    assert not rep.expected and not rep.detected.get("w")


def test_crash_sweep_covers_pipeline_and_recovers(tmp_path):
    """The port's whole sweep: every tick phase fires and every crash point
    is bitwise-recoverable (no corruption injected, so no loss allowed)."""
    m = _machine("torch", tmp_path)
    outcomes = m.sweep(require_phases=cli.REQUIRED_PHASES)
    assert len(outcomes) == 26
    bad = [o for o in outcomes if o.classification != "recovered_bitwise"]
    assert not bad, [(o.plan, o.classification, o.diverged) for o in bad]
    assert all(o.scrub_after_flush == 0 for o in outcomes)


def test_crash_corruption_outside_window_repairs(tmp_path):
    m = _machine("torch", tmp_path)
    plan, clean, _ = _corruption_blocks(m)
    out = m.run_crash(plan, faults=(FaultSpec(
        kind="data_bitflip", leaf="w", block=clean, lane=3, bit=7),))
    assert out.classification == "recovered_bitwise"


def test_crash_corruption_inside_window_is_provably_bounded(tmp_path):
    m = _machine("torch", tmp_path)
    plan, _, window_w = _corruption_blocks(m)
    assert window_w, "dispatch crash point must hold a non-empty shadow"
    out = m.run_crash(plan, faults=(FaultSpec(
        kind="data_bitflip", leaf="w", block=window_w[0], lane=3, bit=7),))
    assert out.classification == "lost_within_window"
    assert set(out.diverged.get("w", ())) <= set(window_w)
    assert out.scrub_after_flush == 0      # forward progress resumes


def _saved_state(tmp_path, leaves, red, step=1):
    state = StoreState(leaves=dict(leaves), red=dict(red), step=step)
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save(step, state, blocking=True)
    return mgr, state


def _restore(mgr, state, store):
    return mgr.restore_verified(
        crashpoints._struct(state), store,
        leaves_of=lambda st: st.leaves,
        replace_leaves=lambda st, lv: dataclasses.replace(st, leaves=dict(lv)))


def test_restore_verified_multi_leaf_and_boundary_corruption(tmp_path):
    """Corruptions across two leaves plus both sides of a parity-group
    boundary (and the padded last stripe) all repair on restore."""
    store, leaves, red = _clean_state()
    red = store.flush(leaves, red)
    mgr, state = _saved_state(tmp_path, leaves, red)
    meta = store.protected_metas["w"]
    sw = meta.stripe_data_blocks
    lv2, red2 = dict(leaves), dict(red)
    for spec in (
            FaultSpec(kind="data_bitflip", leaf="w", block=sw - 1, lane=9, bit=4),
            FaultSpec(kind="data_bitflip", leaf="w", block=sw, lane=0, bit=31),
            FaultSpec(kind="data_bitflip", leaf="w",
                      block=meta.n_blocks - 1, lane=2, bit=1),
            FaultSpec(kind="data_bitflip", leaf="e", block=0, lane=5, bit=17)):
        lv2, red2 = store.inject(lv2, red2, spec)
    mgr.save(1, StoreState(leaves=lv2, red=red2, step=state.step), blocking=True)
    restored = _restore(mgr, state, store)
    assert restored is not None
    rep = mgr.last_restore_report
    assert rep.step == 1 and rep.repaired_blocks == 4
    assert rep.tried == [(1, "ok_repaired")]
    for name in leaves:
        assert torch.equal(restored.leaves[name], leaves[name])


def test_same_parity_group_double_corruption_fails_loudly(tmp_path):
    """Two corrupt stripe-mates must not silently 'repair': repair refuses,
    warns, and restore falls back a checkpoint."""
    store, leaves, red = _clean_state()
    red = store.flush(leaves, red)
    mgr, state = _saved_state(tmp_path, leaves, red, step=1)
    lv2, red2 = store.inject(leaves, red, FaultSpec(
        kind="data_bitflip", leaf="w", block=4, lane=3, bit=2))
    lv2, red2 = store.inject(lv2, red2, FaultSpec(
        kind="data_bitflip", leaf="w", block=5, lane=8, bit=19))
    mgr.save(2, StoreState(leaves=lv2, red=red2, step=2), blocking=True)

    mm = store.scrub(lv2, red2)
    with pytest.warns(RuntimeWarning, match="share parity group"):
        _, fixed, lost = repair_corruption(store, lv2, red2, mm)
    assert (fixed, lost) == (0, 2)

    with pytest.warns(RuntimeWarning, match="share parity group"):
        restored = _restore(mgr, state, store)
    assert restored is not None
    rep = mgr.last_restore_report
    assert rep.tried == [(2, "unrecoverable"), (1, "ok")]
    assert rep.step == 1 and rep.lost_blocks == 2
    assert len(rep.unrecoverable) == 1
    u = rep.unrecoverable[0]
    assert (u.leaf, u.reason) == ("w", "multi_corrupt")
    assert u.stripe == 1 and set(u.blocks) == {4, 5}
    assert torch.equal(restored.leaves["w"], leaves["w"])


def test_mttdl_measured_reduces_to_closed_form_and_is_monotone():
    closed = mttdl.mttdl_vilamb(1e9, 12.0, 5)
    zero_lat = mttdl.mttdl_measured(1e9, 12.0, 5, 1000, 0.0)
    assert zero_lat == pytest.approx(closed, rel=1e-12)
    lats = [mttdl.mttdl_measured(1e9, 12.0, 5, 1000, L)
            for L in (0.0, 1.0, 1e3, 1e6)]
    assert all(a >= b for a, b in zip(lats, lats[1:]))
    assert mttdl.mttdl_measured(1e9, 0.0, 5, 1000, 0.0) == float("inf")
    assert mttdl.detection_latency_stats([]) == {"n": 0, "mean_s": 0.0, "max_s": 0.0}
    st = mttdl.detection_latency_stats([2, None, 4], step_seconds=0.5)
    assert st == {"n": 2, "mean_s": 1.5, "max_s": 2.0}


def test_phase_hooks_fire_and_remove():
    store, leaves, red = _clean_state()
    seen = []
    hook = lambda phase, info: seen.append(phase)
    store.add_phase_hook(hook)
    red = store.on_write(red, events={"w": ALL})
    red, _ = store.tick(leaves, red, 2)
    red = store.flush(leaves, red, step=2)
    assert "on_write" in seen and "flush" in seen
    assert "dispatch" in seen or "blocking_update" in seen
    store.remove_phase_hook(hook)
    n = len(seen)
    store.tick(leaves, red, 4)
    assert len(seen) == n


def test_phase_hooks_skip_under_compile():
    """A hook never fires inside a compiled step (host level only): the
    port's counterpart of the reference's jit-trace guard."""
    store, leaves, red = _clean_state()

    def boom(phase, info):
        raise AssertionError(f"hook fired under compile: {phase}")

    store.add_phase_hook(boom)

    def step(dirty):
        r = dict(red, w=dataclasses.replace(red["w"], dirty=dirty))
        return store.on_write(r, events={"w": ALL})["w"].dirty

    dirty = torch.compile(step, backend="eager", fullgraph=True)(red["w"].dirty)
    store.remove_phase_hook(boom)
    assert int(dirty.count_nonzero()) > 0


# ------------------------------------------------------------ the battery
def test_battery_cli_passes(capsys):
    """``python -m repro_torch.faults --smoke --device cpu``: passes 1-5
    pass, the sharded pass's shard rebuild included (held against the
    reference's line in ``test_battery_sharded_pass_prints_reference_lines``)."""
    assert cli.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "26 crash points, outcomes={'recovered_bitwise': 26}" in out
    assert out.count("  oracle seed=") == 3 and "FAIL" not in out
    assert out.count("patrol seed=") == 1
    assert "Queue 1 item" not in out and "not ported" not in out
    assert out.count("sharded shard-loss rebuild seed=0: status=RebuildStatus(") == 1
    assert out.count("sharded crash @") == 7 and "sharded oracle seed=0" in out
    assert "fault battery OK" in out


@pytest.mark.parametrize("seed", [0, 1])
def test_battery_patrol_pass_equals_reference(capsys, monkeypatch, seed):
    """Pass 4 on the CPU gives the reference's outcome: detected, the same
    latency in ticks, repaired, clean and bitwise.  The reference's probe
    and update readiness is pinned to "ready" (its CPU arrays report it as
    the runtime gets to them, so a loaded host lands a probe a tick later;
    the port's CPU dispatch runs to completion)."""
    from repro.core import store as jstore_mod
    from repro.faults.__main__ import patrol_pass as jpatrol_pass
    from repro.scrub import patrol as jpatrol
    monkeypatch.setattr(jpatrol, "_ready", lambda x: True)
    monkeypatch.setattr(jstore_mod, "_ready", lambda x: True)
    assert cli.patrol_pass(torch.device("cpu"), seed, 6) == 0
    got = capsys.readouterr().out
    assert jpatrol_pass(seed, 6) == 0
    want = capsys.readouterr().out
    assert got == want and "OK" in got, (got, want)


@pytest.mark.parametrize("flag", ["--chaos", "--chaos-child", "--sharded-child"])
def test_battery_cli_refuses_what_is_not_ported(flag, capsys, monkeypatch):
    """Every pass of the reference's CLI is ported, so nothing is refused
    any more: ``--sharded-child`` runs the sharded battery alone, and
    ``--chaos`` / ``--chaos-child`` (the chaos soak, ROADMAP.md item 11.5
    (c)) run the sharded soak on the CPU and pass.  The soak's schedule is
    cut to two entries here (tests/test_torch_chaos.py runs the whole one
    through the CLI); ``--chaos`` alone prints the header and the footer."""
    if flag == "--sharded-child":
        assert cli.main([flag, "--seeds", "0", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "sharded oracle seed=0" in out and "FAIL" not in out
        assert "fault battery" not in out
        return
    from repro_torch.faults import chaos
    short = chaos.ChaosSchedule([chaos.StormPhase("traffic", steps=5),
                                 chaos.StormPhase("drain")], seed=0)
    monkeypatch.setattr(chaos.ChaosSchedule, "default",
                        classmethod(lambda cls, seed=0, **kw: short))
    assert cli.main([flag, "--smoke", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    soak = [ln for ln in lines if ln.startswith("  chaos soak: ")]
    assert len(soak) == 1 and soak[0].startswith("  chaos soak: seed=0 ticks=6 phases=2 ")
    assert soak[0].endswith(" OK") and "reads=2(typed=0 stale=0)" in soak[0]
    header = [ln for ln in lines if ln.startswith("== chaos soak")]
    assert len(header) == (2 if flag == "--chaos" else 0), lines
    assert "fault battery" not in "".join(lines)


# ------------------------------------------------- mesh-sharded coverage
# The reference runs once, in one 8-device subprocess (tests/_torch_sharded.py);
# the port's store runs on a simulated (2, 2, 2) mesh on the CPU.
SHARDED_REFERENCE = """
from repro.faults import (CrashPlan, CrashPointMachine, FaultInjector, FaultSpec,
                          check_detection, vulnerability_window)
import repro.faults.__main__ as jcli
import contextlib, io, dataclasses, tempfile
lv0 = make_leaves()
OUT["leaf/w"] = np.asarray(lv0["w"])
OUT["leaf/e"] = np.asarray(lv0["e"]).view(np.uint16)

def specs_rows(specs):
    return np.asarray([[s.block, s.lane, s.bit, s.payload,
                        ["data_bitflip", "stale_redundancy"].index(s.kind),
                        ["e", "w"].index(s.leaf)] for s in specs], np.int64)

# tests/test_faults.py:346's workload.
store = mesh_store(async_tick=True, precompile=False)
lv, red = drive(store, steps=6, seed=1)
rec("f/red", red)
inj = FaultInjector(store, seed=1)
specs = inj.plan_clean_blocks(red, n=6, kinds=("data_bitflip", "stale_redundancy"))
OUT["f/specs"] = specs_rows(specs)
window = vulnerability_window(store, red)
for k, m in window.blocks.items():
    OUT[f"f/window/{k}"] = m
lv2, red2 = inj.inject_many(lv, red, specs)
OUT["f/lv2/w"] = np.asarray(lv2["w"])
OUT["f/lv2/e"] = np.asarray(lv2["e"]).view(np.uint16)
rep = check_detection(store, lv2, red2, specs, window=window)
for k, v in rep.detected.items():
    OUT[f"f/detected/{k}"] = np.asarray(sorted(v), np.int64)
OUT["f/summary"] = np.asarray(rep.summary())
mm = store.scrub(lv2, red2)
repaired, fixed, lost = store.repair(lv2, red2, mm)
OUT["f/fixed_lost"] = np.asarray([fixed, lost])
nb = store.protected_metas["w"].n_blocks
_, red3 = store.inject(lv, red, FaultSpec(kind="meta_bitflip", leaf="w",
                                          block=5 * nb + 2, bit=7))
rec("f/red3", red3)
ok = store.verify_meta(red3)
OUT["f/meta_ok"] = np.asarray([bool(ok["w"]), bool(ok["e"])])

# tests/test_faults.py:388's machine: its fired crash points.
def make_store():
    return mesh_store(async_tick=True, precompile=False, max_vulnerable_steps=3)
with tempfile.TemporaryDirectory() as tmp:
    machine = CrashPointMachine(make_store, lambda: put(make_leaves()), tmp,
                                seed=0, steps=7, scrub_every=5,
                                hold_inflight_steps=(3, 4))
    OUT["c/fired"] = np.asarray([f"{p}#{o}" for p, o in machine.enumerate_phases()])

# The CLI's sharded pass: the reference's sharded_child, its printed oracle
# and shard-rebuild lines and its crash workload's fired points (the
# replays are the reference's own tests' business).
fired = []
class Enumerate(jcli.CrashPointMachine):
    def enumerate_phases(self):
        fired.extend(super().enumerate_phases())
        return []
jcli.CrashPointMachine = Enumerate
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert jcli.sharded_child(0, 6) == 0
OUT["cli/out"] = np.asarray(buf.getvalue())
OUT["cli/fired"] = np.asarray([f"{p}#{o}" for p, o in fired])
"""


@pytest.fixture(scope="module")
def sharded_ref(tmp_path_factory):
    from _torch_sharded import run_reference
    return run_reference(SHARDED_REFERENCE,
                         tmp_path_factory.mktemp("sharded_faults") / "ref.npz")


def _sharded_leaves(ref):
    from _torch_sharded import leaf_from_ref
    return {"w": leaf_from_ref(ref, "leaf/w", torch.float32),
            "e": leaf_from_ref(ref, "leaf/e", torch.bfloat16)}


def _sharded_store(ref, **kw):
    from _torch_sharded import SPECS, mesh
    pol = RedundancyPolicy.single("vilamb", period_steps=2, lanes_per_block=128,
                                  work_queue_frac=0.5, precompile=False, **kw)
    return ProtectedStore(pol, mesh=mesh()).attach(_sharded_leaves(ref), specs=SPECS)


def _sharded_drive(ref, store, steps, seed):
    """MESH_PRELUDE's ``drive`` on the port."""
    rng = np.random.default_rng(seed)
    lv = _sharded_leaves(ref)
    red = store.init(lv)
    for step in range(1, steps + 1):
        rows = rng.choice(64, size=int(rng.integers(1, 4)), replace=False)
        idx = torch.as_tensor(np.sort(rows))
        w = lv["w"].clone()
        w[idx] += 0.25 * step
        lv = dict(lv, w=w)
        red = store.on_write(red, events={
            "w": torch.zeros((64,), dtype=torch.bool).index_fill_(0, idx, True)})
        store.sync_inflight()
        red, _ = store.tick(lv, red, step)
    return lv, red


def test_sharded_faults_inject_global_geometry_detect_per_shard(sharded_ref):
    """tests/test_faults.py:346 on the port, held to the reference's run:
    the same clean-block plan over global geometry (several shards hit),
    the same corrupted leaves, detections, window and repair counts;
    repair rebuilds bit for bit; a meta flip on shard 5 trips "w" only."""
    from _torch_sharded import assert_fields_equal, u32
    ref = sharded_ref
    store = _sharded_store(ref, async_tick=True)
    lv, red = _sharded_drive(ref, store, 6, 1)
    assert_fields_equal(ref, "f/red", red)
    assert store.shard_factor("w") == 8 and store.shard_factor("e") == 4
    inj = FaultInjector(store, seed=1)
    specs = inj.plan_clean_blocks(red, n=6, kinds=("data_bitflip", "stale_redundancy"))
    rows = [[s.block, s.lane, s.bit, s.payload,
             ["data_bitflip", "stale_redundancy"].index(s.kind), ["e", "w"].index(s.leaf)]
            for s in specs]
    assert rows == ref["f/specs"].tolist()
    nb = store.protected_metas["w"].n_blocks
    assert len({s.block // nb for s in specs if s.leaf == "w"}) > 1
    window = vulnerability_window(store, red)
    for k, m in window.blocks.items():
        np.testing.assert_array_equal(m, ref[f"f/window/{k}"], err_msg=k)
    lv2, red2 = inj.inject_many(lv, red, specs)
    np.testing.assert_array_equal(u32(lv2["w"]), ref["f/lv2/w"].view(np.uint32))
    np.testing.assert_array_equal(lv2["e"].view(torch.int16).numpy().view(np.uint16),
                                  ref["f/lv2/e"])
    rep = check_detection(store, lv2, red2, specs, window=window)
    assert rep.ok and rep.summary() == str(ref["f/summary"]), rep.summary()
    for k, v in rep.detected.items():
        assert sorted(v) == ref[f"f/detected/{k}"].tolist(), k
    for s in specs:
        assert all(b in rep.detected[s.leaf] for b in s.touched_blocks), s
    lv2 = {k: v.clone() for k, v in lv2.items()}
    mm = store.scrub(lv2, red2)
    repaired, fixed, lost = store.repair(lv2, red2, mm)
    assert [fixed, lost] == ref["f/fixed_lost"].tolist() and lost == 0
    for k in lv:
        assert torch.equal(repaired[k].view(torch.uint8), lv[k].view(torch.uint8)), k
    _, red3 = store.inject(lv, red, FaultSpec(kind="meta_bitflip", leaf="w",
                                              block=5 * nb + 2, bit=7))
    assert_fields_equal(ref, "f/red3", red3)
    ok = store.verify_meta(red3)
    assert [bool(ok["w"]), bool(ok["e"])] == ref["f/meta_ok"].tolist() == [False, True]


def test_sharded_crash_points_recover_bitwise(sharded_ref, tmp_path):
    """tests/test_faults.py:388 on the port: the reference's fired crash
    points; dying at dispatch, mid-flight coalesce, adoption, forced
    resolve and flush restores bit for bit on a fresh store; a persisted
    corruption of a clean block on a non-zero shard is parity-repaired."""
    ref = sharded_ref

    def make_store():
        return _sharded_store(ref, async_tick=True, max_vulnerable_steps=3)
    machine = CrashPointMachine(make_store, lambda: _sharded_leaves(ref), str(tmp_path),
                                seed=0, steps=7, scrub_every=5, hold_inflight_steps=(3, 4))
    fired = machine.enumerate_phases()
    assert [f"{p}#{o}" for p, o in fired] == ref["c/fired"].tolist()
    plans = []
    for ph in ("dispatch", "coalesce", "adopt", "adopt_forced", "flush"):
        occ = [o for p, o in fired if p == ph]
        assert occ, ph
        plans.append(CrashPlan(ph, occ[-1]))
    for plan in plans:
        out = machine.run_crash(plan)
        assert out.classification == "recovered_bitwise", (plan, out.classification)
    probe = machine.run_crash(plans[0])
    meta = machine._probe().protected_metas["w"]
    k = machine._probe().shard_factor("w")
    win = probe.window.get("w", set())

    def stripe(b):
        return b // meta.n_blocks, (b % meta.n_blocks) // meta.stripe_data_blocks
    clean = [b for b in range(meta.n_blocks, meta.n_blocks * k)
             if b not in win and not any(stripe(b) == stripe(v) for v in win)]
    out = machine.run_crash(plans[0], faults=(
        FaultSpec(kind="data_bitflip", leaf="w", block=clean[0], lane=3, bit=7),))
    assert out.classification == "recovered_bitwise", out.classification


def test_battery_sharded_pass_prints_reference_lines(sharded_ref, capsys):
    """The CLI's sharded pass prints the reference's ``sharded_child``
    lines: its oracle line, one crash line for each point the reference
    would replay (all recovered bit for bit), and the shard-rebuild case's
    line (its ``RebuildStatus``, clean, bitwise, OK)."""
    ref = sharded_ref
    assert cli.sharded_child(torch.device("cpu"), 0, 6) == 0
    got = capsys.readouterr().out.splitlines()
    want = str(ref["cli/out"]).splitlines()
    assert len(want) == 2 and got[0] == want[0], (got, want)
    fired = [tuple(x.rsplit("#", 1)) for x in ref["cli/fired"].tolist()]
    labels = []
    for ph in ("dispatch", "coalesce", "adopt", "adopt_forced",
               "dispatcher_enqueue", "dispatcher_join", "flush"):
        occ = [o for p, o in fired if p == ph]
        if occ:
            labels.append(f"  sharded crash @{ph}#{occ[-1]}: recovered_bitwise OK")
    assert got[1:-1] == labels
    assert got[-1] == want[-1] and want[-1].endswith(" OK"), (got[-1], want[-1])
