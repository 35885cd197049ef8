"""The port's scrub patroller against the reference's, on the CPU.

The same seeded numpy leaves, writes and faults go through ``repro.scrub``
on the reference's store and ``repro_torch.scrub`` on the port's: the probe
window's verdicts, every tick's report (leaves patrolled, patrol
mismatches, the starvation streak, updated and deadline-fired groups, the
leaves repaired and the unrecoverable records), the detections with their
latencies, and the leaves and redundancy after ``flush`` are equal, bit for
bit where they are bit patterns.  Probe and update readiness is pinned to
"ready" in the reference (its CPU arrays report readiness as the runtime
gets to them; the port's CPU dispatch runs to completion), so both land a
probe at the next tick.  One case the reference does not test: a settled
checksum flip, which the patroller flags, rebuilds to the same bytes and
re-detects until ``MAX_REPAIR_ATTEMPTS``, then reports as a vulnerable
stripe, in both packages alike.  Then the machine-local tests of
tests/test_scrub.py and the patrol case of tests/test_dispatcher.py,
ported (the sharded ones, cross-shard parity and the shard rebuild, are
held against the reference in tests/test_torch_rebuild.py).
"""
import dataclasses
import math

import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_helpers import assert_red_equal, jnp_leaves
from repro.core import ProtectedStore as JStore
from repro.core import RedundancyPolicy as JPolicy
from repro.core import store as jstore_mod
from repro.faults.inject import FaultSpec as JFaultSpec
from repro.scrub import patrol as jpatrol
from repro_torch.core import ProtectedStore, RedundancyPolicy, convert, mttdl
from repro_torch.core.repairs import UnrecoverableBlock, plan_stripe_repairs
from repro_torch.faults import FaultSpec
from repro_torch.scrub import patrol as patrol_mod

LANES = 128
BPB = LANES * 4                    # bytes per block at 128 uint32 lanes


def _np_w(n_rows=32, cols=512):
    return np.random.default_rng(0).standard_normal((n_rows, cols)).astype(np.float32)


def make_store(n_rows=32, cols=512, patrol_blocks=8, **kw):
    leaves = convert.leaves_from_numpy({"w": _np_w(n_rows, cols)}, "cpu")
    pol = RedundancyPolicy.single(
        "vilamb", period_steps=2, lanes_per_block=LANES,
        patrol_bytes_per_tick=patrol_blocks * BPB, precompile=False, **kw)
    store = ProtectedStore(pol, device="cpu").attach(leaves)
    return store, leaves, store.init(leaves)


def _add_rows(leaves, rows, v=0.5):
    w = leaves["w"].clone()
    w[torch.as_tensor(rows)] += v
    ev = torch.zeros((w.shape[0],), dtype=torch.bool)
    ev[torch.as_tensor(rows)] = True
    return dict(leaves, w=w), ev


def quiet_ticks(store, leaves, red, step, n):
    for _ in range(n):
        red, rep = store.tick(leaves, red, step, scrub_period=0)
        if rep.repaired:
            leaves = dict(leaves, **rep.repaired)
        step += 1
    return leaves, red, step


# ------------------------------------------------- parity with the reference

def _mixed_np_leaves():
    """w fills 37.5 blocks of 128 lanes (its lane view is a padded copy, so
    the last probe window pads a partial block); e (bf16) fills 4 exactly."""
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((24, 200)).astype(np.float32),
            "e": rng.standard_normal((16, 64)).astype(np.float32)
            .astype(ml_dtypes.bfloat16)}


def _policy_kw(**kw):
    return dict(period_steps=2, lanes_per_block=LANES, work_queue_frac=0.5,
                patrol_bytes_per_tick=8 * BPB, precompile=False, **kw)


def _ready_reference(monkeypatch):
    monkeypatch.setattr(jpatrol, "_ready", lambda x: True)
    monkeypatch.setattr(jstore_mod, "_ready", lambda x: True)


def test_verify_window_equals_reference():
    """The probe's (mism, clean) at every window start, over a padded last
    block, dirty and shadow bits and a corrupted block, equal the
    reference's; on a leaf that does not fill its blocks the window's lanes
    are a copy of the window alone."""
    import jax.numpy as jnp
    np_lv = _mixed_np_leaves()
    store = ProtectedStore(RedundancyPolicy.single("vilamb", **_policy_kw()),
                           device="cpu").attach(convert.leaves_from_numpy(np_lv, "cpu"))
    jstore = JStore(JPolicy.single("vilamb", **_policy_kw())).attach(jnp_leaves(np_lv))
    lv = convert.leaves_from_numpy(np_lv, "cpu")
    jlv = jnp_leaves(np_lv)
    red, jred = store.init(lv), jstore.init(jlv)
    spec = dict(kind="data_bitflip", leaf="w", block=37, lane=5, bit=3)
    lv, red = store.inject(lv, red, FaultSpec(**spec))
    jlv, jred = jstore.inject(jlv, jred, JFaultSpec(**spec))
    ev = torch.zeros((24,), dtype=torch.bool)
    ev[[2, 3, 11]] = True
    red = store.on_write(red, events={"w": ev})
    jred = jstore.on_write(jred, events={"w": jnp.asarray(ev.numpy())})
    nb = store.metas["w"].n_blocks
    for w in (1, 5, 8, nb):
        fn = store.engine_for("w").verify_window_fn("w", w)
        jfn = jstore.engine_for("w").verify_window_fn("w", w)
        for start in sorted({0, 3, nb - w, max(0, nb - w - 2)}):
            got = fn(lv["w"], red["w"], start)
            want = jfn(jlv["w"], jred["w"], jnp.int32(start))
            for g, x in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(x),
                                              err_msg=f"w={w} start={start}")
    got = fn(lv["w"], red["w"], nb - 8)[0].numpy()
    assert got[0, 37 - (nb - 8)], "the corrupted block in the padded window"
    # With the slab (the lanes cross-shard parity folds), past the leaf's
    # end too: the reference repeats the last block there.
    for w in (8, nb + 3):
        fn = store.engine_for("w").verify_window_fn("w", w, want_slab=True)
        jfn = jstore.engine_for("w").verify_window_fn("w", w, want_slab=True)
        for start in sorted({0, 5, max(0, nb - 8)}):
            got = fn(lv["w"], red["w"], start)
            want = jfn(jlv["w"], jred["w"], jnp.int32(start))
            assert len(got) == len(want) == 3
            for g, x in zip(got, want):
                np.testing.assert_array_equal(g.numpy().view(np.asarray(x).dtype),
                                              np.asarray(x),
                                              err_msg=f"slab w={w} start={start}")


def _drive_patrol(make, write, inject, spec_cls, steps, faults, rng_seed=3):
    """``steps`` ticks of 1-3 random w-row writes (never rows 20-23, where
    the faults go) plus an e row of 0-7 (blocks 0-1) every third step;
    ``faults`` maps a step
    to the specs injected before its tick.  Returns per-tick records, the
    patroller's observations and the final state (flushed)."""
    store, lv = make()
    red = store.init(lv)
    red = store.flush(lv, red, 0)
    pat = store.patroller
    rng = np.random.default_rng(rng_seed)
    ticks = []
    for step in range(1, steps + 1):
        rows = np.sort(rng.choice(20, size=int(rng.integers(1, 4)), replace=False))
        e_row = int(rng.integers(8)) if step % 3 == 0 else None
        lv, red = write(store, lv, red, rows, e_row)
        for kw in faults.get(step, ()):
            lv, red = inject(store, lv, red, spec_cls(**kw))
            if kw["kind"] == "data_bitflip":
                pat.expect_injection(kw["leaf"], kw["block"], step)
        red, rep = store.tick(lv, red, step, scrub_period=0)
        if rep.repaired:
            lv = dict(lv, **rep.repaired)
        ticks.append({
            "patrolled": rep.patrolled, "mismatches": rep.patrol_mismatches,
            "starved": rep.patrol_starved_ticks, "updated": rep.updated,
            "deadline": rep.deadline_fired, "repaired": sorted(rep.repaired),
            "unrecoverable": [(u.leaf, u.stripe, u.blocks, u.reason)
                              for u in rep.unrecoverable]})
    obs = {"detections": [(d.leaf, d.block, d.step, d.latency_steps)
                          for d in pat.detections],
           "latencies": list(pat.latencies),
           "unrecoverable": [(u.leaf, u.stripe, u.blocks, u.reason)
                             for u in pat.unrecoverable],
           "scanned": pat.blocks_scanned, "cursor": dict(pat.cursor),
           "sweeps": dict(pat.sweeps), "coverage": pat.coverage()}
    red = store.flush(lv, red, steps + 1)
    return ticks, obs, lv, red, store


def _port_side():
    np_lv = _mixed_np_leaves()

    def make(**kw):
        lv = convert.leaves_from_numpy(np_lv, "cpu")
        pol = RedundancyPolicy.single("vilamb", **_policy_kw(**kw))
        return ProtectedStore(pol, device="cpu").attach(lv), lv

    def write(store, lv, red, rows, e_row):
        lv, ev = _add_rows(lv, rows)
        events = {"w": ev}
        if e_row is not None:
            e = lv["e"].clone()
            e[e_row] += 1.0
            lv = dict(lv, e=e)
            events["e"] = torch.zeros((16,), dtype=torch.bool)
            events["e"][e_row] = True
        return lv, store.on_write(red, events=events)

    return make, write, lambda store, lv, red, spec: store.inject(lv, red, spec)


def _reference_side():
    import jax.numpy as jnp
    np_lv = _mixed_np_leaves()

    def make(**kw):
        lv = jnp_leaves(np_lv)
        pol = JPolicy.single("vilamb", dispatcher_thread=False, **_policy_kw(**kw))
        return JStore(pol).attach(lv), lv

    def write(store, lv, red, rows, e_row):
        idx = jnp.asarray(rows)
        lv = dict(lv, w=lv["w"].at[idx].add(0.5))
        events = {"w": jnp.zeros((24,), bool).at[idx].set(True)}
        if e_row is not None:
            lv = dict(lv, e=lv["e"].at[e_row].add(1.0))
            events["e"] = jnp.zeros((16,), bool).at[e_row].set(True)
        return lv, store.on_write(red, events=events)

    return make, write, lambda store, lv, red, spec: store.inject(lv, red, spec)


def _assert_runs_equal(got, want, what):
    ticks, obs, lv, red, _ = got
    jticks, jobs, jlv, jred, _ = want
    for step, (g, w) in enumerate(zip(ticks, jticks), start=1):
        assert g == w, f"{what}: tick {step}"
    assert obs == jobs, what
    for n in lv:
        np.testing.assert_array_equal(
            np.asarray(jlv[n]).view(np.uint8),
            convert.leaves_to_numpy({n: lv[n]})[n].view(np.uint8), err_msg=n)
    assert_red_equal(jred, red, what)


# Faults on rows the writes never touch (w rows 20-23: blocks 31-37, the
# last of them partial), each in a stripe of its own but for the pair in
# stripe 8, which single parity cannot repair.
PATROL_FAULTS = {
    4: (dict(kind="data_bitflip", leaf="w", block=37, lane=7, bit=31),
        dict(kind="data_bitflip", leaf="e", block=2, lane=9, bit=0)),
    9: (dict(kind="data_bitflip", leaf="w", block=32, lane=1, bit=2),
        dict(kind="data_bitflip", leaf="w", block=33, lane=4, bit=5)),
    15: (dict(kind="data_bitflip", leaf="w", block=30, lane=100, bit=17),),
}


@pytest.mark.parametrize("async_tick", [True, False], ids=["overlapped", "blocking"])
def test_patrol_equals_reference(monkeypatch, async_tick):
    """Reports, detections, latencies, repairs, unrecoverable records and
    the flushed state, tick by tick, in both packages."""
    _ready_reference(monkeypatch)
    make, write, inject = _port_side()
    jmake, jwrite, jinject = _reference_side()
    got = _drive_patrol(lambda: make(async_tick=async_tick), write, inject,
                        FaultSpec, 48, PATROL_FAULTS)
    want = _drive_patrol(lambda: jmake(async_tick=async_tick), jwrite, jinject,
                         JFaultSpec, 48, PATROL_FAULTS)
    _assert_runs_equal(got, want, f"async_tick={async_tick}")
    ticks, obs = got[0], got[1]
    assert {d[:2] for d in obs["detections"]} >= {("w", 37), ("e", 2), ("w", 30)}
    assert ("w", 8, (32, 33), "multi_corrupt") in obs["unrecoverable"]
    assert sum(t["mismatches"] for t in ticks) >= 5
    assert len(obs["latencies"]) == 5             # every data flip, the pair too


def test_checksum_bitflip_classified_like_reference(monkeypatch):
    """A settled checksum flip: the probe flags the block, the repair
    rebuilds the same bytes, the next sweep flags it again, and after
    ``MAX_REPAIR_ATTEMPTS`` the stripe is reported as vulnerable — in both
    packages, on the same ticks."""
    _ready_reference(monkeypatch)
    # Injected on an even step: on the overlapped tick the update of the
    # step before has been adopted, so the flip is not dropped at adoption.
    faults = {4: (dict(kind="checksum_bitflip", leaf="w", block=34, bit=11),)}
    make, write, inject = _port_side()
    jmake, jwrite, jinject = _reference_side()
    got = _drive_patrol(make, write, inject, FaultSpec, 90, faults)
    want = _drive_patrol(jmake, jwrite, jinject, JFaultSpec, 90, faults)
    _assert_runs_equal(got, want, "checksum flip")
    ticks, obs = got[0], got[1]
    assert [d[:2] for d in obs["detections"]] == \
        [("w", 34)] * patrol_mod.MAX_REPAIR_ATTEMPTS
    assert obs["unrecoverable"] == [("w", 8, (34,), "vulnerable_stripe")]
    assert sum(t["mismatches"] for t in ticks) == patrol_mod.MAX_REPAIR_ATTEMPTS + 1


def test_declare_shard_lost_machine_local():
    store, _, red = make_store()
    with pytest.raises(ValueError, match="cross-shard parity"):
        store.declare_shard_lost("w", 0, red)
    plain, _, _ = make_store(patrol_blocks=0)
    with pytest.raises(RuntimeError, match="patrol_bytes_per_tick"):
        plain.declare_shard_lost("w", 0)


# ---------------------------------------------------------- machine-local (port)

def test_patroller_gated_on_budget():
    store, _, _ = make_store(patrol_blocks=0)
    assert store.patroller is None
    store, _, _ = make_store(patrol_blocks=8)
    assert store.patroller is not None
    assert store.patroller.window["w"] == 8


def test_patrol_byte_budget_pacing():
    """Each probe covers exactly the byte budget's worth of blocks; the
    per-tick scan never exceeds it and the window caps at the leaf size."""
    store, leaves, red = make_store(patrol_blocks=8)     # nb=128, window=8
    pat = store.patroller
    nb = store.metas["w"].n_blocks
    assert nb == 128 and pat.window["w"] == 8
    T = 24
    leaves, red, _ = quiet_ticks(store, leaves, red, 0, T)
    assert pat.blocks_scanned % 8 == 0
    assert 8 * (T // 2) <= pat.blocks_scanned <= 8 * T
    big, _, _ = make_store(patrol_blocks=10_000)
    assert big.patroller.window["w"] == nb


def test_patrol_full_coverage_within_bound():
    """A full sweep completes within ~2 ticks per window (dispatch + land)."""
    store, leaves, red = make_store(patrol_blocks=8)
    pat = store.patroller
    nb = store.metas["w"].n_blocks
    bound = 2 * math.ceil(nb / 8) + 4
    step = 0
    for _ in range(bound):
        red, _ = store.tick(leaves, red, step, scrub_period=0)
        step += 1
        if pat.sweeps["w"] >= 1:
            break
    assert pat.sweeps["w"] >= 1, (pat.sweeps, pat.cursor, bound)
    assert pat.coverage()["w"] == 1.0


def test_patrol_detects_and_repairs_mid_traffic():
    """A bitflip on a settled block is detected by the patrol while
    foreground writes keep landing, parity-repaired bitwise, and the store
    scrubs clean afterwards."""
    store, leaves, red = make_store(n_rows=32, patrol_blocks=8)
    pat = store.patroller
    rows = np.arange(4)                      # traffic: rows 0..3 only
    step = 0
    for _ in range(6):                       # settle the rest of the heap
        leaves, ev = _add_rows(leaves, rows)
        red = store.on_write(red, events={"w": ev})
        red, _ = store.tick(leaves, red, step, scrub_period=0)
        step += 1
    red = store.flush(leaves, red, step)
    blk = 16 * (512 * 4 // BPB)              # 4 blocks per 512-elem row
    leaves, red = store.inject(leaves, red, FaultSpec(
        kind="data_bitflip", leaf="w", block=blk, lane=3, bit=7))
    pat.expect_injection("w", blk, step)
    detected = repaired = False
    for _ in range(3 * (2 * (128 // 8) + 4)):
        leaves, ev = _add_rows(leaves, rows)
        red = store.on_write(red, events={"w": ev})
        red, rep = store.tick(leaves, red, step, scrub_period=0)
        step += 1
        if rep.repaired:
            leaves = dict(leaves, **rep.repaired)
            repaired = True
        if pat.latencies:
            detected = True
        if detected and repaired:
            break
    assert detected, "patrol never detected the injected bitflip"
    assert repaired, "patrol never repaired the detected block"
    assert pat.latencies[0] <= 2 * (2 * (128 // 8) + 4)
    red = store.flush(leaves, red, step)
    assert store.scrub_check(leaves, red) == 0
    np.testing.assert_array_equal(leaves["w"].numpy()[16], _np_w()[16])


def test_patrol_starvation_floor():
    """Wall-to-wall traffic must not starve the patrol forever: past
    ``patrol_max_starved_ticks`` probe-less ticks one probe dispatches
    anyway; floor 0 disables forcing."""
    for floor, expect_probes in ((0, False), (4, True)):
        leaves = convert.leaves_from_numpy({"w": _np_w()}, "cpu")
        pol = RedundancyPolicy.single(
            "vilamb", period_steps=1, lanes_per_block=LANES,
            patrol_bytes_per_tick=8 * BPB, precompile=False,
            async_tick=False, patrol_max_starved_ticks=floor)
        store = ProtectedStore(pol, device="cpu").attach(leaves)
        red = store.init(leaves)
        pat = store.patroller
        last = 0
        for step in range(1, 31):      # step 0 is never update-due
            leaves, ev = _add_rows(leaves, np.arange(4))
            red = store.on_write(red, events={"w": ev})
            red, rep = store.tick(leaves, red, step, scrub_period=0)
            assert rep.updated, "tick unexpectedly quiet"
            last = rep.patrol_starved_ticks
        if expect_probes:
            assert pat.blocks_scanned >= 8, pat.blocks_scanned
            assert last <= floor, last
        else:
            assert pat.blocks_scanned == 0
            assert last >= 20, last


def test_unrecoverable_reported_structurally():
    """Two corruptions in one stripe defeat single parity: a typed
    UnrecoverableBlock instead of a loop."""
    store, leaves, red = make_store(patrol_blocks=8)
    pat = store.patroller
    red = store.flush(leaves, red, 0)
    for blk in (0, 1):                       # same stripe (stripe size 4+1)
        leaves, red = store.inject(leaves, red, FaultSpec(
            kind="data_bitflip", leaf="w", block=blk, lane=1, bit=2))
    step, found = 1, []
    for _ in range(40):
        red, rep = store.tick(leaves, red, step, scrub_period=0)
        if rep.repaired:
            leaves = dict(leaves, **rep.repaired)
        found.extend(rep.unrecoverable)
        step += 1
        if found:
            break
    assert found, "multi-corrupt stripe never reported"
    rec = found[0]
    assert isinstance(rec, UnrecoverableBlock)
    assert rec.leaf == "w" and rec.reason == "multi_corrupt"
    assert rec.stripe == 0 and set(rec.blocks) == {0, 1}
    assert pat.unrecoverable


def test_plan_stripe_repairs_classifies():
    store, _, _ = make_store()
    metas = {"w": store.metas["w"]}
    singles, unrec = plan_stripe_repairs(metas, {"w": [2, 8, 9]})
    assert singles == [("w", 2)]
    assert len(unrec) == 1 and unrec[0].reason == "multi_corrupt"
    assert set(unrec[0].blocks) == {8, 9}
    mask = np.zeros((store.metas["w"].n_blocks,), bool)
    mask[[2, 8, 9]] = True
    singles2, unrec2 = plan_stripe_repairs(metas, {"w": mask})
    assert singles2 == singles and unrec2[0].blocks == unrec[0].blocks


def _run_patrolled_port(n_rows=256, sweep_ticks=8, scrub_period=240, n_faults=1):
    """``benchmarks.mttdl_bench.run_patrolled``'s schedule on the port's
    store (its Region: 4 KiB rows of zeros, vilamb T=4, the blocking tick,
    4+1 stripes), returning the same rows."""
    from benchmarks.common import (LANES_PER_BLOCK, ROW_ELEMS, STRIPE,
                                   key_stream)
    from benchmarks.mttdl_bench import MTTF_BLOCK_S, ROW_BYTES

    def phase(patrol):
        pol = RedundancyPolicy.single(
            "vilamb", period_steps=4, lanes_per_block=LANES_PER_BLOCK,
            stripe_data_blocks=STRIPE, async_tick=False,
            patrol_bytes_per_tick=(n_rows // sweep_ticks) * ROW_BYTES if patrol else 0)
        heap = torch.zeros((n_rows, ROW_ELEMS), dtype=torch.float32)
        store = ProtectedStore(pol, device="cpu").attach({"heap": heap})
        red = store.init({"heap": heap})
        meta = store.metas["heap"]
        keys = [torch.as_tensor(np.array(k), dtype=torch.int64)
                for k in key_stream("uniform", 9, 32, n_rows)]
        step = 0
        for i in range(8):
            heap = heap.clone()
            heap[keys[i]] = 1.0
            mask = torch.zeros((n_rows,), dtype=torch.bool)
            mask[keys[i]] = True
            red = store.on_write(red, events={"heap": mask})
            red, _ = store.tick({"heap": heap}, red, step, scrub_period=0)
            step += 1
        red = store.flush({"heap": heap}, red, step)
        if patrol:
            for _ in range(2 * sweep_ticks):
                red, _ = store.tick({"heap": heap}, red, step, scrub_period=0)
                step += 1
        latencies, leaves = [], {"heap": heap}
        for i in range(n_faults):
            step = ((step // scrub_period) + 1) * scrub_period + 3
            blk = (i * 37) % meta.n_blocks
            leaves, red = store.inject(leaves, red, FaultSpec(
                kind="data_bitflip", leaf="heap", block=blk, lane=11, bit=5))
            if patrol:
                store.patroller.expect_injection("heap", blk, step)
            inject_step, detected = step, None
            for _ in range(2 * scrub_period):
                red, rep = store.tick(leaves, red, step,
                                      scrub_period=0 if patrol else scrub_period)
                if rep.repaired:
                    leaves = dict(leaves, **rep.repaired)
                if patrol:
                    if len(store.patroller.latencies) > i:
                        detected = step
                elif rep.mismatches:
                    detected = step
                step += 1
                if detected is not None:
                    break
            assert detected is not None
            latencies.append(detected - inject_step)
            if not patrol:
                leaves, _, _ = store.repair(leaves, red, store.scrub(leaves, red))
        stats = mttdl.detection_latency_stats(latencies, step_seconds=1.0)
        return stats, mttdl.mttdl_measured_live(
            MTTF_BLOCK_S, 0.0, STRIPE + 1, meta.n_stripes,
            assumed_latency_seconds=stats["mean_s"], measured=stats)

    with_stats, m_with = phase(True)
    without_stats, m_without = phase(False)
    ratio = m_with / m_without if m_without else float("inf")
    return [
        ("mttdl/patrol/without", 0.0,
         f"MTTDL {m_without:.3g}s at scheduled-scrub latency "
         f"{without_stats['mean_s']:.0f} steps (period {scrub_period})"),
        ("mttdl/patrol/with", 0.0,
         f"MTTDL {m_with:.3g}s at patrol latency {with_stats['mean_s']:.0f} "
         f"steps (sweep {sweep_ticks} ticks)"),
        ("mttdl/patrol/improvement", 0.0,
         f"{ratio:.1f}x measured-MTTDL improvement from the patroller "
         "(acceptance floor: 10x)"),
    ]


def test_patrol_latency_beats_scheduled_scrub_10x(monkeypatch):
    """Measured detection latency (hence measured MTTDL) with the patroller
    is >= 10x better than scheduled-scrub-only detection; the port's rows
    equal the reference's ``run_patrolled`` on the same schedule."""
    from benchmarks.mttdl_bench import run_patrolled
    _ready_reference(monkeypatch)
    got = _run_patrolled_port()
    want = run_patrolled(n_rows=256, sweep_ticks=8, scrub_period=240, n_faults=1)
    assert got == want, (got, want)
    rows = {name: derived for name, _, derived in got}
    ratio = float(rows["mttdl/patrol/improvement"].split("x")[0])
    assert ratio >= 10.0, rows


def test_patrol_probe_forces_fetch_past_stuck_readiness(monkeypatch):
    """A probe whose readiness never flips must not starve the patroller:
    after PROBE_FORCE_TICKS process attempts the fetch is forced (the
    patrol case of tests/test_dispatcher.py)."""
    pol = RedundancyPolicy.single(
        "vilamb", period_steps=2, lanes_per_block=8, async_tick=True,
        patrol_bytes_per_tick=2 * 8 * 4, precompile=False)
    lv = convert.leaves_from_numpy(_mixed_np_leaves(), "cpu")
    store = ProtectedStore(pol, device="cpu").attach(lv)
    red = store.init(lv)
    monkeypatch.setattr(patrol_mod, "_ready", lambda x: False)
    patrolled = 0
    for step in range(1, 4 * patrol_mod.PROBE_FORCE_TICKS + 2):
        red, rep = store.tick(lv, red, step, scrub_period=0)
        patrolled += len(rep.patrolled)
    assert patrolled >= 2, \
        "stuck readiness must force-resolve, not wedge the probe slot"


def test_trainer_run_adopts_patrol_repairs():
    """``Trainer.run`` with a live patroller: a bitflip on embedding rows no
    batch touches (the vocabulary's padding rows, never written by lazy
    AdamW) is found by the patrol between steps, rebuilt from parity, and
    the repaired leaf is what training goes on with; a flushed state
    scrubs clean and the rows are the pre-fault bytes."""
    from repro_torch.configs import get_smoke
    from repro_torch.core import LeafPolicy
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models import Model, ShapeConfig, build_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train import (Trainer, protected_leaves, protected_structs,
                                   replace_protected)
    cfg = get_smoke("llama3.2-3b")
    opt = AdamW(lr=warmup_cosine(3e-3, 5, 100))
    meta_model = Model(cfg, torch.device("meta")).init()
    pol = RedundancyPolicy(
        default=LeafPolicy(mode="none"),
        rules=(("params/embed", LeafPolicy("vilamb", period_steps=2)),),
        lanes_per_block=LANES, patrol_bytes_per_tick=256 * BPB)
    store = ProtectedStore(pol, device="cpu").attach(
        protected_structs(meta_model, opt.init(meta_model)))
    tr = Trainer(model=build_model(cfg, "cpu"), opt=opt, store=store,
                 scrub_period_steps=0)
    data = SyntheticPipeline(cfg, ShapeConfig("t", 32, 2, "train"), seed=0, device="cpu")
    st = tr.run(tr.init_state(torch.Generator().manual_seed(0)), data, 2)
    st = tr.flush(st)
    blk, name = 300, "params/embed"         # rows 1200-1203 >= vocab_size
    assert 4 * blk >= cfg.vocab_size
    before = st.params["embed"][4 * blk:4 * blk + 4].clone()
    lv, red = store.inject(protected_leaves(st.params, st.opt), st.red,
                           FaultSpec(kind="data_bitflip", leaf=name, block=blk,
                                     lane=3, bit=7))
    st = replace_protected(st, lv)
    st = dataclasses.replace(st, red=red)
    store.patroller.expect_injection(name, blk, st.step)
    assert not torch.equal(st.params["embed"][4 * blk:4 * blk + 4], before)
    st = tr.run(st, data, 6)
    pat = store.patroller
    assert [(e.leaf, e.block) for e in pat.detections] == [(name, blk)]
    assert len(pat.latencies) == 1 and not pat.unrecoverable
    assert torch.equal(st.params["embed"][4 * blk:4 * blk + 4], before)
    st = tr.flush(st)
    assert store.scrub_check(protected_leaves(st.params, st.opt), st.red) == 0
