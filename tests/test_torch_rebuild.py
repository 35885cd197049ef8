"""The port's cross-shard parity and online shard rebuild against the
reference's, on the CPU.

The reference runs once, in one 8-device subprocess
(``tests/_torch_sharded.py``'s ``run_reference`` and ``FAST_MARK``), with
its probe and update readiness pinned to "ready" and its dispatcher thread
off (the port's CPU dispatch runs to completion, so both land a probe at
the next tick).  The port runs the same seeded numpy leaves and writes
in-process on a simulated (2, 2, 2) mesh.  Compared, bit for bit
(tolerance 0, all bit patterns): the probe's ``mism``, ``clean`` and slab
at several window starts, the clamped last window and one past the end
included, over a row-range and a strided (KV-cache) spec; ``xpar`` and
``xvalid`` after the first tick's fold and after every tick; every tick's
report (leaves patrolled, mismatches, repaired leaves, ``RebuildStatus``,
the ``UnrecoverableBlock`` records, the health report's
``rebuild_active``); the fired phases with ``rebuild_paste``; the leaf and
every redundancy field after ``flush``.  Scenarios: the twins of
tests/test_scrub.py's three sharded tests (a declared loss rebuilt while
the foreground writes into the lost shard; writes in flight at the loss
reported lost; a late probe that must not re-validate written rows), a
loss the probe finds by itself with a second declaration refused, and a
paced rebuild drained by ``settle``.  One port-only case holds a write
sample unlanded (a stand-in event) while a rebuild starts: the start
applies it first, as the reference's blocking sample always is.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_sharded import assert_fields_equal, mesh, run_reference, u32
from repro_torch.core import ProtectedStore, RedundancyPolicy
from repro_torch.dist import P
from repro_torch.faults import FaultSpec
from repro_torch.scrub import ShardLossConflictError

W_SPEC = P(("pod", "data", "model"), None)
KV_SHAPE = (4, 16, 8, 8, 64)
KV_SPEC = P(None, None, ("pod", "data"), "model", None)
LOST, ROWS_LOCAL = 3, 64 // 8
PROBE_STARTS = (0, 50, 96, 110)        # 96: the clamped last window; 110: past nb

# Shared by both sides: one JSON-able record a tick.
SUMMARY = '''
def tick_summary(rep, pat):
    st = rep.rebuild
    xp = pat.xpar.get("w")
    return {"patrolled": list(rep.patrolled), "mm": int(rep.patrol_mismatches),
            "repaired": sorted(rep.repaired), "updated": list(rep.updated),
            "unrec": [[u.leaf, int(u.stripe), [int(b) for b in u.blocks], u.reason]
                      for u in rep.unrecoverable],
            "rebuild": None if st is None else list(dataclasses.astuple(st)),
            "active": None if rep.health is None else bool(rep.health.rebuild_active),
            "starved": int(rep.patrol_starved_ticks),
            "xvalid": None if xp is None else int(xp.xvalid.sum()),
            "pending": [[n, int(s)] for n, s, _ in pat._pending_loss],
            "rebuilding": None if pat.rebuild is None else [pat.rebuild.name,
                                                             pat.rebuild.shard]}
'''
exec(SUMMARY)

REFERENCE = """
import dataclasses, json
from repro.core import store as jstore_mod
from repro.faults.inject import FaultSpec
from repro.scrub import ShardLossConflictError
from repro.scrub import patrol as jpatrol

class Slow:                            # pins a probe in flight (scenario C)
    def __init__(self, a, gate): self.a, self.gate = a, gate
    def is_ready(self): return self.gate[0] <= 0
    def __array__(self, *a, **k): return np.asarray(self.a)

def ready(x):
    return x.is_ready() if isinstance(x, Slow) else True
jpatrol._ready = ready
jstore_mod._ready = ready
""" + SUMMARY + """
W_SPEC = P(("pod", "data", "model"), None)
KV_SPEC = P(None, None, ("pod", "data"), "model", None)

def make(health=False, **kw):
    pol = RedundancyPolicy.single(
        "vilamb", period_steps=2, lanes_per_block=128, async_tick=True,
        patrol_bytes_per_tick=32 * 128 * 4, precompile=False,
        dispatcher_thread=False, health=health or None, **kw)
    lv = {"w": jax.device_put(jnp.asarray(IN["w"]), NamedSharding(MESH, W_SPEC))}
    store = ProtectedStore(pol, mesh=MESH).attach(lv, specs={"w": W_SPEC})
    phases = []
    def hook(ph, info):
        if ph in ("rebuild_paste", "flush", "settle", "dispatch", "adopt"):
            phases.append([ph, info.get("step"), list(info.get("window", ()))])
    store.add_phase_hook(hook)
    return store, lv, store.init(lv), phases

def rec_x(prefix, pat):
    xp = pat.xpar["w"]
    OUT[prefix + "/xvalid"] = xp.xvalid.copy()        # updated in place later
    OUT[prefix + "/xpar"] = np.asarray(xp.xpar)

def tick(store, lv, red, step, log, prefix):
    red, rep = store.tick(lv, red, step, scrub_period=0)
    if rep.repaired:
        lv = dict(lv, **rep.repaired)
    log.append(tick_summary(rep, store.patroller))
    rec_x(f"{prefix}/t{len(log) - 1}", store.patroller)
    return lv, red, rep

def cover(store, lv, red, step, log, prefix):
    for _ in range(48):
        lv, red, _ = tick(store, lv, red, step, log, prefix); step += 1
        if bool(store.patroller.xpar["w"].xvalid.all()):
            break
    assert bool(store.patroller.xpar["w"].xvalid.all())
    return lv, red, step

def write(store, lv, red, rows, val):
    idx = jnp.asarray(rows)
    lv = dict(lv, w=lv["w"].at[idx].set(val))
    return lv, store.on_write(red, events={"w": jnp.zeros((64,), bool).at[idx].set(True)})

def finish(store, lv, red, step, prefix, log, phases):
    red = store.flush(lv, red, step)
    OUT[prefix + "/scrub"] = np.asarray(store.scrub_check(lv, red))
    OUT[prefix + "/leaf"] = np.asarray(lv["w"])
    rec(prefix + "/flush", red)
    OUT[prefix + "/log"] = np.asarray(json.dumps(log))
    OUT[prefix + "/phases"] = np.asarray(json.dumps(phases))
    OUT[prefix + "/unrec"] = np.asarray(json.dumps(
        [[u.leaf, int(u.stripe), [int(b) for b in u.blocks], u.reason]
         for u in store.patroller.unrecoverable]))

# -- the probe, row-range and strided, with and without the slab --
store, lv, red, _ = make()
w2 = jax.device_put(jnp.asarray(IN["w2"]), NamedSharding(MESH, W_SPEC))
red = store.on_write(red, events={"w": jnp.zeros((64,), bool).at[jnp.asarray([3, 40])].set(True)})
eng = store.engine_for("w")
fn = jax.jit(eng.verify_window_fn("w", 32, want_slab=True))
for s in PROBE_STARTS:
    for i, a in enumerate(fn(w2, red["w"], jnp.int32(s))):
        OUT[f"probe/w/{s}/{i}"] = np.asarray(a)
kv_pol = RedundancyPolicy.single("vilamb", lanes_per_block=128, precompile=False,
                                 dispatcher_thread=False)
kv = jax.device_put(jnp.asarray(IN["kv"]).view(jnp.bfloat16), NamedSharding(MESH, KV_SPEC))
kv2 = jax.device_put(jnp.asarray(IN["kv2"]).view(jnp.bfloat16), NamedSharding(MESH, KV_SPEC))
kstore = ProtectedStore(kv_pol, mesh=MESH).attach({"kv": kv}, specs={"kv": KV_SPEC})
kred = kstore.init({"kv": kv})
kfn = jax.jit(kstore.engine_for("kv").verify_window_fn("kv", 32, want_slab=True))
for s in PROBE_STARTS:
    for i, a in enumerate(kfn(kv2, kred["kv"], jnp.int32(s))):
        OUT[f"probe/kv/{s}/{i}"] = np.asarray(a)

# -- A: a declared loss rebuilt while the foreground writes into the lost
# shard; then a loss the probe finds itself, and a second one refused --
store, lv, red, phases = make()
pat, log, step = store.patroller, [], 0
lv, red, step = cover(store, lv, red, step, log, "A")
lv, red = store.inject(lv, red, FaultSpec(kind="shard_loss", leaf="w", block=LOST))
pat._attempts[("w", 5)] = 99
store.declare_shard_lost("w", LOST, red)
rows = np.arange(LOST * ROWS_LOCAL, LOST * ROWS_LOCAL + 2)
for i in range(24):
    lv, red = write(store, lv, red, rows, float(i + 1))
    lv, red, rep = tick(store, lv, red, step, log, "A"); step += 1
    if rep.rebuild is not None and rep.rebuild.done:
        break
OUT["A/attempts"] = np.asarray(json.dumps(sorted([list(k) for k in pat._attempts])))
red = store.flush(lv, red, step)
lv, red, step = cover(store, lv, red, step, log, "A")
lv, red = store.inject(lv, red, FaultSpec(kind="shard_loss", leaf="w", block=2))
for _ in range(48):
    lv, red, rep = tick(store, lv, red, step, log, "A"); step += 1
    if rep.rebuild is not None and rep.rebuild.done:
        break
finish(store, lv, red, step, "A", log, phases)

# -- B: writes in flight at the loss are reported lost --
store, lv, red, phases = make()
pat, log, step = store.patroller, [], 0
lv, red, step = cover(store, lv, red, step, log, "B")
lv, red = write(store, lv, red, np.arange(LOST * ROWS_LOCAL, LOST * ROWS_LOCAL + 2), 7.0)
lv, red = store.inject(lv, red, FaultSpec(kind="shard_loss", leaf="w", block=LOST))
store.declare_shard_lost("w", LOST, red)
for _ in range(24):
    lv, red, rep = tick(store, lv, red, step, log, "B"); step += 1
    if rep.rebuild is not None and rep.rebuild.done:
        break
finish(store, lv, red, step, "B", log, phases)

# -- C: a late probe must not re-validate rows written after it left --
store, lv, red, phases = make()
pat, log = store.patroller, []
lv, red, _ = tick(store, lv, red, 0, log, "C")
gate = [1]
nm, st, wdw, mi, cl, xw, sp = pat._probe
pat._probe = (nm, st, wdw, Slow(mi, gate), Slow(cl, gate), xw, sp)
lv = dict(lv, w=lv["w"].at[0:1].add(1.0))
red = store.on_write(red, events={"w": jnp.zeros((64,), bool).at[0].set(True)})
lv, red, _ = tick(store, lv, red, 1, log, "C")
gate[0] = 0
lv, red, _ = tick(store, lv, red, 2, log, "C")
finish(store, lv, red, 3, "C", log, phases)

# -- E: a paced rebuild (4 windows), its health report, drained by settle --
store, lv, red, phases = make(health=True, rebuild_bytes_per_tick=32 * 128 * 4)
pat, log, step = store.patroller, [], 0
lv, red, step = cover(store, lv, red, step, log, "E")
lv, red = store.inject(lv, red, FaultSpec(kind="shard_loss", leaf="w", block=5))
store.declare_shard_lost("w", 5, red)
conflict = 0
for _ in range(2):
    lv, red = write(store, lv, red, np.asarray([5 * ROWS_LOCAL + 7]), 3.0)
    lv, red, _ = tick(store, lv, red, step, log, "E"); step += 1
    if not conflict:
        try:
            store.declare_shard_lost("w", 6, red)
        except ShardLossConflictError as e:
            conflict = [e.active_shard, e.new_shard]
OUT["E/conflict"] = np.asarray(conflict)
red = store.settle(red, lv)
drained = store.take_repaired()
OUT["E/drained"] = np.asarray(sorted(drained))
lv = dict(lv, **drained)
rec("E/settle", red)
OUT["E/after"] = np.asarray(json.dumps([pat.rebuild is None, len(pat.unrecoverable)]))
finish(store, lv, red, step, "E", log, phases)
"""


def _inputs():
    rng = np.random.default_rng(25)
    w = rng.standard_normal((64, 2048)).astype(np.float32)
    w2 = w.copy()
    w2[10, 100:300] += 1.0                     # shard 1's blocks 4-5 now mismatch
    w2[60, :] = -w2[60, :]                     # shard 7's last blocks
    kv = rng.standard_normal(KV_SHAPE).astype(np.float32).view(np.uint32)
    kv = (kv >> 16).astype(np.uint16)          # bf16 bits
    kv2 = kv.copy()
    kv2[1, 3, 5, 2, :] ^= 0x0100               # a strided shard's rows change
    kv2[3, 15, 7, 7, 63] ^= 0x0001             # the last element of the last shard
    return {"w": w, "w2": w2, "kv": kv, "kv2": kv2}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    body = f"PROBE_STARTS = {PROBE_STARTS!r}\nLOST, ROWS_LOCAL = {LOST}, {ROWS_LOCAL}\n" + REFERENCE
    return run_reference(body, tmp_path_factory.mktemp("rebuild") / "ref.npz",
                         inputs=_inputs())


# ------------------------------------------------------------------ port side
def _make(health=False, **kw):
    pol = RedundancyPolicy.single(
        "vilamb", period_steps=2, lanes_per_block=128, async_tick=True,
        patrol_bytes_per_tick=32 * 128 * 4, precompile=False,
        health=health or None, **kw)
    lv = {"w": torch.from_numpy(_inputs()["w"])}
    store = ProtectedStore(pol, mesh=mesh()).attach(lv, specs={"w": W_SPEC})
    phases = []

    def hook(ph, info):
        if ph in ("rebuild_paste", "flush", "settle", "dispatch", "adopt"):
            phases.append([ph, info.get("step"), list(info.get("window", ()))])
    store.add_phase_hook(hook)
    return store, lv, store.init(lv), phases


def _check_x(ref, prefix, pat):
    xp = pat.xpar["w"]
    np.testing.assert_array_equal(xp.xvalid, ref[prefix + "/xvalid"], err_msg=prefix)
    np.testing.assert_array_equal(u32(xp.xpar), ref[prefix + "/xpar"].astype(np.uint32),
                                  err_msg=prefix)


class _Run:
    """The port's side of one scenario, checked against the reference's
    records tick by tick."""

    def __init__(self, ref, prefix, **kw):
        self.ref, self.prefix = ref, prefix
        self.store, self.lv, self.red, self.phases = _make(**kw)
        self.pat, self.log, self.step = self.store.patroller, [], 0
        self.want = json.loads(str(ref[prefix + "/log"]))

    def tick(self, step=None):
        step = self.step if step is None else step
        self.red, rep = self.store.tick(self.lv, self.red, step, scrub_period=0)
        if rep.repaired:
            self.lv = dict(self.lv, **rep.repaired)
        i = len(self.log)
        self.log.append(tick_summary(rep, self.pat))
        assert self.log[-1] == self.want[i], (self.prefix, i, self.log[-1], self.want[i])
        _check_x(self.ref, f"{self.prefix}/t{i}", self.pat)
        self.step = step + 1
        return rep

    def cover(self):
        for _ in range(48):
            self.tick()
            if bool(self.pat.xpar["w"].xvalid.all()):
                return
        raise AssertionError("xpar never covered the leaf")

    def write(self, rows, val):
        idx = torch.as_tensor(rows)
        w = self.lv["w"].clone()
        w[idx] = val
        self.lv = dict(self.lv, w=w)
        ev = torch.zeros((64,), dtype=torch.bool).index_fill_(0, idx, True)
        self.red = self.store.on_write(self.red, events={"w": ev})

    def inject_loss(self, shard):
        self.lv, self.red = self.store.inject(
            self.lv, self.red, FaultSpec(kind="shard_loss", leaf="w", block=shard))

    def finish(self):
        ref, p, store = self.ref, self.prefix, self.store
        self.red = store.flush(self.lv, self.red, self.step)
        assert store.scrub_check(self.lv, self.red) == int(ref[p + "/scrub"]) == 0
        np.testing.assert_array_equal(u32(self.lv["w"]), ref[p + "/leaf"].view(np.uint32))
        assert_fields_equal(ref, p + "/flush", self.red)
        assert self.log == self.want
        assert self.phases == json.loads(str(ref[p + "/phases"]))
        got = [[u.leaf, int(u.stripe), [int(b) for b in u.blocks], u.reason]
               for u in store.patroller.unrecoverable]
        assert got == json.loads(str(ref[p + "/unrec"]))


# ---------------------------------------------------------------------- tests
@pytest.mark.parametrize("leaf", ["w", "kv"])
def test_probe_window_and_slab_equal_reference(ref, leaf):
    """``verify_window_fn(..., want_slab=True)`` under the mesh: ``mism``,
    ``clean`` and the slab of every shard at windows from the first to one
    past the end, on row-range shards (the window a view of the leaf) and
    on strided KV-cache shards (a copy of the window alone)."""
    inp = _inputs()
    if leaf == "w":
        store, lv, red, _ = _make()
        red = store.on_write(red, events={"w": torch.zeros((64,), dtype=torch.bool)
                                          .index_fill_(0, torch.tensor([3, 40]), True)})
        x, r = torch.from_numpy(inp["w2"]), red["w"]
    else:
        pol = RedundancyPolicy.single("vilamb", lanes_per_block=128, precompile=False)
        kv = torch.from_numpy(inp["kv"].view(np.int16)).view(torch.bfloat16)
        store = ProtectedStore(pol, mesh=mesh()).attach({"kv": kv}, specs={"kv": KV_SPEC})
        x = torch.from_numpy(inp["kv2"].view(np.int16)).view(torch.bfloat16)
        r = store.init({"kv": kv})["kv"]
    fn = store.engine_for(leaf).verify_window_fn(leaf, 32, want_slab=True)
    mism_any = False
    for s in PROBE_STARTS:
        got = fn(x, r, s)
        assert len(got) == 3
        for i, g in enumerate(got):
            want = ref[f"probe/{leaf}/{s}/{i}"]
            g = g.numpy()
            if want.dtype == np.uint32:
                g = g.view(np.uint32)
            assert g.shape == want.shape, (leaf, s, i, g.shape, want.shape)
            np.testing.assert_array_equal(g, want, err_msg=f"{leaf} start={s} out={i}")
        mism_any |= bool(got[0].any())
    assert mism_any, "no window saw the changed blocks"


@pytest.fixture(scope="module")
def scenario_a(ref):
    """Scenario A on the port, checked tick by tick: a declared loss of
    shard 3 rebuilt while rows of it are rewritten every tick, then a loss
    of shard 2 that the probe finds."""
    run = _Run(ref, "A")
    run.cover()
    run.inject_loss(LOST)
    run.pat._attempts[("w", 5)] = 99
    run.store.declare_shard_lost("w", LOST, run.red)
    rows = np.arange(LOST * ROWS_LOCAL, LOST * ROWS_LOCAL + 2)
    first = None
    for i in range(24):
        run.write(rows, float(i + 1))
        rep = run.tick()
        if rep.rebuild is not None and rep.rebuild.done:
            first = rep.rebuild
            break
    attempts = sorted([list(k) for k in run.pat._attempts])
    run.red = run.store.flush(run.lv, run.red, run.step)
    run.cover()
    run.inject_loss(2)
    second = None
    for _ in range(48):
        rep = run.tick()
        if rep.rebuild is not None and rep.rebuild.done:
            second = rep.rebuild
            break
    run.finish()
    return run, first, second, attempts


def test_sharded_shard_loss_rebuild_bitwise_equals_reference(ref, scenario_a):
    """Twin of tests/test_scrub.py::test_sharded_shard_loss_rebuild_bitwise:
    one window a tick (ceil(nb / 128) = 1), nothing lost, every block
    rebuilt or fresh, stale repair attempts dropped, scrub clean and the
    leaf and fields equal to the reference's after flush."""
    run, first, _, attempts = scenario_a
    nb = run.store.metas["w"].n_blocks
    assert first is not None and first.shard == LOST and first.ticks == 1
    assert first.lost == 0 and first.rebuilt + first.fresh == nb and first.fresh > 0
    assert attempts == json.loads(str(ref["A/attempts"])) and ["w", 5] not in attempts


def test_probe_found_loss_rebuilt_like_reference(ref, scenario_a):
    """The undeclared loss of shard 2 is found by a probe (``_detect_loss``:
    the window's mismatches on shard 2 dominate its clean blocks) and
    rebuilt in full, with no per-block detection queued for it."""
    run, _, second, _ = scenario_a
    assert second is not None and second.shard == 2 and second.lost == 0
    assert second.rebuilt == run.store.metas["w"].n_blocks
    assert not run.pat.detections and not run.pat._repair_queue


def test_sharded_preloss_dirty_blocks_reported_lost_equals_reference(ref):
    """Twin of tests/test_scrub.py::test_sharded_preloss_dirty_blocks_reported_lost:
    the blocks of two rows written at the loss are reported ``shard_loss``
    at their global ids, never fresh; the rest rebuilds bitwise."""
    run = _Run(ref, "B")
    run.cover()
    run.write(np.arange(LOST * ROWS_LOCAL, LOST * ROWS_LOCAL + 2), 7.0)
    run.inject_loss(LOST)
    run.store.declare_shard_lost("w", LOST, run.red)
    status = None
    for _ in range(24):
        rep = run.tick()
        if rep.rebuild is not None and rep.rebuild.done:
            status = rep.rebuild
            break
    run.finish()
    nb = run.store.metas["w"].n_blocks
    n_pre = 2 * (nb // ROWS_LOCAL)
    assert (status.lost, status.fresh, status.rebuilt) == (n_pre, 0, nb - n_pre)
    lost_ids = {b for u in run.pat.unrecoverable for b in u.blocks}
    assert lost_ids == {LOST * nb + b for b in range(n_pre)}


def test_sharded_late_probe_cannot_revalidate_written_rows_equals_reference(ref, monkeypatch):
    """Twin of tests/test_scrub.py::test_sharded_late_probe_cannot_revalidate_written_rows:
    a probe held in flight for a tick while row 0 is written lands after
    the write sample, and does not re-validate that row's blocks."""
    gate = [1]

    class Held:                        # the probe's completion event, held
        def query(self):
            return gate[0] <= 0

        def synchronize(self):
            raise AssertionError("the held probe was force-fetched")

    run = _Run(ref, "C")
    run.tick(0)
    nm, st, wdw, masks, _, xwin, sp = run.pat._probe
    assert st == 0
    run.pat._probe = (nm, st, wdw, masks, Held(), xwin, sp)
    w = run.lv["w"].clone()
    w[0:1] += 1.0
    run.lv = dict(run.lv, w=w)
    run.red = run.store.on_write(run.red, events={
        "w": torch.zeros((64,), dtype=torch.bool).index_fill_(0, torch.tensor([0]), True)})
    run.tick(1)
    gate[0] = 0
    run.tick(2)
    xv = run.pat.xpar["w"].xvalid
    assert run.pat._probe is None, "the probe never landed"
    assert not xv[0:16].any() and xv[16:32].all()
    run.step = 3
    run.finish()


def test_paced_rebuild_health_and_settle_drain_equal_reference(ref):
    """A rebuild paced at 32 blocks a tick (4 windows): the health report
    says ``rebuild_active`` while it runs, and declaring shard 6 meanwhile
    raises ``ShardLossConflictError``; ``settle`` with the leaves drains
    the rest (``rebuild_paste`` with no step), ``take_repaired`` hands
    back the caller's own leaf, and everything equals the reference's."""
    run = _Run(ref, "E", health=True, rebuild_bytes_per_tick=32 * 128 * 4)
    run.cover()
    run.inject_loss(5)
    run.store.declare_shard_lost("w", 5, run.red)
    conflict = 0
    for _ in range(2):
        run.write(np.asarray([5 * ROWS_LOCAL + 7]), 3.0)
        run.tick()
        if not conflict:
            with pytest.raises(ShardLossConflictError) as e:
                run.store.declare_shard_lost("w", 6, run.red)
            conflict = [e.value.active_shard, e.value.new_shard]
    assert conflict == [5, 6] == ref["E/conflict"].tolist()
    assert [e["active"] for e in run.log[-2:]] == [True, True]
    leaf = run.lv["w"]
    run.red = run.store.settle(run.red, run.lv)
    drained = run.store.take_repaired()
    assert sorted(drained) == ref["E/drained"].tolist() == ["w"]
    assert drained["w"] is leaf and run.store.take_repaired() == {}
    assert_fields_equal(ref, "E/settle", run.red)
    assert json.loads(str(ref["E/after"])) == [run.pat.rebuild is None,
                                               len(run.pat.unrecoverable)]
    run.finish()


def test_rebuild_start_applies_a_write_sample_not_yet_landed():
    """A rebuild starts only after every write sample is in ``xvalid``,
    landed or not.  Row 8 (shard 1's local blocks 0-15) is written, the
    due update consumes its mark, and that tick's sample is held unlanded
    while the next tick adopts the update: the mark is then gone from
    ``dirty`` and ``shadow`` and only the sample still holds it.  A loss
    of shard 3 declared then finds those 16 xpar rows stale: reported
    lost at their global ids, never pasted as rebuilt; the other 112
    blocks come back bitwise.  (The reference's sample is always applied
    by then: its fetch blocks.)"""
    gate = [1]

    class Held:                        # the sample's completion event, held
        def query(self):
            return gate[0] <= 0

        def synchronize(self):
            gate[0] = 0

    pol = RedundancyPolicy.single(
        "vilamb", period_steps=1, lanes_per_block=128, async_tick=True,
        patrol_bytes_per_tick=32 * 128 * 4, precompile=False)
    lv = {"w": torch.from_numpy(_inputs()["w"])}
    store = ProtectedStore(pol, mesh=mesh()).attach(lv, specs={"w": W_SPEC})
    red, pat = store.init(lv), store.patroller
    red, _ = store.tick(lv, red, 0, scrub_period=0)           # prime: all valid
    assert pat.xpar["w"].xvalid.all()
    before = lv["w"][LOST * ROWS_LOCAL:(LOST + 1) * ROWS_LOCAL].clone()
    w = lv["w"].clone()
    w[ROWS_LOCAL] += 1.0
    lv = dict(lv, w=w)
    ev = torch.zeros((64,), dtype=torch.bool)
    ev[ROWS_LOCAL] = True
    red = store.on_write(red, events={"w": ev})
    red, rep = store.tick(lv, red, 1, scrub_period=0)         # consumes the mark
    assert rep.updated and len(pat._samples) == 1
    _, names, words = pat._samples[0]
    pat._samples[0] = (Held(), names, words)
    red, _ = store.tick(lv, red, 2, scrub_period=0)           # adopts the update
    assert not pat.fetch_live_rows("w", red["w"]).any()
    assert pat.xpar["w"].xvalid.all() and gate[0] == 1
    w = lv["w"].clone()
    w[LOST * ROWS_LOCAL:(LOST + 1) * ROWS_LOCAL].neg_()        # shard 3 scribbled
    lv = dict(lv, w=w)
    store.declare_shard_lost("w", LOST)
    red, rep = store.tick(lv, red, 3, scrub_period=0)
    lv = dict(lv, **rep.repaired)
    nb = store.metas["w"].n_blocks
    assert gate[0] == 0 and len(pat._samples) == 1          # only tick 3's
    st = rep.rebuild
    assert st.done and (st.rebuilt, st.fresh, st.lost) == (nb - 16, 0, 16)
    assert {b for u in rep.unrecoverable for b in u.blocks} == {
        LOST * nb + b for b in range(16)}
    got = lv["w"][LOST * ROWS_LOCAL:(LOST + 1) * ROWS_LOCAL]
    assert torch.equal(got[1:].view(torch.int32), before[1:].view(torch.int32))
    assert torch.equal(got[0], -before[0])                     # lost: left as found
