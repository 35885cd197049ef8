"""The port's degraded reads and elastic remesh against the reference's,
on the CPU.

The reference runs once, in one 8-device subprocess
(``tests/_torch_sharded.py``'s ``run_reference`` and ``FAST_MARK``), with
its update readiness pinned to "ready" and its dispatcher thread off (the
port's CPU dispatch runs to completion).  The port runs the same seeded
numpy leaves and writes in-process on simulated meshes.  Compared, bit for
bit (tolerance 0, all bit patterns):

* ``read_verified``'s four machine-local cases (tests/test_remesh.py:114-163:
  clean, reconstructed, in the window, unrecoverable with ``read_timeout``
  records) and the retry sleeps (tests/test_health.py:81);
* grow (1, 2, 2) -> (2, 2, 2) and shrink (2, 2, 2) -> (1, 2, 2) with writes
  racing the migration, as tests/test_remesh.py's: every redundancy field,
  the ``RemeshStatus`` (``overflowed`` included) and the tick's report after
  every tick, and after the flush;
* a shrink whose deadline expires mid-migration under the health governor
  (tests/test_health.py's drain): ``remesh_drain`` and the adoption on that
  tick;
* the ladder of tests/test_remesh.py:280: a degraded read mid-rebuild, a
  remesh queued behind the rebuild, a loss refused while it is queued, the
  settle drain, then the migration and the fresh patroller;
* the crash machine with a remesh queued at step 3: the fired phases equal
  the reference's; the port's sweep through ``remesh_migrate`` recovers
  every crash bitwise and its scribbled variant is ``rejected``.

A KV cache under ``cache_specs`` (split over batch and KV heads) shrunk
while decode-like writes race the migration: the reference's row-range
translation of marks leaves a written block's checksum stale (its scrub
after the flush finds it), and the port's translation through each
block's global position leaves none (ROADMAP Queue 3, difference 6).  The
port's ``Server.generate`` with that remesh in the middle of it gives the
tokens of no store, and after the flush every field equals a fresh store's.
"""
import dataclasses
import json
import math
import time

import numpy as np
import pytest
import torch

from _torch_sharded import assert_fields_equal, run_reference, u32
from repro_torch.common import flatten_dict
from repro_torch.configs import get_smoke
from repro_torch.core import (ProtectedStore, RedundancyPolicy, UnrecoverableReadError)
from repro_torch.core import bits
from repro_torch.core import blocks as B
from repro_torch.dist import P, cache_specs
from repro_torch.faults import FaultSpec
from repro_torch.faults.crashpoints import CrashPlan, CrashPointMachine
from repro_torch.faults.inject import apply_fault
from repro_torch.health import HealthPolicy
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.parallel import ParallelCtx
from repro_torch.remesh import (RemeshGeometryError, RemeshInProgressError, RemeshStatus,
                                translate_marks, translate_marks_global, translate_words)
from repro_torch.scrub import ShardLossConflictError
from repro_torch.serve import Server

AXES = ("pod", "data", "model")
W_SPEC = P(("pod", "data", "model"), None)
KV_SHAPE = (3, 32, 8, 2, 16)                       # llama smoke's (L, S, B, H, hd)
KV_SPEC = P(None, None, ("pod", "data"), "model", None)
STEPS = 40                                         # rows drawn for each scenario

# Shared by both sides: one JSON-able record a tick.
SUMMARY = '''
def tick_summary(rep, store):
    st, h = rep.remesh, rep.health
    return {"remesh": None if st is None else [
                list(st.from_shape), list(st.to_shape), int(st.total_blocks),
                int(st.started_step), int(st.migrated), int(st.xpar_seeded),
                int(st.ticks), int(st.overflowed), bool(st.done)],
            "repaired": sorted(rep.repaired), "updated": list(rep.updated),
            "deadline": list(rep.deadline_fired), "patrolled": list(rep.patrolled),
            "rebuild": None if rep.rebuild is None else list(dataclasses.astuple(rep.rebuild)),
            "actions": [] if h is None else [[a.group, a.rung, a.kind] for a in h.actions],
            "violations": 0 if h is None else len(h.violations),
            "remesh_active": None if h is None else bool(h.remesh_active),
            "gv": int(store.geometry_version), "remeshing": bool(store.remeshing),
            "k": int(store.shard_factor("w"))}
'''
exec(SUMMARY)

REFERENCE = """
import dataclasses, json, tempfile
import time as time_mod
from repro.core import UnrecoverableReadError
from repro.core import store as jstore_mod
from repro.faults.crashpoints import CrashPointMachine
from repro.faults.inject import FaultSpec, apply_fault
from repro.health import HealthPolicy
from repro.remesh import RemeshInProgressError
from repro.scrub import ShardLossConflictError
jstore_mod._ready = lambda x: True
""" + SUMMARY + '''
AXES = ("pod", "data", "model")
W_SPEC = P(("pod", "data", "model"), None)
KV_SPEC = P(None, None, ("pod", "data"), "model", None)

# -- read_verified, machine-local --
def small(**kw):
    pol = RedundancyPolicy.single("vilamb", period_steps=2, lanes_per_block=64,
                                  precompile=False, dispatcher_thread=False, **kw)
    lv = {"w": jnp.asarray(IN["m"])}
    store = ProtectedStore(pol).attach(lv)
    red = store.init(lv)
    return store, lv, store.flush(lv, red, step=0)

store, lv, red = small(read_retry_attempts=2)
for b, v in store.read_verified(lv, red, "w", [0, 5]).items():
    OUT[f"rv/clean/{b}"] = v
lv2, red2 = apply_fault(store.metas, lv, red, FaultSpec("data_bitflip", "w", block=3, lane=1, bit=7))
OUT["rv/recon/3"] = store.read_verified(lv2, red2, "w", [3])[3]
lv3 = dict(lv, w=lv["w"].at[0].add(1.0))
red3 = store.on_write(red, events={"w": jnp.zeros((16,), bool).at[0].set(True)})
OUT["rv/window/0"] = store.read_verified(lv3, red3, "w", [0])[0]
for b in (0, 1):
    lv, red = apply_fault(store.metas, lv, red, FaultSpec("data_bitflip", "w", block=b, lane=0, bit=1))
try:
    store.read_verified(lv, red, "w", [0, 1])
    raise SystemExit("no UnrecoverableReadError")
except UnrecoverableReadError as e:
    OUT["rv/unrec"] = np.asarray(json.dumps([[r.leaf, int(r.stripe), list(r.blocks), r.reason]
                                             for r in e.records]))
store, lv, red = small(read_retry_attempts=4, read_retry_backoff_s=0.01,
                       read_retry_backoff_cap_s=0.02, read_retry_total_s=0.035)
for b in (0, 1):
    lv, red = apply_fault(store.metas, lv, red, FaultSpec("data_bitflip", "w", block=b, lane=3, bit=7))
sleeps, sleep = [], time_mod.sleep
time_mod.sleep = sleeps.append
try:
    store.read_verified(lv, red, "w", [0])
except UnrecoverableReadError:
    pass
time_mod.sleep = sleep
OUT["rv/sleeps"] = np.asarray(sleeps)

# -- sharded stores --
def make(dims, health=None, **kw):
    mesh = make_mesh(dims, AXES)
    pol = RedundancyPolicy.single(
        "vilamb", period_steps=2, lanes_per_block=128, async_tick=True,
        precompile=False, dispatcher_thread=False, health=health, **kw)
    lv = {"w": jax.device_put(jnp.asarray(IN["w"]), NamedSharding(mesh, W_SPEC))}
    store = ProtectedStore(pol, mesh=mesh).attach(lv, specs={"w": W_SPEC})
    return store, lv, store.init(lv)

class Run:
    def __init__(self, prefix, store, lv, red):
        self.prefix, self.store, self.lv, self.red = prefix, store, lv, red
        self.log, self.step, self.gv = [], 0, 0

    def write(self, rows, val):
        if self.store.geometry_version != self.gv:       # engines swapped
            self.store.__dict__.pop("_test_mark_jit", None)
            self.gv = self.store.geometry_version
        idx = jnp.asarray(rows)
        self.lv = dict(self.lv, w=self.lv["w"].at[idx].add(jnp.float32(val)))
        self.red = self.store.on_write(self.red, events={
            "w": jnp.zeros((64,), bool).at[idx].set(True)})

    def tick(self):
        self.step += 1
        self.red, rep = self.store.tick(self.lv, self.red, self.step, scrub_period=0)
        if rep.repaired:
            self.lv = dict(self.lv, **rep.repaired)
        self.log.append(tick_summary(rep, self.store))
        rec(f"{self.prefix}/t{len(self.log) - 1}", self.red)
        return rep

    def finish(self):
        self.red = self.store.flush(self.lv, self.red, step=self.step)
        OUT[self.prefix + "/scrub"] = np.asarray(self.store.scrub_check(self.lv, self.red))
        OUT[self.prefix + "/leaf"] = np.asarray(self.lv["w"])
        rec(self.prefix + "/flush", self.red)
        OUT[self.prefix + "/log"] = np.asarray(json.dumps(self.log))

for tag, old, new in (("grow", (1, 2, 2), (2, 2, 2)), ("shrink", (2, 2, 2), (1, 2, 2))):
    run = Run(tag, *make(old, remesh_bytes_per_tick=32 * 128 * 4))
    rows = IN["rows"]
    for i in range(3):
        run.write(rows[i], 0.25 * (i + 1))
        run.tick()
    run.store.remesh(make_mesh(new, AXES))
    try:
        run.store.remesh(make_mesh(old, AXES))
        raise SystemExit("no RemeshInProgressError")
    except RemeshInProgressError:
        pass
    i = 3
    while run.store.remeshing:
        run.write(rows[i], 0.25 * (i + 1))
        run.tick()
        i += 1
    for i in range(i, i + 3):
        run.write(rows[i], 0.25 * (i + 1))
        run.tick()
    run.finish()

# -- the drain: a deadline expiring mid-migration --
run = Run("drain", *make((2, 2, 2), max_vulnerable_steps=6, remesh_bytes_per_tick=128 * 4,
                         health=HealthPolicy(dispatch_timeout_s=0.0, deadline_margin_steps=1,
                                             violation_mode="report")))
for i in range(4):
    run.write([0, 1], 0.5)
    run.tick()
run.store.remesh(make_mesh((1, 2, 2), AXES))
while run.store.remeshing:
    run.write([0, 1], 0.5)
    run.tick()
for i in range(2):
    run.write([0, 1], 0.5)
    run.tick()
run.finish()

# -- the ladder (tests/test_remesh.py:280) --
run = Run("ladder", *make((2, 2, 2), patrol_bytes_per_tick=8 * 128 * 4))
store, pat = run.store, run.store.patroller
for _ in range(48):
    run.tick()
    if bool(pat.xpar["w"].xvalid.all()):
        break
OUT["ladder/covered"] = np.asarray(len(run.log))
run.lv, run.red = store.inject(run.lv, run.red, FaultSpec(kind="shard_loss", leaf="w", block=3))
store.declare_shard_lost("w", 3, run.red)
store.declare_shard_lost("w", 3, run.red)
run.tick()
events = []
store.declare_shard_lost("w", 3, run.red)
try:
    store.declare_shard_lost("w", 5, run.red)
    raise SystemExit("no ShardLossConflictError")
except ShardLossConflictError as e:
    events.append(["conflict", e.leaf, e.active_shard, e.new_shard])
nb = store.metas["w"].n_blocks
want = [3 * nb + 1, 3 * nb + 9, 0, 7 * nb + 2]
OUT["ladder/read_ids"] = np.asarray(want)
for b, v in store.read_verified(run.lv, run.red, "w", want).items():
    OUT[f"ladder/read/{b}"] = np.asarray(v)
store.remesh(make_mesh((1, 2, 2), AXES))
events.append(["queued", bool(store.remeshing), store._remesh is None])
try:
    store.declare_shard_lost("w", 5, run.red)
    raise SystemExit("no refusal")
except ShardLossConflictError:
    raise SystemExit("wrong refusal")
except RuntimeError:
    events.append(["refused"])
run.red = store.settle(run.red, run.lv)
moved = store.take_repaired()
events.append(["drained", sorted(moved), pat.rebuild is None, bool(store.remeshing),
               int(store.geometry_version)])
run.lv = dict(run.lv, **moved)
rec("ladder/settle", run.red)
for _ in range(24):
    run.tick()
    if not store.remeshing:
        break
events.append(["after", bool(store.remeshing), int(store.geometry_version),
               store.patroller is not pat, int(store.patroller.geometry_version)])
OUT["ladder/events"] = np.asarray(json.dumps(events))
run.finish()

# -- the crash machine, a remesh queued at step 3: the fired phases --
def crash_store():
    pol = RedundancyPolicy.single(
        "vilamb", period_steps=2, lanes_per_block=128, async_tick=True,
        patrol_bytes_per_tick=8 * 128 * 4, precompile=False, dispatcher_thread=False,
        remesh_bytes_per_tick=64 * 128 * 4)
    return ProtectedStore(pol, mesh=MESH).attach(crash_leaves(), specs={"w": W_SPEC})

def crash_leaves():
    return {"w": jax.device_put(jnp.asarray(IN["w"]), NamedSharding(MESH, W_SPEC))}

with tempfile.TemporaryDirectory() as d:
    m = CrashPointMachine(crash_store, crash_leaves, d, seed=0, steps=10,
                          actions={3: lambda s, lv, r: s.remesh(make_mesh((1, 2, 2), AXES))})
    OUT["crash/fired"] = np.asarray(json.dumps(m.enumerate_phases()))

# -- a KV cache under cache_specs, shrunk under decode-like writes --
kv_mesh = make_mesh((2, 2, 2), AXES)
pol = RedundancyPolicy.single("vilamb", period_steps=2, lanes_per_block=128,
                              async_tick=True, precompile=False, dispatcher_thread=False,
                              remesh_bytes_per_tick=4 * 128 * 4)
kv = jax.device_put(jnp.asarray(IN["kv"]).view(jnp.bfloat16), NamedSharding(kv_mesh, KV_SPEC))
kstore = ProtectedStore(pol, mesh=kv_mesh).attach({"kv": kv}, specs={"kv": KV_SPEC})
kred = kstore.init({"kv": kv})
gv = 0
for t in range(IN["kvw"].shape[0]):
    if kstore.geometry_version != gv:
        kstore.__dict__.pop("_test_mark_jit", None)
        gv = kstore.geometry_version
    if t == 3:
        kstore.remesh(make_mesh((1, 2, 2), AXES))
    kv = kv.at[:, t].set(jnp.asarray(IN["kvw"][t]).view(jnp.bfloat16))
    kred = kstore.on_write(kred, events={"kv": jnp.zeros((3, 32), bool).at[:, t].set(True)})
    kred, rep = kstore.tick({"kv": kv}, kred, t + 1, scrub_period=0)
    if rep.repaired:
        kv = rep.repaired["kv"]
OUT["kv/gv"] = np.asarray(kstore.geometry_version)
kred = kstore.flush({"kv": kv}, kred, step=IN["kvw"].shape[0])
OUT["kv/mism"] = np.asarray(kstore.scrub({"kv": kv}, kred)["kv"])
OUT["kv/leaf"] = np.asarray(kv).view(np.uint16)
rec("kv/flush", kred)
'''


def _inputs():
    rng = np.random.default_rng(26)
    kv = rng.standard_normal(KV_SHAPE).astype(np.float32).view(np.uint32)
    # Positions 0-8: the shrink starts at 3 and adopts at 8, the last write.
    kvw = rng.standard_normal((9,) + KV_SHAPE[:1] + KV_SHAPE[2:]).astype(np.float32)
    return {"m": rng.standard_normal((16, 512)).astype(np.float32),
            "w": rng.standard_normal((64, 2048)).astype(np.float32),
            "rows": np.sort(np.stack([rng.choice(64, size=3, replace=False)
                                      for _ in range(STEPS)]), axis=1),
            "kv": (kv >> 16).astype(np.uint16),
            "kvw": (kvw.view(np.uint32) >> 16).astype(np.uint16)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REFERENCE, tmp_path_factory.mktemp("remesh") / "ref.npz",
                         inputs=_inputs())


def _mesh(dims):
    return make_mesh(dims, AXES, device="cpu")


def _small(**kw):
    pol = RedundancyPolicy.single("vilamb", period_steps=2, lanes_per_block=64,
                                  precompile=False, **kw)
    lv = {"w": torch.from_numpy(_inputs()["m"])}
    store = ProtectedStore(pol, device="cpu").attach(lv)
    red = store.init(lv)
    return store, lv, store.flush(lv, red, step=0)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


# ------------------------------------------------------------------- unit tests
def test_translate_marks_identity():
    """Equal lanes per block: marks map 1:1 through global block space
    whatever the shard split (tests/test_remesh.py's case)."""
    old = np.zeros((4, 32), bool)
    old[1, 3] = old[2, 31] = True
    new = translate_marks(old, 128, 128, new_n_blocks=16, new_k=8)
    assert new.shape == (8, 16)
    assert set(np.flatnonzero(new.reshape(-1)).tolist()) == {1 * 32 + 3, 2 * 32 + 31}


def test_translate_marks_regrouped_lanes():
    """Unequal lanes per block: one old block covers several new blocks and
    the other way round; the translation covers at least the old range."""
    old = np.zeros((2, 8), bool)
    old[0, 2] = True
    new = translate_marks(old, 64, 32, new_n_blocks=16, new_k=2)
    assert set(np.flatnonzero(new.reshape(-1)).tolist()) == {4, 5}
    old2 = np.zeros((2, 16), bool)
    old2[0, 5] = True
    new2 = translate_marks(old2, 32, 64, new_n_blocks=8, new_k=2)
    assert set(np.flatnonzero(new2.reshape(-1)).tolist()) == {2}


def _reference_translate(old_mask, old_l, new_l, new_nb, new_k):
    """The reference's loop, called as it is (it imports JAX)."""
    from repro.remesh import translate_marks as jtranslate
    return jtranslate(old_mask, old_l, new_l, new_nb, new_k)


@pytest.mark.parametrize("seed", range(4))
def test_translate_marks_vectorised_equals_reference(seed):
    """The difference-array translation equals the reference's Python loop
    on random masks of random density, lanes regrouped either way and the
    shard count changed; and on row-range shards filling their blocks the
    translation through global positions gives the same marks."""
    rng = np.random.default_rng(seed)
    for old_l, new_l, k_old, k_new in ((128, 128, 4, 8), (64, 32, 8, 4), (32, 64, 2, 4),
                                      (128, 48, 4, 2)):
        words = 4096 * 8
        nb_old, nb_new = words // k_old // old_l, -(-(words // k_new) // new_l)
        mask = rng.random((k_old, nb_old)) < rng.choice([0.0, 0.01, 0.3, 1.0])
        got = translate_marks(mask, old_l, new_l, nb_new, k_new)
        want = _reference_translate(mask, old_l, new_l, nb_new, k_new)
        np.testing.assert_array_equal(got, want)
    # Row ranges of dim 0 filling their blocks: both translations agree.
    shape = (64, 2048)
    for k_old, k_new in ((4, 8), (8, 4), (8, 2)):
        old_meta = B.make_meta(B.ShapeDtype((64 // k_old, 2048), torch.float32), 128, 4)
        new_meta = B.make_meta(B.ShapeDtype((64 // k_new, 2048), torch.float32), 128, 4)
        mask = rng.random((k_old, old_meta.n_blocks)) < 0.05
        g = translate_marks_global(torch.from_numpy(mask), shape, old_meta, (k_old,),
                                   new_meta, (k_new,)).numpy()
        np.testing.assert_array_equal(
            g, translate_marks(mask, 128, 128, new_meta.n_blocks, k_new))


@pytest.mark.parametrize("k_old,k_new,shape", [(4, 8, (64, 2048)), (8, 4, (64, 2048)),
                                               (8, 2, (64, 2048)), (4, 8, (80, 128)),
                                               (8, 4, (80, 128)), (4, 8, (64, 1000))])
def test_translate_words_equals_reference(k_old, k_new, shape):
    """The adoption's translation of packed live words.  Where the shards
    are row ranges filling their blocks, whole words of them (64 x 2048
    fp32) or not (80 x 128: 20 or 10 blocks a shard), the marks regroup
    on the device and equal the reference's ``translate_marks`` of ``live
    | stale`` packed shard by shard.  Where a shard's last block is
    partial (64 x 1000 fp32: 8,000 words a shard) the marks go through
    each block's global position and equal a brute-force map of every
    element; there the reference's formula, which assumes padded shards,
    marks other blocks (ROADMAP Queue 3, difference 6)."""
    from repro.remesh import translate_marks as jtranslate
    rng = np.random.default_rng(k_old * 10 + k_new + shape[1])
    old_meta = B.make_meta(B.ShapeDtype((shape[0] // k_old,) + shape[1:], torch.float32), 128, 4)
    new_meta = B.make_meta(B.ShapeDtype((shape[0] // k_new,) + shape[1:], torch.float32), 128, 4)
    for stale_p in (None, 0.0, 0.1):
        live = rng.random((k_old, old_meta.n_blocks)) < 0.05
        stale = None if stale_p is None else rng.random(old_meta.n_blocks) < stale_p
        words = torch.cat([bits.pack_mask(torch.from_numpy(r)) for r in live])
        got = translate_words(words, shape, old_meta, (k_old,), new_meta, (k_new,), stale)
        got = bits.unpack_rows(got, k_new, new_meta.n_blocks).numpy()
        marks = live | (stale[None] if stale is not None else False)
        ref = jtranslate(marks, 128, 128, new_meta.n_blocks, k_new)
        if shape[1] % 128 == 0:
            np.testing.assert_array_equal(got, ref)
            continue
        # Brute force: element e of old shard s is global element
        # s * n_old + e, which new shard g // n_new holds at g % n_new.
        n_old, n_new = old_meta.n_elems, new_meta.n_elems
        want = np.zeros((k_new, new_meta.n_blocks), bool)
        for s, b in zip(*np.nonzero(marks)):
            e = np.arange(b * 128, min((b + 1) * 128, n_old))
            g = s * n_old + e
            want[g // n_new, (g % n_new) // 128] = True
        np.testing.assert_array_equal(got, want)
        if marks.any():
            assert (ref != want).any()


def test_policy_remesh_knobs_defaults():
    from repro.core import RedundancyPolicy as JPolicy
    pol, jpol = RedundancyPolicy.single("vilamb"), JPolicy.single("vilamb")
    for f in ("remesh_bytes_per_tick", "read_retry_attempts", "read_retry_backoff_s",
              "read_retry_backoff_cap_s", "read_retry_total_s", "read_retry_jitter_frac"):
        assert getattr(pol, f) == getattr(jpol, f), f
    assert pol.remesh_bytes_per_tick == 0 and pol.read_retry_attempts == 3


def test_remesh_status_fields():
    from repro.remesh import RemeshStatus as JStatus
    st = RemeshStatus(from_shape=(1, 2, 2), to_shape=(2, 2, 2), total_blocks=128,
                      started_step=4)
    assert not st.done and st.migrated == 0 and st.ticks == 0 and st.overflowed == 0
    assert [f.name for f in dataclasses.fields(RemeshStatus)] == \
        [f.name for f in dataclasses.fields(JStatus)]


def test_validate_remesh_errors():
    """The typed refusals: no mesh, a dim the new mesh does not divide, an
    unknown axis, a sync group, a second request, a mesh on another device."""
    pol = RedundancyPolicy.single("vilamb", lanes_per_block=64, precompile=False)
    local = ProtectedStore(pol, device="cpu").attach({"w": torch.zeros(8, 256)})
    with pytest.raises(RemeshGeometryError):
        local.remesh(None)
    store = ProtectedStore(pol, mesh=_mesh((2, 2, 2))).attach(
        {"w": torch.zeros(64, 256)}, specs={"w": W_SPEC})
    with pytest.raises(RemeshGeometryError):
        store.remesh(_mesh((2, 3, 2)))                       # 64 % 12
    with pytest.raises(RemeshGeometryError):
        store.remesh(make_mesh((2, 2), ("pod", "data"), device="cpu"))   # no "model"
    store.remesh(_mesh((1, 2, 2)))
    with pytest.raises(RemeshInProgressError):
        store.remesh(_mesh((2, 2, 2)))
    sync = ProtectedStore(RedundancyPolicy.single("sync", lanes_per_block=64,
                                                  precompile=False),
                          mesh=_mesh((2, 2, 2))).attach({"w": torch.zeros(64, 256)},
                                                        specs={"w": W_SPEC})
    with pytest.raises(RemeshGeometryError, match="sync"):
        sync.remesh(_mesh((1, 2, 2)))
    assert not sync.remeshing and store.remeshing


# -------------------------------------------------------- read_verified, local
def test_read_verified_equals_reference(ref):
    """The four machine-local cases of tests/test_remesh.py: clean blocks,
    a bit flip reconstructed from its stripe (the leaf left as it was), a
    block in the window returning the newest write, and two flips in one
    stripe raising ``UnrecoverableReadError`` with ``read_timeout``
    records at their global stripes."""
    store, lv, red = _small(read_retry_attempts=2)
    meta = store.metas["w"]
    lanes = u32(B.to_lanes(lv["w"], meta))
    got = store.read_verified(lv, red, "w", [0, 5])
    for b in (0, 5):
        np.testing.assert_array_equal(got[b], ref[f"rv/clean/{b}"])
        np.testing.assert_array_equal(got[b], lanes[b])
    lv2, red2 = apply_fault(store.metas, lv, red, FaultSpec("data_bitflip", "w", block=3,
                                                            lane=1, bit=7))
    before = lv2["w"].clone()
    got = store.read_verified(lv2, red2, "w", [3])
    np.testing.assert_array_equal(got[3], ref["rv/recon/3"])
    np.testing.assert_array_equal(got[3], lanes[3])
    assert torch.equal(lv2["w"], before), "read_verified wrote the leaf"
    w = lv["w"].clone()
    w[0] += 1.0
    red3 = store.on_write(red, events={"w": torch.zeros(16, dtype=torch.bool).index_fill_(
        0, torch.tensor([0]), True)})
    got = store.read_verified({"w": w}, red3, "w", [0])
    np.testing.assert_array_equal(got[0], ref["rv/window/0"])
    for b in (0, 1):
        lv, red = apply_fault(store.metas, lv, red, FaultSpec("data_bitflip", "w", block=b,
                                                              lane=0, bit=1))
    with pytest.raises(UnrecoverableReadError) as e:
        store.read_verified(lv, red, "w", [0, 1])
    got = [[r.leaf, int(r.stripe), list(r.blocks), r.reason] for r in e.value.records]
    assert got == json.loads(str(ref["rv/unrec"]))
    assert all(r[3] == "read_timeout" for r in got)


def test_read_verified_backoff_sleeps_equal_reference(ref, monkeypatch):
    """tests/test_health.py:81's schedule: attempts 4, base 10 ms, cap 20 ms,
    a 35 ms budget: the sleeps are [10, 20, 5] ms, the reference's."""
    store, lv, red = _small(read_retry_attempts=4, read_retry_backoff_s=0.01,
                            read_retry_backoff_cap_s=0.02, read_retry_total_s=0.035)
    for b in (0, 1):
        lv, red = apply_fault(store.metas, lv, red, FaultSpec("data_bitflip", "w", block=b,
                                                              lane=3, bit=7))
    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    with pytest.raises(UnrecoverableReadError):
        store.read_verified(lv, red, "w", [0])
    assert sleeps == pytest.approx([0.01, 0.02, 0.005])
    assert sleeps == ref["rv/sleeps"].tolist()


# ------------------------------------------------------------- sharded stores
def _make(dims, health=None, **kw):
    pol = RedundancyPolicy.single(
        "vilamb", period_steps=2, lanes_per_block=128, async_tick=True,
        precompile=False, health=health, **kw)
    lv = {"w": torch.from_numpy(_inputs()["w"])}
    store = ProtectedStore(pol, mesh=_mesh(dims)).attach(lv, specs={"w": W_SPEC})
    return store, lv, store.init(lv)


class _Run:
    """The port's side of one scenario, checked against the reference's
    records tick by tick."""

    def __init__(self, ref, prefix, store, lv, red):
        self.ref, self.prefix = ref, prefix
        self.store, self.lv, self.red = store, lv, red
        self.log, self.step = [], 0
        self.want = json.loads(str(ref[prefix + "/log"]))

    def write(self, rows, val):
        idx = torch.as_tensor(np.asarray(rows))
        w = self.lv["w"].clone()
        w[idx] += np.float32(val)
        self.lv = dict(self.lv, w=w)
        self.red = self.store.on_write(self.red, events={
            "w": torch.zeros(64, dtype=torch.bool).index_fill_(0, idx, True)})

    def tick(self):
        self.step += 1
        self.red, rep = self.store.tick(self.lv, self.red, self.step, scrub_period=0)
        if rep.repaired:
            self.lv = dict(self.lv, **rep.repaired)
        i = len(self.log)
        self.log.append(tick_summary(rep, self.store))
        assert self.log[-1] == self.want[i], (self.prefix, i, self.log[-1], self.want[i])
        assert_fields_equal(self.ref, f"{self.prefix}/t{i}", self.red, msg=f"tick {i}")
        return rep

    def finish(self):
        ref, p = self.ref, self.prefix
        self.red = self.store.flush(self.lv, self.red, step=self.step)
        assert self.store.scrub_check(self.lv, self.red) == int(ref[p + "/scrub"]) == 0
        np.testing.assert_array_equal(u32(self.lv["w"]), ref[p + "/leaf"].view(np.uint32))
        assert_fields_equal(ref, p + "/flush", self.red)
        assert self.log == self.want
        assert all(bool(v) for v in self.store.verify_meta(self.red).values())


def _fresh_fields_equal(store, lv, red):
    """Every field equals a store attached fresh on the store's mesh."""
    pol = dataclasses.replace(store.policy, patrol_bytes_per_tick=0, health=None)
    fresh = ProtectedStore(pol, mesh=store.mesh).attach(lv, specs=store._specs)
    want = fresh.init(lv)
    for n, r in want.items():
        for f in ("checksums", "parity", "dirty", "shadow", "meta_ck"):
            assert torch.equal(getattr(red[n], f), getattr(r, f)), (n, f)


@pytest.mark.parametrize("tag,old,new,k_new", [("grow", (1, 2, 2), (2, 2, 2), 8),
                                                ("shrink", (2, 2, 2), (1, 2, 2), 4)])
def test_remesh_under_racing_writes_equals_reference(ref, tag, old, new, k_new):
    """Grow 4 -> 8 and shrink 8 -> 4 shards while 3 rows a step are written,
    into blocks already migrated too: every field, ``RemeshStatus``
    (``overflowed`` included: the CPU queue's) and ``TickReport.remesh``
    equal the reference's after every tick and the flush; the migration
    takes ``ceil(n_blocks / window)`` ticks; the moved leaf is the
    caller's own tensor; after the flush the fields equal a fresh store's
    on the new mesh."""
    run = _Run(ref, tag, *_make(old, remesh_bytes_per_tick=32 * 128 * 4))
    rows = _inputs()["rows"]
    for i in range(3):
        run.write(rows[i], 0.25 * (i + 1))
        run.tick()
    run.store.remesh(_mesh(new))
    with pytest.raises(RemeshInProgressError):
        run.store.remesh(_mesh(old))
    i, status, moved = 3, None, []
    while run.store.remeshing:
        run.write(rows[i], 0.25 * (i + 1))
        leaf = run.lv["w"]
        rep = run.tick()
        if rep.repaired:
            moved.append(rep.repaired["w"] is leaf)
        status = rep.remesh or status
        i += 1
    for i in range(i, i + 3):
        run.write(rows[i], 0.25 * (i + 1))
        run.tick()
    assert moved == [True]
    assert status.done and run.store.geometry_version == 1
    assert run.store.shard_factor("w") == k_new
    nb = run.store.metas["w"].n_blocks
    assert status.ticks == math.ceil(nb / 32) and status.migrated == nb
    run.finish()
    _fresh_fields_equal(run.store, run.lv, run.red)


def test_remesh_drain_at_deadline_equals_reference(ref):
    """A shrink at one block a window under a 6-step deadline with the
    health governor on: mid-migration the margin expires, the remaining
    windows drain on that tick (``remesh_drain``, rung 2), the adoption
    happens there and a blocking update runs on the new geometry, as the
    reference does, tick by tick."""
    run = _Run(ref, "drain", *_make(
        (2, 2, 2), max_vulnerable_steps=6, remesh_bytes_per_tick=128 * 4,
        health=HealthPolicy(dispatch_timeout_s=0.0, deadline_margin_steps=1,
                            violation_mode="report")))
    for _ in range(4):
        run.write([0, 1], 0.5)
        run.tick()
    run.store.remesh(_mesh((1, 2, 2)))
    while run.store.remeshing:
        run.write([0, 1], 0.5)
        run.tick()
    drained = [e for e in run.log if ["g0:vilamb", 2, "remesh_drain"] in e["actions"]]
    assert len(drained) == 1 and drained[0]["remesh"][-1] is True
    migrating = [e for e in run.log if e["remesh"] is not None]
    assert migrating[-1] is drained[0] and len(migrating) < run.store.metas["w"].n_blocks
    for _ in range(2):
        run.write([0, 1], 0.5)
        run.tick()
    run.finish()


def test_remesh_ladder_equals_reference(ref):
    """tests/test_remesh.py:280 held against the reference: xpar covers the
    leaf; shard 3 lost and declared (idempotent), a second shard refused; a
    degraded read mid-rebuild returns the lost shard's original bytes from
    the rebuild's image (and clean blocks of other shards as they are); a
    remesh queues behind the rebuild; a loss is refused while it is queued;
    settle drains the rebuild and leaves the remesh queued; the migration
    then runs, bumps ``geometry_version`` and builds a fresh patroller; the
    leaf after the flush is bitwise the one before the loss."""
    store, lv, red = _make((2, 2, 2), patrol_bytes_per_tick=8 * 128 * 4)
    run = _Run(ref, "ladder", store, lv, red)
    pat = store.patroller
    for _ in range(48):
        run.tick()
        if bool(pat.xpar["w"].xvalid.all()):
            break
    assert len(run.log) == int(ref["ladder/covered"])
    expected = run.lv["w"].clone()
    run.lv, run.red = store.inject(run.lv, run.red, FaultSpec(kind="shard_loss", leaf="w",
                                                              block=3))
    store.declare_shard_lost("w", 3, run.red)
    store.declare_shard_lost("w", 3, run.red)
    run.tick()
    assert pat.rebuild is not None
    events = []
    store.declare_shard_lost("w", 3, run.red)
    with pytest.raises(ShardLossConflictError) as e:
        store.declare_shard_lost("w", 5, run.red)
    events.append(["conflict", e.value.leaf, e.value.active_shard, e.value.new_shard])
    meta = store.metas["w"]
    want = ref["ladder/read_ids"].tolist()
    got = store.read_verified(run.lv, run.red, "w", want)
    exp = u32(store.engine_for("w").lanes_by_shard(expected, "w")).reshape(-1, 128)
    for b in want:
        np.testing.assert_array_equal(got[b], ref[f"ladder/read/{b}"], err_msg=str(b))
        np.testing.assert_array_equal(got[b], exp[b], err_msg=str(b))
    assert want[0] == 3 * meta.n_blocks + 1
    store.remesh(_mesh((1, 2, 2)))
    events.append(["queued", bool(store.remeshing), store._remesh is None])
    with pytest.raises(RuntimeError) as e:
        store.declare_shard_lost("w", 5, run.red)
    assert not isinstance(e.value, ShardLossConflictError)
    events.append(["refused"])
    leaf = run.lv["w"]
    run.red = store.settle(run.red, run.lv)
    moved = store.take_repaired()
    assert moved["w"] is leaf
    events.append(["drained", sorted(moved), pat.rebuild is None, bool(store.remeshing),
                   int(store.geometry_version)])
    run.lv = dict(run.lv, **moved)
    assert_fields_equal(ref, "ladder/settle", run.red)
    for _ in range(24):
        run.tick()
        if not store.remeshing:
            break
    events.append(["after", bool(store.remeshing), int(store.geometry_version),
                   store.patroller is not pat, int(store.patroller.geometry_version)])
    assert events == json.loads(str(ref["ladder/events"]))
    assert events[-1] == ["after", False, 1, True, 1]
    assert all(x.version == 1 for x in store.patroller.xpar.values())
    run.finish()
    assert torch.equal(run.lv["w"].view(torch.int32), expected.view(torch.int32))


# ----------------------------------------------------------------- crash sweep
def _crash_store():
    pol = RedundancyPolicy.single(
        "vilamb", period_steps=2, lanes_per_block=128, async_tick=True,
        patrol_bytes_per_tick=8 * 128 * 4, precompile=False,
        remesh_bytes_per_tick=64 * 128 * 4)
    return ProtectedStore(pol, mesh=_mesh((2, 2, 2))).attach(_crash_leaves(),
                                                            specs={"w": W_SPEC})


def _crash_leaves():
    return {"w": torch.from_numpy(_inputs()["w"])}


def test_crash_sweep_through_remesh_migrate(ref, tmp_path):
    """The crash machine with a remesh queued at step 3 fires the
    reference's phases in the reference's order; a crash at every
    ``remesh_migrate`` restores the old geometry and recovers bitwise; and
    a scribbled shard loss crashed mid-paste is ``rejected`` by the
    verified restore."""
    m = CrashPointMachine(_crash_store, _crash_leaves, tmp_path / "remesh", seed=0,
                          steps=10, actions={3: lambda s, lv, r: s.remesh(_mesh((1, 2, 2)))})
    fired = m.enumerate_phases()
    assert [list(f) for f in fired] == json.loads(str(ref["crash/fired"]))
    outs = [m.run_crash(CrashPlan(p, o)) for p, o in fired if p == "remesh_migrate"]
    assert len(outs) >= 2
    assert all(o.classification == "recovered_bitwise" for o in outs), outs

    def scribble_and_drop(store, leaves, red):
        lv2, red2 = store.inject(leaves, red, FaultSpec(kind="shard_loss", leaf="w", block=3))
        store.declare_shard_lost("w", 3, red2)
        return lv2, red2
    m = CrashPointMachine(_crash_store, _crash_leaves, tmp_path / "scribble", seed=0,
                          steps=8, actions={3: scribble_and_drop})
    assert m.run_crash(CrashPlan("rebuild_paste", 0)).classification == "rejected"


# ---------------------------------------------------------- strided KV caches
def test_strided_cache_remesh_reference_leaves_a_stale_block(ref):
    """A KV cache under cache_specs (batch over pod x data, KV heads over
    model: strided shards) shrunk (2, 2, 2) -> (1, 2, 2) at 4 blocks a
    window while one position a step is written, as decode writes it, the
    last write on the adoption tick.  The reference translates the racing
    writes' marks with the row-range formula, so the blocks of the last
    position (migrated five windows before) keep stale checksums: its scrub
    after the flush flags them (later writes into the same blocks would
    have re-marked them).  The port translates
    through each block's global position: its scrub is clean and every
    field after the flush equals a fresh store's on (1, 2, 2); the leaf is
    the reference's bit for bit."""
    inp = _inputs()
    pol = RedundancyPolicy.single("vilamb", period_steps=2, lanes_per_block=128,
                                  async_tick=True, precompile=False,
                                  remesh_bytes_per_tick=4 * 128 * 4)
    kv = _bf16(inp["kv"])
    store = ProtectedStore(pol, mesh=_mesh((2, 2, 2))).attach({"kv": kv},
                                                             specs={"kv": KV_SPEC})
    red = store.init({"kv": kv})
    T = inp["kvw"].shape[0]
    for t in range(T):
        if t == 3:
            store.remesh(_mesh((1, 2, 2)))
        kv = kv.clone()
        kv[:, t] = _bf16(inp["kvw"][t])
        ev = torch.zeros((3, 32), dtype=torch.bool)
        ev[:, t] = True
        red = store.on_write(red, events={"kv": ev})
        red, rep = store.tick({"kv": kv}, red, t + 1, scrub_period=0)
        if rep.repaired:
            kv = rep.repaired["kv"]
    assert store.geometry_version == int(ref["kv/gv"]) == 1
    red = store.flush({"kv": kv}, red, step=T)
    np.testing.assert_array_equal(kv.view(torch.int16).numpy().view(np.uint16), ref["kv/leaf"])
    assert not bool(store.scrub({"kv": kv}, red)["kv"].any())
    _fresh_fields_equal(store, {"kv": kv}, red)
    stale = np.flatnonzero(ref["kv/mism"])
    assert stale.size > 0, "the reference's scrub found no stale block"
    want = ref["kv/flush/kv/checksums"].astype(np.uint32)
    got = u32(red["kv"].checksums)
    assert set(np.flatnonzero(got != want)) == set(stale)


def test_generate_with_a_remesh_midway_is_clean():
    """The port's ``Server.generate`` on a (2, 2, 2) mesh with the caches
    under cache_specs and a shrink to (1, 2, 2) queued before it: the
    migration runs during decode (``stats["remesh"]`` done), the tokens are
    no store's, and after the flush the scrub is clean and every field
    equals a fresh store's on (1, 2, 2)."""
    cfg = dataclasses.replace(get_smoke("llama3.2-3b"), param_dtype="float32")
    model = build_model(cfg, "cpu")
    torch.manual_seed(0)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (8, 8)).astype(np.int32))}
    max_len, gen = 32, 16
    mesh = _mesh((2, 2, 2))
    shapes = flatten_dict(model.cache_shapes(8, max_len))
    specs, _ = cache_specs(cfg, shapes, ParallelCtx(mesh), 8)
    pol = RedundancyPolicy.single("vilamb", period_steps=2, lanes_per_block=128,
                                  async_tick=True, precompile=False,
                                  remesh_bytes_per_tick=4 * 128 * 4)
    store = ProtectedStore(pol, mesh=mesh).attach(shapes, specs=specs)
    store.remesh(_mesh((1, 2, 2)))
    toks, stats = Server(model=model, store=store, max_len=max_len).generate(params, batch, gen)
    bare, _ = Server(model=model, max_len=max_len).generate(params, batch, gen)
    assert torch.equal(toks, bare)
    assert stats["remesh"] is not None and stats["remesh"].done
    assert store.geometry_version == 1 and store.mesh.sizes == (1, 2, 2)
    with torch.inference_mode():
        leaves = flatten_dict(stats["caches"])
        red = store.flush(leaves, stats["red"], step=gen)
        assert store.scrub_check(leaves, red) == 0
        _fresh_fields_equal(store, leaves, red)
