"""The port's sharded store against the reference's, on the CPU.

The reference runs once, in one subprocess on an 8-device forced host mesh
(``tests/_torch_sharded.py``): ``MESH_PRELUDE``'s store ("w" over all 8
shards, "e" over 4 and replicated over ``model``; work-queue fraction 0.5)
driven with ``drive(steps=8, seed=5)`` on the blocking and on the
overlapped tick, one overflow on a single shard, and a KV-cache-shaped leaf
``(4, 16, 8, 8, 64)`` bf16 under ``[None, None, ("pod", "data"), "model",
None]`` (strided shards).  The port's store runs the same leaves and
writes on a simulated (2, 2, 2) mesh on the CPU, and every field of every
leaf (``checksums``, ``parity``, ``dirty``, ``shadow``, ``meta_ck``) is
compared bit for bit (tolerance 0) after every tick, after ``settle`` and
after ``flush``; so are the scrub masks, ``verify_meta`` and the
redundancy shapes.  Port-only: the queued variant really runs, and each
shard's fields equal a machine-local store's over that shard's rows.
Mirrors tests/test_sharded.py.
"""
import numpy as np
import pytest
import torch

from _torch_sharded import (FIELDS, SPECS, assert_fields_equal, leaf_from_ref, mesh,
                            run_reference, u32)
from repro_torch.core import ProtectedStore, RedundancyPolicy, blocks, workqueue
from repro_torch.dist import P

KV_SHAPE = (4, 16, 8, 8, 64)
KV_SPEC = P(None, None, ("pod", "data"), "model", None)
KV_STEPS = 2

REFERENCE = """
def drive_rec(store, prefix, steps=8, seed=5):
    rng = np.random.default_rng(seed)
    lv = put(make_leaves())
    red = store.init(lv)
    rec(prefix + "/init", red)
    for step in range(1, steps + 1):
        rows = rng.choice(64, size=int(rng.integers(1, 4)), replace=False)
        idx = jnp.asarray(np.sort(rows))
        lv = dict(lv, w=lv["w"].at[idx].add(0.25 * step))
        ev = jnp.zeros((64,), bool).at[idx].set(True)
        red = store.on_write(red, events={"w": ev})
        store.sync_inflight()
        red, _ = store.tick(lv, red, step)
        rec(f"{prefix}/s{step}", red)
    return lv, red

lv0 = make_leaves()
OUT["leaf/w"] = np.asarray(lv0["w"])
OUT["leaf/e"] = np.asarray(lv0["e"]).view(np.uint16)
for at in (0, 1):
    st = mesh_store(async_tick=bool(at), precompile=False)
    if at == 0:
        for k, s in st.red_structs().items():
            for f in FIELDS:
                OUT[f"structs/{k}/{f}"] = np.asarray(getattr(s, f).shape)
        OUT["factors"] = np.asarray([st.shard_factor("w"), st.shard_factor("e")])
    lv, red = drive_rec(st, f"d{at}")
    red = st.settle(red, lv)
    rec(f"d{at}/settle", red)
    for k, m in st.scrub(lv, red).items():
        OUT[f"d{at}/scrub/{k}"] = np.asarray(m)
    OUT[f"d{at}/verify"] = np.asarray([bool(v) for v in st.verify_meta(red).values()])
    red = st.flush(lv, red, 9)
    rec(f"d{at}/flush", red)

# One overflow on a single shard: shard 0 of "w" owns rows 0..7.
for at in (1, 0):
    store = mesh_store(async_tick=bool(at), period=1, precompile=False)
    lv = put(make_leaves())
    red = store.init(lv)
    g = next(iter(store.groups.values()))
    if at:
        g.predicted_fits = True
    ev = jnp.zeros((64,), bool).at[jnp.arange(8)].set(True)
    lv = dict(lv, w=lv["w"].at[jnp.arange(8)].add(1.0))
    red = store.on_write(red, events={"w": ev})
    red, rep = store.tick(lv, red, 1)
    if at:
        assert g.pending is not None and g.pending.queued
        store.sync_inflight()
        red, rep = store.tick(lv, red, 2)
        assert rep.overflowed and g.predicted_fits is False
    red = store.settle(red, lv)
    rec(f"ovf{at}", red)

# A KV cache's spec: strided shards.
from repro.core import blocks as jblocks
import ml_dtypes
spec = P(None, None, ("pod", "data"), "model", None)
kvs = [jnp.asarray(IN[f"kv{t}"].view(ml_dtypes.bfloat16)) for t in range(3)]
pol = RedundancyPolicy.single("vilamb", period_steps=1, lanes_per_block=128,
                              work_queue_frac=0.5, async_tick=False, precompile=False)
st = ProtectedStore(pol, mesh=MESH).attach({"kv": kvs[0]}, specs={"kv": spec})
sh = NamedSharding(MESH, spec)
red = st.init({"kv": jax.device_put(kvs[0], sh)})
rec("kv/init", red)
OUT["kv/factor"] = np.asarray(st.shard_factor("kv"))
for t in range(1, 3):
    red = st.on_write(red, events={"kv": jnp.asarray(IN[f"ev{t}"])})
    red, _ = st.tick({"kv": jax.device_put(kvs[t], sh)}, red, t)
    rec(f"kv/s{t}", red)
bad = jnp.asarray(IN["kv_bad"].view(ml_dtypes.bfloat16))
for k, m in st.scrub({"kv": jax.device_put(bad, sh)}, red).items():
    OUT["kv/scrub"] = np.asarray(m)
meta = st.protected_metas["kv"]
try:
    jblocks.shard_slice(kvs[2], meta, 8, 1)
except ValueError as e:
    OUT["kv/slice_error"] = np.asarray(str(e))
"""


def _kv_inputs():
    """Three states of the KV leaf (bf16 bits) and the two row events over
    its (layer, position) dims that lead from one to the next, plus the
    last state with one lane of shard 5 corrupted."""
    rng = np.random.default_rng(11)
    kv = [rng.integers(0, 2**16, size=KV_SHAPE, dtype=np.uint16) & 0x7F7F]
    evs = {}
    for t in range(1, 3):
        ev = np.zeros(KV_SHAPE[:2], bool)
        ev[rng.integers(0, 4), rng.choice(16, size=3, replace=False)] = True
        nxt = kv[-1].copy()
        nxt[ev] = rng.integers(0, 2**16, size=nxt[ev].shape, dtype=np.uint16) & 0x7F7F
        kv.append(nxt)
        evs[f"ev{t}"] = ev
    bad = kv[2].copy()
    # Shard 5 = (pod 1, data 0, model 1): batch rows 4..5, heads 4..7.
    bad[1, 3, 4, 5, 7] ^= 0x0100
    return dict({f"kv{t}": a for t, a in enumerate(kv)}, kv_bad=bad, **evs)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REFERENCE, tmp_path_factory.mktemp("sharded") / "ref.npz",
                         inputs=_kv_inputs())


def _leaves(ref):
    return {"w": leaf_from_ref(ref, "leaf/w", torch.float32),
            "e": leaf_from_ref(ref, "leaf/e", torch.bfloat16)}


def _store(ref, async_tick, frac=0.5, period=2, **kw):
    pol = RedundancyPolicy.single("vilamb", period_steps=period, lanes_per_block=128,
                                  work_queue_frac=frac, async_tick=async_tick,
                                  precompile=False, **kw)
    return ProtectedStore(pol, mesh=mesh()).attach(_leaves(ref), specs=SPECS)


def _drive(ref, store, steps=8, seed=5, on_tick=None):
    rng = np.random.default_rng(seed)
    lv = _leaves(ref)
    red = store.init(lv)
    if on_tick:
        on_tick(0, red)
    for step in range(1, steps + 1):
        rows = rng.choice(64, size=int(rng.integers(1, 4)), replace=False)
        idx = torch.as_tensor(np.sort(rows))
        w = lv["w"].clone()
        w[idx] += 0.25 * step
        lv = dict(lv, w=w)
        ev = torch.zeros((64,), dtype=torch.bool).index_fill_(0, idx, True)
        red = store.on_write(red, events={"w": ev})
        store.sync_inflight()
        red, _ = store.tick(lv, red, step)
        if on_tick:
            on_tick(step, red)
    return lv, red


@pytest.mark.parametrize("async_tick", [0, 1], ids=["blocking", "overlapped"])
def test_sharded_store_equals_reference(ref, async_tick, monkeypatch):
    """Every field after every tick, after settle and after flush; the
    scrub masks and verify_meta; the queued variant really dispatched."""
    queued = []
    orig = workqueue.queued_update
    monkeypatch.setattr(workqueue, "queued_update",
                        lambda *a, **k: (queued.append(1), orig(*a, **k))[1])
    store = _store(ref, bool(async_tick))
    seen = []

    def on_tick(step, red):
        assert_fields_equal(ref, f"d{async_tick}/" + ("init" if step == 0 else f"s{step}"),
                            red)
        seen.append(step)
    lv, red = _drive(ref, store, on_tick=on_tick)
    assert seen == list(range(9)) and queued, (seen, len(queued))
    red = store.settle(red, lv)
    assert_fields_equal(ref, f"d{async_tick}/settle", red)
    for k, m in store.scrub(lv, red).items():
        np.testing.assert_array_equal(m.numpy(), ref[f"d{async_tick}/scrub/{k}"], err_msg=k)
        assert m.shape == (store.protected_metas[k].n_blocks * store.shard_factor(k),)
    assert [bool(v) for v in store.verify_meta(red).values()] == \
        ref[f"d{async_tick}/verify"].tolist() == [True, True]
    red = store.flush(lv, red, 9)
    assert_fields_equal(ref, f"d{async_tick}/flush", red)


def test_sharded_geometry_equals_reference(ref):
    store = _store(ref, False)
    assert [store.shard_factor("w"), store.shard_factor("e")] == ref["factors"].tolist() \
        == [8, 4]
    for k, s in store.red_structs().items():
        for f in FIELDS:
            assert tuple(getattr(s, f).shape) == tuple(ref[f"structs/{k}/{f}"]), (k, f)
    assert store.red_structs(global_=False)["w"].meta_ck.shape == (1,)


def test_sharded_overflow_on_one_shard_is_bitwise_safe(ref):
    """A speculative queued dispatch overflowing one shard's queue keeps
    that shard's snapshot marked and settles to the blocking bits."""
    outs = {}
    for at in (1, 0):
        store = _store(ref, bool(at), period=1)
        lv = _leaves(ref)
        red = store.init(lv)
        g = next(iter(store.groups.values()))
        if at:
            g.predicted_fits = True
        ev = torch.zeros((64,), dtype=torch.bool)
        ev[:8] = True
        w = lv["w"].clone()
        w[:8] += 1.0
        lv = dict(lv, w=w)
        red = store.on_write(red, events={"w": ev})
        red, rep = store.tick(lv, red, 1)
        if at:
            assert g.pending is not None and g.pending.queued
            store.sync_inflight()
            red, rep = store.tick(lv, red, 2)
            assert rep.overflowed and g.predicted_fits is False
        red = store.settle(red, lv)
        assert_fields_equal(ref, f"ovf{at}", red)
        assert sum(int(v.sum()) for v in store.scrub(lv, red).values()) == 0
        outs[at] = red
    for k in outs[0]:
        for f in FIELDS:
            assert torch.equal(getattr(outs[0][k], f), getattr(outs[1][k], f)), (k, f)


def _kv_store():
    pol = RedundancyPolicy.single("vilamb", period_steps=1, lanes_per_block=128,
                                  work_queue_frac=0.5, async_tick=False, precompile=False)
    kv = torch.zeros(KV_SHAPE, dtype=torch.bfloat16)
    return ProtectedStore(pol, mesh=mesh()).attach({"kv": kv}, specs={"kv": KV_SPEC})


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def test_strided_leaf_equals_reference(ref):
    """A KV cache's spec shards dims 2 and 3: the port stages the shards
    (permute and reshape) and its global arrays equal the reference's."""
    inp = _kv_inputs()
    store = _kv_store()
    assert store.shard_factor("kv") == int(ref["kv/factor"]) == 8
    red = store.init({"kv": _bf16(inp["kv0"])})
    assert_fields_equal(ref, "kv/init", red)
    for t in range(1, 3):
        red = store.on_write(red, events={"kv": torch.from_numpy(inp[f"ev{t}"])})
        red, _ = store.tick({"kv": _bf16(inp[f"kv{t}"])}, red, t)
        assert_fields_equal(ref, f"kv/s{t}", red)
    mm = store.scrub({"kv": _bf16(inp["kv_bad"])}, red)["kv"]
    np.testing.assert_array_equal(mm.numpy(), ref["kv/scrub"])
    nb = store.protected_metas["kv"].n_blocks
    assert [int(b) // nb for b in torch.nonzero(mm).flatten()] == [5]


def test_strided_leaf_surgery_raises_reference_error(ref):
    """``shard_slice`` (and so ``recover_block``, ``repair`` and
    ``inject``) refuses a leaf not sharded along dim 0, as the
    reference's does, with its message."""
    inp = _kv_inputs()
    store = _kv_store()
    kv = _bf16(inp["kv2"])
    meta = store.protected_metas["kv"]
    want = str(ref["kv/slice_error"])
    assert "dim0-only sharding" in want
    with pytest.raises(ValueError) as e:
        blocks.shard_slice(kv, meta, 8, 1)
    assert str(e.value) == want
    red = store.init({"kv": kv})
    from repro_torch.faults import FaultSpec
    for call in (lambda: store.recover_block(kv, red["kv"], "kv", meta.n_blocks + 3),
                 lambda: store.repair({"kv": kv}, red, {"kv": [meta.n_blocks + 3]}),
                 lambda: store.inject({"kv": kv}, red,
                                      FaultSpec("data_bitflip", "kv", meta.n_blocks + 3))):
        with pytest.raises(ValueError, match="dim0-only sharding"):
            call()


def _machine_local(meta_leaf: torch.Tensor, lanes_per_block=128):
    pol = RedundancyPolicy.single("vilamb", lanes_per_block=lanes_per_block,
                                  precompile=False)
    st = ProtectedStore(pol, device="cpu").attach({"x": meta_leaf})
    return st, st.init({"x": meta_leaf})["x"]


def test_each_shard_equals_a_machine_local_store(ref):
    """After a flush, shard ``s``'s slice of every field equals a
    machine-local store's over shard ``s``'s local tensor (port-only; the
    replicated "e" and the strided KV leaf included)."""
    store = _store(ref, True)
    lv, red = _drive(ref, store)
    red = store.flush(lv, red, 9)
    kv_store = _kv_store()
    kv = _bf16(_kv_inputs()["kv2"])
    kv_red = kv_store.init({"kv": kv})
    cases = [(store, "w", lv["w"], red["w"]), (store, "e", lv["e"], red["e"]),
             (kv_store, "kv", kv, kv_red["kv"])]
    for st, name, leaf, r in cases:
        eng = st.engine_for(name)
        meta = st.protected_metas[name]
        nb, ns, nw = meta.n_blocks, meta.n_stripes, meta.n_dirty_words
        parts = blocks.shard_view(leaf, eng._splits[name])
        assert parts.shape[0] == st.shard_factor(name)
        for s, part in enumerate(parts):
            _, local = _machine_local(part.contiguous())
            got = eng._shard_red(name, r, s)
            for f in ("checksums", "parity", "dirty", "shadow"):
                assert torch.equal(getattr(got, f), getattr(local, f)), (name, s, f)
            assert int(got.meta_ck) == int(local.meta_ck), (name, s)
            assert got.checksums.shape == (nb,) and got.parity.shape[0] == ns
            assert got.dirty.shape == (nw,)


def test_sharded_store_refuses_what_is_not_ported(ref):
    """The patroller of a sharded store (item 11.4, ported) attaches, with
    cross-shard parity for both dim0-sharded leaves, and the probe runs
    under the mesh; specs without a mesh and the row fast path under a mesh
    are refused."""
    pol = RedundancyPolicy.single("vilamb", lanes_per_block=128, precompile=False,
                                  patrol_bytes_per_tick=4096)
    pstore = ProtectedStore(pol, mesh=mesh()).attach(_leaves(ref), specs=SPECS)
    assert pstore.patroller is not None and sorted(pstore.patroller.xpar) == ["e", "w"]
    with pytest.raises(ValueError, match="mesh="):
        ProtectedStore(RedundancyPolicy(), device="cpu").attach(_leaves(ref), specs=SPECS)
    store = _store(ref, False)
    red = store.init(_leaves(ref))
    eng = store.engine_for("w")
    mism, clean = eng.verify_window_fn("w", 8)(_leaves(ref)["w"], red["w"], 0)
    assert mism.shape == clean.shape == (8, 8) and bool(clean.all()) and not bool(mism.any())
    with pytest.raises(ValueError, match="machine-local"):
        eng.sync_update_rows("w", red["w"], torch.tensor([0]), torch.zeros(1, 2048),
                             torch.ones(1, 2048))
    # A wrong global shape is refused, not silently mis-sharded.
    with pytest.raises(ValueError, match="declared"):
        store.init({"w": torch.zeros(32, 2048), "e": _leaves(ref)["e"]})
