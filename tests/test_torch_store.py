"""The port's ProtectedStore lifecycle against the reference store.

The same numpy writes drive ``repro.core.ProtectedStore`` and
``repro_torch`` on the CPU, both on the blocking tick (``async_tick=False``;
tests/test_torch_async_tick.py holds the overlapped tick).
After every tick the whole redundancy state, the tick report and the dirty
statistics must agree bit for bit; so must the scrub masks and the
recovered leaf at the end.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_masks_equal, assert_red_equal, jnp_leaves
from repro.core import LeafPolicy as JLeafPolicy
from repro.core import ProtectedStore as JStore
from repro.core import RedundancyPolicy as JPolicy
from repro.core import policy as jpolicy
from repro_torch.core import LeafPolicy, ProtectedStore, RedundancyPolicy, convert


def _stores(policy_kw, leaf_kw, rules, np_state):
    jpol = JPolicy(default=JLeafPolicy(**leaf_kw),
                   rules=tuple((p, JLeafPolicy(**kw)) for p, kw in rules),
                   async_tick=False, precompile=False, **policy_kw)
    tpol = RedundancyPolicy(default=LeafPolicy(**leaf_kw),
                            rules=tuple((p, LeafPolicy(**kw)) for p, kw in rules),
                            async_tick=False, **policy_kw)
    js = JStore(jpol).attach(jnp_leaves(np_state))
    ts = ProtectedStore(tpol, device="cpu").attach(
        convert.leaves_from_numpy(np_state, device="cpu"))
    return js, ts


def _both(np_state):
    return (jnp_leaves(np_state),
            convert.leaves_from_numpy(np_state, device="cpu"))


def _compare_stats(js, ts, jred, tred):
    sj, st_ = js.dirty_stats(jred), ts.dirty_stats(tred)
    assert {n: {k: int(v) for k, v in s.items()} for n, s in sj.items()} == \
        {n: {k: int(v) for k, v in s.items()} for n, s in st_.items()}
    fj = js.estimate_flush(jred)
    ft = ts.estimate_flush(tred, bytes_per_sec=jpolicy.HBM_BYTES_PER_SEC)
    assert (fj.dirty_bytes, fj.stripe_bytes, fj.write_bytes, fj.seconds) == \
        (ft.dirty_bytes, ft.stripe_bytes, ft.write_bytes, ft.seconds)


def _check_end(js, ts, jred, tred, state, name, block, lane):
    """Corrupt one lane of a clean block; both scrub, recover, rescrub."""
    lanes = state[name].reshape(-1).view(np.uint32)
    good = state[name].copy()
    lanes[block * js.metas[name].lanes_per_block + lane] += np.uint32(0xBAD)
    jl, tl = _both(state)
    jm, tm = js.scrub(jl, jred), ts.scrub(tl, tred)
    for n in jm:
        assert_masks_equal(jm[n], tm[n], n)
    assert np.flatnonzero(tm[name].numpy()).tolist() == [block]
    jfix, jok = js.recover_block(jl[name], jred[name], name, block)
    tfix, tok = ts.recover_block(tl[name], tred[name], name, block)
    assert bool(jok) and tok
    np.testing.assert_array_equal(np.asarray(jfix).view(np.uint32),
                                  tfix.numpy().view(np.uint32))
    np.testing.assert_array_equal(tfix.numpy(), good)
    tl[name] = tfix
    assert int(ts.scrub(tl, tred)[name].sum()) == 0
    assert all(bool(v) for v in ts.verify_meta(tred).values())


@pytest.mark.parametrize("deadline", [16, 5])
def test_quickstart_sequence(deadline):
    """examples/quickstart.py: a vilamb heap (T=8, freshness deadline) beside
    a sync params blob; the tight deadline makes deadline_fired fire."""
    rng = np.random.default_rng(0)
    state = {"heap": rng.standard_normal((1024, 1024)).astype(np.float32),
             "params": rng.standard_normal((512, 512)).astype(np.float32)}
    js, ts = _stores({}, dict(mode="vilamb", period_steps=8,
                              max_vulnerable_steps=deadline),
                     (("params*", dict(mode="sync")),), state)
    assert [(g.label, g.names) for g in js.groups.values()] == \
        [(g.label, g.names) for g in ts.groups.values()]
    jl, tl = _both(state)
    jred, tred = js.init(jl), ts.init(tl)
    assert_red_equal(jred, tred, "init")
    fired = set()
    for step in range(1, 13):
        rows = rng.integers(0, 1024, size=16)
        old = {k: v.copy() for k, v in state.items()}
        np.add.at(state["heap"], rows, np.float32(1.0))
        state["params"] = state["params"] * np.float32(0.999)
        ev = np.zeros(1024, bool)
        ev[rows] = True
        jo, to = _both(old)
        jl, tl = _both(state)
        jred = js.on_write(jred, events={"heap": jnp.asarray(ev)}, old=jo, new=jl)
        tred = ts.on_write(tred, events={"heap": torch.from_numpy(ev)}, old=to, new=tl)
        jred, jrep = js.tick(jl, jred, step)
        tred, trep = ts.tick(tl, tred, step)
        assert_red_equal(jred, tred, f"step {step}")
        assert (jrep.updated, jrep.deadline_fired, jrep.scrubbed) == \
            (trep.updated, trep.deadline_fired, trep.scrubbed)
        fired.update(trep.deadline_fired)
        _compare_stats(js, ts, jred, tred)
    assert bool(fired) == (deadline == 5)
    jl, tl = _both(state)
    jred, tred = js.flush(jl, jred), ts.flush(tl, tred)
    assert_red_equal(jred, tred, "flush")
    _check_end(js, ts, jred, tred, state, "heap", 5, 99)


@pytest.mark.parametrize("mode", ["sync", "vilamb"])
def test_region_4k_row_heap(mode):
    """benchmarks/common.Region geometry: 512 rows of 4 KiB, one block per
    row, 4+1 stripes; sync writes go through row_diffs.  A clean block is
    corrupted mid-run, so the tick's scheduled scrub raises one alarm."""
    rng = np.random.default_rng(1)
    state = {"heap": np.zeros((512, 1024), np.float32)}
    js, ts = _stores(dict(lanes_per_block=1024, stripe_data_blocks=4),
                     dict(mode=mode, period_steps=4, scrub_period_steps=8),
                     (), state)
    jl, tl = _both(state)
    jred, tred = js.init(jl), ts.init(tl)
    for step in range(1, 11):
        rows = np.sort(rng.choice(256, size=16, replace=False)).astype(np.int32)
        vals = rng.standard_normal((16, 1024)).astype(np.float32)
        old_rows = state["heap"][rows].copy()
        state["heap"][rows] = vals
        if step == 6:                    # silent corruption of a clean block
            state["heap"][400, 7] += np.float32(1.0)
        ev = np.zeros(512, bool)
        ev[rows] = True
        jl, tl = _both(state)
        jred = js.on_write(jred, events={"heap": jnp.asarray(ev)},
                           row_diffs={"heap": (jnp.asarray(rows), jnp.asarray(old_rows),
                                               jnp.asarray(vals))})
        tred = ts.on_write(tred, events={"heap": torch.from_numpy(ev)},
                           row_diffs={"heap": (torch.from_numpy(rows),
                                               torch.from_numpy(old_rows),
                                               torch.from_numpy(vals))})
        jred, jrep = js.tick(jl, jred, step)
        tred, trep = ts.tick(tl, tred, step)
        assert_red_equal(jred, tred, f"step {step}")
        assert (jrep.updated, jrep.deadline_fired, jrep.scrubbed, jrep.mismatches,
                jrep.alarms) == (trep.updated, trep.deadline_fired, trep.scrubbed,
                                 trep.mismatches, trep.alarms)
        if step == 8:
            assert (trep.mismatches, trep.alarms) == (1, 1)
        _compare_stats(js, ts, jred, tred)
    assert js.corruption_alarms == ts.corruption_alarms == 1
    jl, tl = _both(state)
    assert js.scrub_check(jl, jred) == ts.scrub_check(tl, tred) == 1
    jred, tred = js.flush(jl, jred, step=10), ts.flush(tl, tred, step=10)
    assert_red_equal(jred, tred, "flush")
    jm, tm = js.vulnerable_masks(jred), ts.vulnerable_masks(tred)
    assert_masks_equal(jm["heap"], tm["heap"])
    state["heap"][400, 7] -= np.float32(1.0)   # undo; the end check corrupts anew
    _check_end(js, ts, jred, tred, state, "heap", 300, 11)


def test_attach_rejects_leaf_on_other_device():
    store = ProtectedStore(RedundancyPolicy(), device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        store.attach({"x": torch.zeros(4, device="meta")})
