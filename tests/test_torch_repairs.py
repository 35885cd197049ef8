"""Parity repair in the port against the reference, on the CPU.

The same numpy leaves and corruptions go through ``repro`` and
``repro_torch``: ``plan_stripe_repairs``, ``repair_corruption`` and
``ProtectedStore.repair`` must give equal repair candidates, equal
``UnrecoverableBlock`` records, equal fixed and lost counts and bitwise
equal repaired leaves (tolerance 0: these are bit patterns), for single,
multi-corrupt and vulnerable-stripe cases, on the blocking and on the
overlapped tick mid-flight.  The port repairs in place; the reference
returns new arrays.
"""
import warnings

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_helpers import assert_red_equal, jnp_leaves
from repro.ckpt.failure import repair_corruption as jrepair_corruption
from repro.core import ProtectedStore as JStore
from repro.core import RedundancyPolicy as JPolicy
from repro.core import blocks as jblocks
from repro.core import repairs as jrepairs
from repro_torch.ckpt.failure import repair_corruption
from repro_torch.core import ProtectedStore, RedundancyPolicy, blocks, convert, repairs

# Lanes per block: w is 64 blocks (16 stripes of 4; row r is blocks 2r and
# 2r + 1), e is 4 (one stripe), p is 3 whose lane view is a padded copy.
L = 128


def _np_leaves(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((32, 256)).astype(np.float32),
            "e": rng.standard_normal((16, 64)).astype(np.float32)
            .astype(ml_dtypes.bfloat16),
            "p": rng.standard_normal((10, 30)).astype(np.float32)}


def _stores(state, async_tick=False, period=3):
    kw = dict(lanes_per_block=L, async_tick=async_tick, period_steps=period)
    js = JStore(JPolicy.single("vilamb", precompile=False, dispatcher_thread=False,
                               **kw)).attach(jnp_leaves(state))
    ts = ProtectedStore(RedundancyPolicy.single("vilamb", **kw),
                        device="cpu").attach(convert.leaves_from_numpy(state, "cpu"))
    return js, ts


def _corrupt(state, leaf, block, lane=3, delta=0xBAD):
    words = state[leaf].reshape(-1).view(np.uint16 if state[leaf].itemsize == 2
                                         else np.uint32)
    per_word = 4 // state[leaf].itemsize
    words[(block * L + lane) * per_word] += delta


def _records(recs):
    return [(r.leaf, r.stripe, tuple(r.blocks), r.reason) for r in recs]


def _run_both(state, jred, tred, js, ts, via_store=True):
    """Scrub and repair in both packages; returns their results."""
    jl, tl = jnp_leaves(state), convert.leaves_from_numpy(state, "cpu")
    jm, tm = js.scrub(jl, jred), ts.scrub(tl, tred)
    for n in jm:
        np.testing.assert_array_equal(np.asarray(jm[n]), tm[n].numpy(), n)
    jd, td = [], []
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        jout = (js.repair(jl, jred, jm, details=jd) if via_store
                else jrepair_corruption(js, jl, jred, jm, details=jd))
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        tout = (ts.repair(tl, tred, tm, details=td) if via_store
                else repair_corruption(ts, tl, tred, tm, details=td))
    assert [str(w.message) for w in wj] == [str(w.message) for w in wt]
    return jout, tout, jd, td, tl


def _assert_same(jout, tout, jd, td, tl):
    (jl2, jf, jlost), (tl2, tf, tlost) = jout, tout
    assert (jf, jlost) == (tf, tlost)
    assert _records(jd) == _records(td)
    assert set(jl2) == set(tl2)
    for n in jl2:
        np.testing.assert_array_equal(
            np.asarray(jl2[n]).view(np.uint8),
            convert.leaves_to_numpy({n: tl2[n]})[n].view(np.uint8), n)
    for n in ("w", "e"):          # in place: the same tensors come back
        assert tl2[n] is tl[n]


def test_global_stripe_id_is_the_references_on_one_shard():
    meta = blocks.make_meta(torch.zeros(40, 200), L)
    jmeta = jblocks.make_meta(np.zeros((40, 200), np.float32), L)
    for b in range(meta.n_blocks):
        assert blocks.global_stripe_id(meta, b) == jblocks.global_stripe_id(jmeta, b)


@pytest.mark.parametrize("mismatches", [
    {"w": [5]}, {"w": [4, 6]}, {"w": [4, 6, 13], "e": [1]},
    {"w": [0, 1, 2, 3, 63]}, {"e": [0, 1]}, {"w": []}, {"p": [2], "w": [9, 10]}])
def test_plan_stripe_repairs_matches_reference(mismatches):
    state = _np_leaves()
    js, ts = _stores(state)
    for as_mask in (False, True):
        jm, tm = mismatches, mismatches
        if as_mask:
            jm = {n: np.isin(np.arange(js.metas[n].n_blocks), ids)
                  for n, ids in mismatches.items()}
            tm = {n: torch.from_numpy(m) for n, m in jm.items()}
        js_, ju = jrepairs.plan_stripe_repairs(js.metas, jm)
        ts_, tu = repairs.plan_stripe_repairs(ts.metas, tm)
        assert js_ == ts_ and _records(ju) == _records(tu)


@pytest.mark.parametrize("via_store", [True, False])
@pytest.mark.parametrize("case", ["single", "multi", "vulnerable", "mixed"])
def test_repair_matches_reference(case, via_store):
    """Scrub masks, fixed and lost counts, the UnrecoverableBlock records,
    the warnings and the repaired leaves equal the reference's."""
    state = _np_leaves()
    js, ts = _stores(state)
    jl, tl = jnp_leaves(state), convert.leaves_from_numpy(state, "cpu")
    jred, tred = js.init(jl), ts.init(tl)
    if case in ("vulnerable", "mixed"):
        ev = np.zeros(32, bool)
        ev[5] = True                       # blocks 10-11: stripe 2 is vulnerable
        jred = js.on_write(jred, events={"w": jnp.asarray(ev.copy())})
        tred = ts.on_write(tred, events={"w": torch.from_numpy(ev)})
        assert_red_equal(jred, tred, "on_write")
    corrupt = {"single": [("w", 5)], "multi": [("w", 4), ("w", 6)],
               "vulnerable": [("w", 8)],
               "mixed": [("w", 1), ("w", 8), ("w", 13), ("w", 14), ("e", 1),
                         ("p", 2)]}[case]
    for leaf, b in corrupt:
        _corrupt(state, leaf, b)
    jout, tout, jd, td, tl = _run_both(state, jred, tred, js, ts, via_store)
    _assert_same(jout, tout, jd, td, tl)
    expect = {"single": (1, 0), "multi": (0, 2), "vulnerable": (0, 1),
              "mixed": (3, 3)}[case]
    assert (tout[1], tout[2]) == expect
    rescrub = ts.scrub(tout[0], tred)
    assert sum(int(m.sum()) for m in rescrub.values()) == expect[1]


def test_repair_mid_flight_refuses_in_flight_stripes():
    """On the overlapped tick, with an update in flight, a block whose
    stripe is in flight is refused (its parity is being rewritten) and a
    block of a clean stripe is rebuilt, as in the reference."""
    state = _np_leaves()
    js, ts = _stores(state, async_tick=True, period=2)
    jl, tl = jnp_leaves(state), convert.leaves_from_numpy(state, "cpu")
    jred, tred = js.init(jl), ts.init(tl)
    ev = np.zeros(32, bool)
    ev[5] = True                           # blocks 10-11 go in flight
    state["w"][5] += np.float32(1.0)
    jred = js.on_write(jred, events={"w": jnp.asarray(ev.copy())})
    tred = ts.on_write(tred, events={"w": torch.from_numpy(ev)})
    jl, tl = jnp_leaves(state), convert.leaves_from_numpy(state, "cpu")
    jred, _ = js.tick(jl, jred, 2)
    tred, _ = ts.tick(tl, tred, 2)
    assert all(g.pending is not None for g in ts.groups.values())
    assert_red_equal(jred, tred, "tick 2 (in flight)")
    _corrupt(state, "w", 9)                # stripe 2: in flight
    _corrupt(state, "w", 21)               # stripe 5: clean
    jout, tout, jd, td, tl = _run_both(state, jred, tred, js, ts)
    _assert_same(jout, tout, jd, td, tl)
    assert (tout[1], tout[2]) == (1, 1)
    assert _records(td) == [("w", 2, (9,), "vulnerable_stripe")]
    js._stop_dispatcher()


def test_unrecoverable_records_match_reference():
    rec = repairs.UnrecoverableBlock("w", 3, (12, 13), "multi_corrupt")
    jrec = jrepairs.UnrecoverableBlock("w", 3, (12, 13), "multi_corrupt")
    assert _records([rec]) == _records([jrec])
    assert repairs.UNRECOVERABLE_REASONS == jrepairs.UNRECOVERABLE_REASONS
    with pytest.raises(AssertionError):
        repairs.UnrecoverableBlock("w", 3, (12,), "bit_rot")
    err = repairs.UnrecoverableReadError("w", [rec])
    assert str(err) == str(jrepairs.UnrecoverableReadError("w", [jrec]))
    assert err.records == (rec,)


def test_await_inflight_orders_export_readers_on_the_cpu():
    """``await_inflight`` adopts nothing (the schedule is unchanged) and
    ``red_to_numpy(red, store)`` equals the plain copy on the CPU, where
    the update wrote new tensors and the live view kept the old epoch."""
    state = _np_leaves()
    _, ts = _stores(state, async_tick=True, period=1)
    tl = convert.leaves_from_numpy(state, "cpu")
    red = ts.init(tl)
    ev = torch.zeros(32, dtype=torch.bool)
    ev[3] = True
    red = ts.on_write(red, events={"w": ev})
    red, _ = ts.tick(tl, red, 1)
    pend = [g.pending for g in ts.groups.values()]
    assert all(p is not None for p in pend)
    assert ts.await_inflight() is ts
    assert [g.pending for g in ts.groups.values()] == pend
    a, b = convert.red_to_numpy(red, ts), convert.red_to_numpy(red)
    for n in a:
        for f in a[n]:
            np.testing.assert_array_equal(a[n][f], b[n][f])
