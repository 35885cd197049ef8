"""repro_torch RedundancyEngine against the JAX engine, bit for bit.

Each case seeds the port from the reference's own state
(``convert.red_from_numpy``), runs one engine operation in both packages
on the same numpy leaves, and compares every state field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_helpers import (assert_bits_equal, assert_masks_equal,
                            assert_red_equal, jnp_leaves, red_jax_to_numpy)
from repro.core import ALL as JALL
from repro.core import RedundancyConfig as JConfig
from repro.core import RedundancyEngine as JEngine
from repro_torch.core import ALL, RedundancyConfig, RedundancyEngine, convert


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((24, 200)).astype(np.float32),   # 38 blocks, partial stripe
        "e": rng.standard_normal((16, 64)).astype(ml_dtypes.bfloat16),
        "h": rng.standard_normal((16, 128)).astype(np.float32),   # one block per row
    }


def _engines(np_leaves, frac=0.5):
    kw = dict(lanes_per_block=128, stripe_data_blocks=4, work_queue_frac=frac)
    jeng = JEngine({k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                    for k, v in np_leaves.items()}, JConfig(**kw))
    teng = RedundancyEngine(convert.leaves_from_numpy(np_leaves, device="cpu"),
                            RedundancyConfig(**kw), device="cpu")
    return jeng, teng


def _port(jred):
    return convert.red_from_numpy(red_jax_to_numpy(jred), device="cpu")


def _events(rng):
    return {"w": rng.random(24) < 0.2, "e": rng.random(16) < 0.3,
            "h": rng.random(16) < 0.25}


def _jev(evs):
    return {k: JALL if isinstance(v, str) else jnp.asarray(v) for k, v in evs.items()}


def _tev(evs):
    return {k: ALL if isinstance(v, str) else torch.from_numpy(v) for k, v in evs.items()}


def test_init_and_geometry():
    lv = _leaves()
    jeng, teng = _engines(lv)
    for n in lv:
        assert jeng.queue_capacity(n) == teng.queue_capacity(n)
        assert jeng.metas[n].n_blocks == teng.metas[n].n_blocks
    assert_red_equal(jeng.init(jnp_leaves(lv)),
                     teng.init(convert.leaves_from_numpy(lv, device="cpu")))


@pytest.mark.parametrize("ev_w", ["all", "rows"])
def test_mark_dirty_all_fast_and_rowmask_paths(ev_w):
    lv = _leaves(1)
    jeng, teng = _engines(lv)
    jred = jeng.init(jnp_leaves(lv))
    evs = _events(np.random.default_rng(2))
    if ev_w == "all":
        evs["w"] = "all"
    jred2 = jeng.mark_dirty(jred, _jev(evs))
    tred2 = teng.mark_dirty(_port(jred), _tev(evs))
    assert_red_equal(jred2, tred2)
    stats_j, stats_t = jeng.dirty_stats(jred2), teng.dirty_stats(tred2)
    for n in lv:
        for k in ("dirty_blocks", "vulnerable_stripes", "total_blocks", "total_stripes"):
            assert int(stats_j[n][k]) == int(stats_t[n][k]), (n, k)
    for n, m in jeng.vulnerable_masks(jred2).items():
        assert_masks_equal(m, teng.vulnerable_masks(tred2)[n])


@pytest.mark.parametrize("queued,seed", [(False, 0), (True, 1), (True, 2), (False, 3)])
def test_redundancy_step_queued_and_full(queued, seed):
    lv = _leaves(seed)
    jeng, teng = _engines(lv)
    rng = np.random.default_rng(seed)
    jred = jeng.mark_dirty(jeng.init(jnp_leaves(lv)), _jev(_events(rng)))
    # A leftover shadow word (a crash mid-update) must be folded in too.
    jred = dict(jred, h=dataclasses.replace(
        jred["h"], shadow=jred["h"].shadow | jnp.uint32(1 << 9)))
    new = {k: (v.astype(np.float32) + 1).astype(v.dtype) for k, v in lv.items()}
    assert jeng.queue_fits(jred) == teng.queue_fits(_port(jred))
    step_j = jeng.redundancy_step_queued if queued else jeng.redundancy_step
    step_t = teng.redundancy_step_queued if queued else teng.redundancy_step
    assert_red_equal(step_j(jnp_leaves(new), jred),
                     step_t(convert.leaves_from_numpy(new, device="cpu"),
                            _port(jred)))


def test_sync_update_dense_and_rows():
    lv = _leaves(4)
    jeng, teng = _engines(lv)
    jred = jeng.init(jnp_leaves(lv))
    new = {k: (v.astype(np.float32) * 0.5 + 3).astype(v.dtype) for k, v in lv.items()}
    assert_red_equal(
        jeng.sync_update(jnp_leaves(lv), jnp_leaves(new), jred),
        teng.sync_update(convert.leaves_from_numpy(lv, device="cpu"),
                         convert.leaves_from_numpy(new, device="cpu"),
                         _port(jred)))
    rows = np.array([1, 2, 3, 9, 15], np.int32)       # rows 1-3 share a stripe
    vals = np.random.default_rng(5).standard_normal((5, 128)).astype(np.float32)
    want = jeng.sync_update_rows("h", jred["h"], jnp.asarray(rows),
                                 jnp.asarray(lv["h"][rows]), jnp.asarray(vals))
    got = teng.sync_update_rows("h", _port(jred)["h"], torch.from_numpy(rows),
                                torch.from_numpy(lv["h"][rows]), torch.from_numpy(vals))
    assert_red_equal({"h": want}, {"h": got})


@pytest.mark.parametrize("block", [5, 37])           # 37: partial last stripe
def test_scrub_recover_verify_meta(block):
    lv = _leaves(6)
    jeng, teng = _engines(lv)
    jred = jeng.init(jnp_leaves(lv))
    bad = {k: v.copy() for k, v in lv.items()}
    bad["w"].reshape(-1).view(np.uint32)[block * 128 + 3] ^= np.uint32(0xBAD)
    tbad = convert.leaves_from_numpy(bad, device="cpu")
    tred = _port(jred)
    jm, tm = jeng.scrub(jnp_leaves(bad), jred), teng.scrub(tbad, tred)
    for n in lv:
        assert_masks_equal(jm[n], tm[n], n)
    assert np.flatnonzero(tm["w"].numpy()).tolist() == [block]
    jfix, jok = jeng.recover_block(jnp.asarray(bad["w"]), jred["w"], "w", block)
    tfix, tok = teng.recover_block(tbad["w"], tred["w"], "w", block)
    assert bool(jok) and tok
    assert_bits_equal(np.asarray(jfix).view(np.uint32), tfix.numpy().view(np.uint32))
    np.testing.assert_array_equal(tfix.numpy(), lv["w"])
    assert all(bool(v) for v in teng.verify_meta(tred).values())
    broken = dict(tred, w=dataclasses.replace(tred["w"], meta_ck=tred["w"].meta_ck ^ 1))
    assert not bool(teng.verify_meta(broken)["w"])


def test_recover_refused_on_vulnerable_stripe():
    lv = _leaves(7)
    jeng, teng = _engines(lv)
    ev = {"h": np.arange(16) == 1}
    jred = jeng.mark_dirty(jeng.init(jnp_leaves(lv)), _jev(ev))
    tred = _port(jred)
    leaf = convert.leaves_from_numpy(lv, device="cpu")["h"]
    _, jok = jeng.recover_block(jnp.asarray(lv["h"]), jred["h"], "h", 2)
    out, tok = teng.recover_block(leaf, tred["h"], "h", 2)
    assert bool(jok) == tok is False
    np.testing.assert_array_equal(out.numpy(), lv["h"])
