"""repro_torch core primitives against the JAX reference, bit for bit:
bits, blocks, checksum, parity and the work queue."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_helpers import (assert_bits_equal, assert_masks_equal, rand_u32,
                            special_lanes, t32)
from repro.core import bits as jbits
from repro.core import blocks as jblocks
from repro.core import checksum as jck
from repro.core import parity as jpar
from repro.core import workqueue as jwq
from repro_torch.core import bits as tbits
from repro_torch.core import blocks as tblocks
from repro_torch.core import checksum as tck
from repro_torch.core import parity as tpar
from repro_torch.core import workqueue as twq
from repro_torch.core import convert


# ------------------------------------------------------------------- bits
@pytest.mark.parametrize("n_bits", [1, 31, 32, 33, 100])
def test_bits_pack_unpack_mark_popcount(n_bits):
    rng = np.random.default_rng(n_bits)
    m = rng.random(n_bits) < 0.4
    m2 = rng.random(n_bits) < 0.4
    jw = jbits.pack_mask(jnp.asarray(m))
    tw = tbits.pack_mask(torch.from_numpy(m))
    assert_bits_equal(jw, tw)
    assert_masks_equal(jbits.unpack(jw, n_bits), tbits.unpack(tw, n_bits))
    assert_bits_equal(jbits.mark(jw, jnp.asarray(m2)),
                      tbits.mark(tw, torch.from_numpy(m2)))
    assert int(jbits.popcount(jw)) == int(tbits.popcount(tw))
    assert_bits_equal(jbits.zeros(n_bits), tbits.zeros(n_bits))


def test_bits_unpack_rows_high_bit():
    rng = np.random.default_rng(1)
    words = rand_u32(rng, 3 * 2)
    words[0] |= np.uint32(0x80000000)
    assert_masks_equal(jbits.unpack_rows(jnp.asarray(words), 3, 40),
                       tbits.unpack_rows(t32(words), 3, 40))


# ----------------------------------------------------------------- blocks
LEAVES = [
    ((24, 200), np.float32),
    ((7, 13), ml_dtypes.bfloat16),       # odd element count, sub-word
    ((3, 5, 7), np.float16),             # odd element count, sub-word
    ((99,), np.int8),                    # odd, four elements per word
    ((8, 128), np.float32),              # fills its blocks: a view
    ((), np.float32),
]


def _leaf(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "i":
        return rng.integers(-128, 127, size=shape).astype(dtype)
    return rng.standard_normal(shape).astype(np.float32).astype(dtype)


@pytest.mark.parametrize("shape,dtype", LEAVES)
@pytest.mark.parametrize("lpb", [128, 256])
def test_blocks_to_from_lanes(shape, dtype, lpb):
    a = _leaf(shape, dtype)
    jm = jblocks.make_meta(jnp.asarray(a), lanes_per_block=lpb)
    t = convert.leaves_from_numpy({"x": a}, device="cpu")["x"]
    tm = tblocks.make_meta(t, lanes_per_block=lpb)
    for f in ("shape", "dtype", "lanes_per_block", "stripe_data_blocks"):
        assert getattr(jm, f) == getattr(tm, f), f
    assert (jm.n_blocks, jm.n_stripes, jm.n_lanes) == (tm.n_blocks, tm.n_stripes, tm.n_lanes)
    jl = jblocks.to_lanes(jnp.asarray(a), jm)
    tl = tblocks.to_lanes(t, tm)
    assert_bits_equal(jl, tl)
    back = convert.leaves_to_numpy({"x": tblocks.from_lanes(tl, tm)})["x"]
    assert back.dtype == np.asarray(a).dtype
    np.testing.assert_array_equal(back.reshape(-1).view(np.uint8),
                                  np.asarray(a).reshape(-1).view(np.uint8))


def test_to_lanes_is_a_view_when_unpadded():
    t = torch.zeros((16, 1024), dtype=torch.float32)
    m = tblocks.make_meta(t, lanes_per_block=1024)
    lanes = tblocks.to_lanes(t, m)
    assert lanes.data_ptr() == t.data_ptr()
    lanes[3, 5] = 7
    assert t.view(torch.int32)[3, 5] == 7


@pytest.mark.parametrize("shape,dtype,lpb", [
    ((64, 64), np.float32, 128),     # rows pack evenly: reshape branch
    ((10, 64), np.float32, 256),     # reshape branch, fewer row groups than blocks
    ((24, 200), np.float32, 128),    # rows straddle blocks: scatter branch
    ((9, 3, 50), ml_dtypes.bfloat16, 128),
])
def test_row_mask_block_mask_branches(shape, dtype, lpb):
    rng = np.random.default_rng(3)
    a = _leaf(shape, dtype)
    jm = jblocks.make_meta(jnp.asarray(a), lanes_per_block=lpb)
    tm = tblocks.make_meta(convert.leaves_from_numpy({"x": a}, device="cpu")["x"],
                           lanes_per_block=lpb)
    for row_dims in (1, 2) if len(shape) > 2 else (1,):
        rm = rng.random(shape[:row_dims]) < 0.3
        assert_masks_equal(
            jblocks.row_mask_block_mask(jm, jnp.asarray(rm), row_dims),
            tblocks.row_mask_block_mask(tm, torch.from_numpy(rm), row_dims))
    ids = np.array([0, 5, -1, shape[0] - 1, 5], np.int32)
    assert_masks_equal(jblocks.row_block_mask(jm, jnp.asarray(ids)),
                       tblocks.row_block_mask(tm, torch.from_numpy(ids)))
    bd = rng.random(jm.n_blocks) < 0.3
    assert_masks_equal(jblocks.stripe_dirty_mask(jm, jnp.asarray(bd)),
                       tblocks.stripe_dirty_mask(tm, torch.from_numpy(bd)))


# --------------------------------------------------------------- checksum
def test_fmix32_and_salt():
    rng = np.random.default_rng(4)
    x = np.concatenate([rand_u32(rng, 1000), special_lanes(1, 6)[0]])
    assert_bits_equal(jck.fmix32(jnp.asarray(x)), tck.fmix32(t32(x)))
    b = np.arange(7, dtype=np.uint32)[:, None] + np.uint32(2**31 - 3)
    l = np.arange(130, dtype=np.uint32)[None, :]
    assert_bits_equal(jck.lane_salt(jnp.asarray(b), jnp.asarray(l)),
                      tck.lane_salt(t32(b), t32(l)))


@pytest.mark.parametrize("nb,L,offset", [(1, 128, 0), (13, 256, 0), (5, 512, 77),
                                         (4, 128, 2**31 + 5)])
def test_checksums_diff_meta(nb, L, offset):
    rng = np.random.default_rng(nb)
    old = rand_u32(rng, nb, L)
    new = old.copy()
    new[rng.integers(0, nb), rng.integers(0, L)] ^= np.uint32(0x10)
    jc = jck.block_checksums(jnp.asarray(old), block_offset=offset)
    tc = tck.block_checksums(t32(old), block_offset=offset)
    assert_bits_equal(jc, tc)
    assert_bits_equal(jck.checksum_diff(jnp.asarray(old), jnp.asarray(new), offset),
                      tck.checksum_diff(t32(old), t32(new), offset))
    assert_bits_equal(jck.meta_checksum(jc), tck.meta_checksum(tc))
    ids = rng.permutation(nb).astype(np.int32)[: max(1, nb // 2)]
    ov, nv = rand_u32(rng, len(ids)), rand_u32(rng, len(ids))
    assert_bits_equal(
        jck.meta_checksum_delta(jnp.asarray(ov), jnp.asarray(nv), jnp.asarray(ids)),
        tck.meta_checksum_delta(t32(ov), t32(nv), torch.from_numpy(ids)))


def test_checksum_special_values():
    lanes = special_lanes(5, 256)
    assert_bits_equal(jck.block_checksums(jnp.asarray(lanes)),
                      tck.block_checksums(t32(lanes)))


# ----------------------------------------------------------------- parity
@pytest.mark.parametrize("nb,L,P", [(1, 128, 4), (9, 256, 2), (13, 128, 4), (10, 128, 5)])
def test_parity_masked_diff(nb, L, P):
    rng = np.random.default_rng(nb * P)
    a, b = rand_u32(rng, nb, L), rand_u32(rng, nb, L)
    jp = jpar.stripe_parity(jnp.asarray(a), P)
    tp = tpar.stripe_parity(t32(a), P)
    assert_bits_equal(jp, tp)
    sd = rng.random(jp.shape[0]) < 0.5
    old = rand_u32(rng, *jp.shape)
    assert_bits_equal(
        jpar.stripe_parity_masked(jnp.asarray(b), jnp.asarray(old), jnp.asarray(sd), P),
        tpar.stripe_parity_masked(t32(b), t32(old), torch.from_numpy(sd), P))
    assert_bits_equal(jpar.parity_diff(jnp.asarray(a), jnp.asarray(b), P),
                      tpar.parity_diff(t32(a), t32(b), P))


@pytest.mark.parametrize("n", [1, 2, 7, 33])
def test_scatter_xor_stripes_duplicates_and_sentinels(n):
    rng = np.random.default_rng(n)
    ns, L = 6, 128
    par = rand_u32(rng, ns, L)
    ids = rng.integers(0, ns + 2, size=n).astype(np.int32)   # dups + out of range
    deltas = rand_u32(rng, n, L)
    want = jpar.scatter_xor_stripes(jnp.asarray(par), jnp.asarray(ids), jnp.asarray(deltas))
    got = tpar.scatter_xor_stripes(t32(par), torch.from_numpy(ids), t32(deltas))
    assert_bits_equal(want, got)


@pytest.mark.parametrize("block_id", [8, 9])
def test_reconstruct_block_partial_last_stripe(block_id):
    rng = np.random.default_rng(block_id)
    nb, L, P = 10, 128, 4                 # last stripe holds blocks 8, 9
    lanes = rand_u32(rng, nb, L)
    par = np.asarray(jpar.stripe_parity(jnp.asarray(lanes), P))
    want = jpar.reconstruct_block(jnp.asarray(lanes), jnp.asarray(par[2]), P, block_id, 2)
    got = tpar.reconstruct_block(t32(lanes), t32(par[2]), P, block_id, 2)
    assert_bits_equal(want, got)
    assert_bits_equal(lanes[block_id], got)


# ------------------------------------------------------------- work queue
@pytest.mark.parametrize("ns,size,p", [(10, 5, 0.3), (10, 5, 0.9), (10, 5, 0.0),
                                       (12, 12, 0.5), (1, 1, 1.0), (40, 8, 0.15)])
@pytest.mark.parametrize("repeat", [False, True])
def test_compact_stripe_ids(ns, size, p, repeat):
    rng = np.random.default_rng(ns * size)
    sd = rng.random(ns) < p
    j = jwq.compact_stripe_ids(jnp.asarray(sd), size, pad_repeat_last=repeat)
    t = twq.compact_stripe_ids(torch.from_numpy(sd), size, pad_repeat_last=repeat)
    np.testing.assert_array_equal(np.asarray(j[0]), t[0].numpy())
    assert int(j[1]) == int(t[1]) and bool(j[2]) == bool(t[2])


def test_queue_capacity_matches():
    for ns in (1, 2, 10, 100, 524288):
        for frac in (0.0, 0.125, 0.5, 1.0):
            assert jwq.queue_capacity(ns, frac) == twq.queue_capacity(ns, frac)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_queued_and_full_update(seed):
    rng = np.random.default_rng(seed)
    nb, L, P = 38, 128, 4                 # 10 stripes, last one partial
    lanes = rand_u32(rng, nb, L)
    old_cks = rand_u32(rng, nb)
    old_par = rand_u32(rng, 10, L)
    old_meta = np.asarray(jck.meta_checksum(jnp.asarray(old_cks)))
    bd = np.zeros(nb, bool)
    for s in rng.choice(10, size=rng.integers(0, 6), replace=False):
        blk = np.arange(s * P, min((s + 1) * P, nb))
        bd[rng.choice(blk, size=rng.integers(1, len(blk) + 1), replace=False)] = True
    sd = np.array(jblocks.stripe_dirty_mask(
        jblocks.BlockMeta((nb * L,), "uint32", L, P), jnp.asarray(bd)))
    jids = jwq.compact_stripe_ids(jnp.asarray(sd), 5)[0]
    tids = twq.compact_stripe_ids(torch.from_numpy(sd), 5)[0]
    j = jwq.queued_update(jnp.asarray(lanes), jnp.asarray(old_cks), jnp.asarray(old_par),
                          jnp.asarray(old_meta), jnp.asarray(bd), jids, P)
    t = twq.queued_update(t32(lanes), t32(old_cks), t32(old_par), t32(old_meta),
                          torch.from_numpy(bd), tids, P)
    for a, b in zip(j, t):
        assert_bits_equal(a, b)
    jf = jwq.full_update(jnp.asarray(lanes), jnp.asarray(old_cks), jnp.asarray(old_par),
                         jnp.asarray(bd), jnp.asarray(sd), P)
    tf = twq.full_update(t32(lanes), t32(old_cks), t32(old_par),
                         torch.from_numpy(bd), torch.from_numpy(sd), P)
    for a, b, c in zip(jf, tf, t):
        assert_bits_equal(a, b)
        assert_bits_equal(b, c)          # queued == full on their shared domain
