"""The port's kernel wrappers against the reference's Pallas kernels.

On the CPU each wrapper runs its plain version (``ref.py``); it is held bit
for bit against the JAX ``ops`` wrapper with ``use_pallas=True,
interpret=True``, as the reference's tests/test_kernels.py runs it.  The
``*_on_card`` tests hold each CUDA kernel against its plain version and
skip where no card is present.  The module imports no JAX itself, so the
card tests also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels.py -k on_card
"""
import types

import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container lacks hypothesis: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

from _torch_helpers import assert_bits_equal, rand_u32, special_lanes, t32
from repro_torch.kernels.checksum import ops as tcops
from repro_torch.kernels.checksum import ref as tcref
from repro_torch.kernels.parity import ops as tpops
from repro_torch.kernels.parity import ref as tpref
from repro_torch.kernels.redundancy import ops as trops
from repro_torch.kernels.redundancy import ref as trref


@pytest.fixture(scope="module")
def ref():
    """The reference's Pallas kernel wrappers (run in interpret mode)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.checksum import ops as checksum
    from repro.kernels.parity import ops as parity
    from repro.kernels.redundancy import ops as fused
    return types.SimpleNamespace(jnp=jnp, checksum=checksum, parity=parity,
                                 fused=fused)


@pytest.fixture()
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def bits_of(bd: torch.Tensor) -> torch.Tensor:
    """A bool block mask packed into dirty words on its device."""
    from repro_torch.core import bits
    return bits.pack_mask(bd)


def _stripe_mask_t(bd: torch.Tensor, sw: int) -> torch.Tensor:
    return torch.from_numpy(_stripe_mask(bd.cpu().numpy(), sw)).to(bd.device)


def _stripe_mask(bd, sw):
    nb = len(bd)
    ns = -(-nb // sw)
    pad = np.zeros(ns * sw, bool)
    pad[:nb] = bd
    return pad.reshape(ns, sw).any(axis=1)


@pytest.mark.parametrize("nb,L,offset", [(1, 128, 0), (3, 128, 0), (13, 512, 0),
                                         (8, 1024, 0), (5, 256, 9)])
def test_checksum_plain_vs_pallas(ref, nb, L, offset):
    lanes = rand_u32(np.random.default_rng(nb), nb, L)
    want = ref.checksum.block_checksums(ref.jnp.asarray(lanes), block_offset=offset,
                                 use_pallas=True, interpret=True)
    before = tcops.LAUNCHES
    assert_bits_equal(want, tcops.block_checksums(t32(lanes), offset))
    assert tcops.LAUNCHES == before          # a CPU tensor launches nothing


@pytest.mark.parametrize("nb,L,sw", [(1, 128, 4), (9, 256, 2), (13, 512, 4),
                                     (10, 128, 5)])
def test_parity_plain_vs_pallas(ref, nb, L, sw):
    lanes = rand_u32(np.random.default_rng(nb * sw), nb, L)
    want = ref.parity.stripe_parity(ref.jnp.asarray(lanes), stripe_width=sw, interpret=True)
    assert_bits_equal(want, tpops.stripe_parity(t32(lanes), sw))


def _words(bd, junk=False) -> np.ndarray:
    """``bd`` packed into uint32 words, little-endian bits; with ``junk``
    every bit past the last block is set (the kernel must ignore them)."""
    nw = max(1, -(-len(bd) // 32))
    bitv = np.full(nw * 32, bool(junk))
    bitv[:len(bd)] = bd
    return (bitv.reshape(nw, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)
            ).sum(axis=1).astype(np.uint32)


def _dirty(rng, nb, kind):
    return {"zero": np.zeros(nb, bool), "one": np.arange(nb) == rng.integers(nb),
            "all": np.ones(nb, bool), "random": rng.random(nb) < 0.4}[kind]


def _many_vs_pallas(ref, leaves, sw, junk=False):
    """The grouped plain version over ``leaves`` (``(lanes, old checksums,
    old parity, block dirty)`` each, numpy) in one call, held leaf by leaf
    against the reference's Pallas ``fused_update`` in interpret mode."""
    jobs = [(t32(lanes), t32(c), t32(p), t32(_words(bd, junk))) for lanes, c, p, bd in leaves]
    before = trops.LAUNCHES
    got = trops.fused_update_many(jobs, sw)
    assert trops.LAUNCHES == before              # a CPU tensor launches nothing
    j = ref.jnp.asarray
    for i, ((lanes, c, p, bd), job, (gc, gp)) in enumerate(zip(leaves, jobs, got)):
        assert gc is job[1] and gp is job[2]     # in place
        wc, wp = ref.fused.fused_update(j(lanes), j(c), j(p), j(bd), j(_stripe_mask(bd, sw)),
                                        sw, use_pallas=True, interpret=True)
        assert_bits_equal(wc, gc, f"leaf {i} checksums")
        assert_bits_equal(wp, gp, f"leaf {i} parity")


@pytest.mark.parametrize("L", [128, 256, 1024])
@pytest.mark.parametrize("sw", [2, 4, 5])
def test_fused_many_plain_vs_pallas(ref, L, sw):
    """One grouped call over four leaves: a partial last stripe, whole
    stripes, a single block; zero, one, all and random dirty blocks."""
    rng = np.random.default_rng(L * sw)
    leaves = []
    for nb, kind in ((3 * sw + 1, "zero"), (2 * sw, "one"), (1, "all"),
                     (5 * sw - 1, "random")):
        ns = -(-nb // sw)
        leaves.append((rand_u32(rng, nb, L), rand_u32(rng, nb), rand_u32(rng, ns, L),
                       _dirty(rng, nb, kind)))
    _many_vs_pallas(ref, leaves, sw, junk=L == 256)


def test_fused_many_special_lanes(ref):
    """NaN/Inf/zero/saturated payloads in two leaves of one call, the
    words packed from the same masks, with junk bits past the last block."""
    leaves = []
    for nb, offset, dirty in ((12, 2, np.arange(12) % 5 == 0), (9, 5, np.ones(9, bool))):
        lanes = special_lanes(nb, 256, offset=offset)
        cks = np.asarray(tcref.block_checksums(t32(lanes))).view(np.uint32) ^ np.uint32(0xDEAD)
        par = np.asarray(tpref.stripe_parity(t32(lanes), 4)).view(np.uint32) ^ np.uint32(0xBEEF)
        leaves.append((lanes, cks, par, dirty))
    _many_vs_pallas(ref, leaves, 4, junk=True)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 100), st.integers(1, 3), st.sampled_from([128, 256]),
       st.sampled_from([1, 2, 4]), st.data())
def test_fused_many_plain_vs_pallas_property(ref, seed, n_leaves, L, sw, data):
    rng = np.random.default_rng(seed)
    leaves = []
    for _ in range(n_leaves):
        nb = data.draw(st.integers(1, 14))
        bd = np.array(data.draw(st.lists(st.booleans(), min_size=nb, max_size=nb)))
        leaves.append((rand_u32(rng, nb, L), rand_u32(rng, nb),
                       rand_u32(rng, -(-nb // sw), L), bd))
    _many_vs_pallas(ref, leaves, sw, junk=bool(seed % 2))


def _fused_both(ref, lanes, old_cks, old_par, bd, sd, sw):
    j = ref.jnp.asarray
    want = ref.fused.fused_update(j(lanes), j(old_cks), j(old_par), j(bd), j(sd), sw,
                                  use_pallas=True, interpret=True)
    cks, par = t32(old_cks), t32(old_par)
    got = trops.fused_update(t32(lanes), cks, par, torch.from_numpy(bd),
                             torch.from_numpy(sd), sw)
    assert got[0] is cks and got[1] is par   # in place
    return want, got


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 100), st.integers(1, 14), st.sampled_from([128, 256]),
       st.sampled_from([2, 4]), st.data())
def test_fused_plain_vs_pallas_property(ref, seed, nb, L, sw, data):
    rng = np.random.default_rng(seed)
    lanes = rand_u32(rng, nb, L)
    bd = np.array(data.draw(st.lists(st.booleans(), min_size=nb, max_size=nb)))
    sd = _stripe_mask(bd, sw)
    old_cks = rand_u32(rng, nb)
    old_par = rand_u32(rng, len(sd), L)
    (jc, jp), (tc, tp) = _fused_both(ref, lanes, old_cks, old_par, bd, sd, sw)
    assert_bits_equal(jc, tc)
    assert_bits_equal(jp, tp)


def test_fused_special_values_and_zero_dirty(ref):
    lanes = special_lanes(12, 256, offset=2)
    old_cks = np.asarray(tcref.block_checksums(t32(lanes))).view(np.uint32) ^ np.uint32(0xDEAD)
    old_par = np.asarray(tpref.stripe_parity(t32(lanes), 4)).view(np.uint32) ^ np.uint32(0xBEEF)
    bd = np.zeros(12, bool)
    bd[[0, 5, 11]] = True
    (jc, jp), (tc, tp) = _fused_both(ref, lanes, old_cks, old_par, bd,
                                     np.ones(3, bool), 4)
    assert_bits_equal(jc, tc)
    assert_bits_equal(jp, tp)
    (jc, jp), (tc, tp) = _fused_both(ref, lanes, old_cks, old_par, np.zeros(12, bool),
                                     np.zeros(3, bool), 4)
    assert_bits_equal(jc, tc)
    assert_bits_equal(tc, old_cks)
    assert_bits_equal(tp, old_par)


def test_fused_clean_stripes_untouched(ref):
    """Clean stripes stay byte-identical; only the dirty stripe changes."""
    lanes = rand_u32(np.random.default_rng(5), 12, 256)
    old_cks = np.arange(12, dtype=np.uint32) * 7
    old_par = np.full((3, 256), 0xABC, np.uint32)
    bd = np.zeros(12, bool)
    bd[5] = True
    (jc, jp), (tc, tp) = _fused_both(ref, lanes, old_cks, old_par, bd,
                                     _stripe_mask(bd, 4), 4)
    assert_bits_equal(jc, tc)
    assert_bits_equal(jp, tp)
    keep = np.arange(12) != 5
    assert_bits_equal(tc.numpy().view(np.uint32)[keep], old_cks[keep])
    assert_bits_equal(tp[[0, 2]], old_par[[0, 2]])


# ------------------------------------------------------------ on the card
@pytest.mark.parametrize("nb,L,offset", [(13, 128, 0), (9, 1024, 77), (6, 16384, 3)])
def test_checksum_kernel_on_card(cuda_device, nb, L, offset):
    lanes = t32(rand_u32(np.random.default_rng(nb), nb, L)).to(cuda_device)
    before = tcops.LAUNCHES
    got = tcops.block_checksums(lanes, offset)
    torch.cuda.synchronize()
    assert tcops.LAUNCHES == before + 1
    assert torch.equal(got, tcref.block_checksums(lanes, offset))


@pytest.mark.parametrize("nb,L,sw", [(13, 128, 4), (9, 1024, 2), (6, 16384, 4)])
def test_parity_kernel_on_card(cuda_device, nb, L, sw):
    lanes = t32(rand_u32(np.random.default_rng(nb), nb, L)).to(cuda_device)
    got = tpops.stripe_parity(lanes, sw)
    torch.cuda.synchronize()
    assert torch.equal(got, tpref.stripe_parity(lanes, sw))


@pytest.mark.parametrize("nb,L,dirty", [(13, 128, "one"), (13, 1024, "all"),
                                        (10, 16384, "none"), (38, 256, "some")])
def test_fused_kernel_on_card(cuda_device, nb, L, dirty):
    rng = np.random.default_rng(nb)
    lanes = t32(rand_u32(rng, nb, L)).to(cuda_device)
    bd = {"one": np.arange(nb) == nb - 1, "all": np.ones(nb, bool),
          "none": np.zeros(nb, bool), "some": rng.random(nb) < 0.3}[dirty]
    sd = torch.from_numpy(_stripe_mask(bd, 4)).to(cuda_device)
    bd = torch.from_numpy(bd).to(cuda_device)
    old_cks = t32(rand_u32(rng, nb)).to(cuda_device)
    old_par = t32(rand_u32(rng, sd.shape[0], L)).to(cuda_device)
    want = trref.fused_update(lanes, old_cks, old_par, bd, sd, 4)
    got = trops.fused_update(lanes, old_cks.clone(), old_par.clone(), bd, sd, 4)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _card_leaves(dev, sw, seed):
    """A due group's mix at stripe width ``sw``: a 128-block leaf of 64 KiB
    blocks, a 3-stripe leaf of them (its last stripe partial where sw > 1),
    and the heap's 4 KiB rows; none, sparse and all dirty.  Returns jobs'
    tensors ``(lanes, checksums, parity, block dirty)`` on ``dev``."""
    rng = np.random.default_rng(seed)
    out = []
    for nb, L, kind in ((128, 16384, "random"), (3 * sw - (sw > 1), 16384, "all"),
                        (4096, 1024, "zero"), (4096, 1024, "random"),
                        (128, 16384, "zero"), (64, 16384, "all")):
        bd = _dirty(rng, nb, kind) if kind != "random" else rng.random(nb) < 0.1
        out.append(tuple(t32(a).to(dev) if a.dtype != bool else torch.from_numpy(a).to(dev)
                         for a in (rand_u32(rng, nb, L), rand_u32(rng, nb),
                                   rand_u32(rng, -(-nb // sw), L), bd)))
    return out


def _junk_words(bd):
    return t32(_words(bd.cpu().numpy(), junk=True)).to(bd.device)


@pytest.mark.parametrize("sw,with_heap", [(1, True), (4, True), (4, False), (16, True)])
def test_fused_many_kernel_on_card(cuda_device, sw, with_heap):
    """One grouped launch over mixed leaves: bitwise equal to the plain
    version and to one launch a leaf, in place, with junk bits past each
    leaf's last block ignored.  With the heap's rows the launch has enough
    stripes to take them whole; without, it splits them into runs of
    tiles (the one-leaf launches split too)."""
    leaves = _card_leaves(cuda_device, sw, sw)
    if not with_heap:
        leaves = [leaf for leaf in leaves if leaf[0].shape[1] == 16384]
    jobs = [(lanes, c.clone(), p.clone(), _junk_words(bd)) for lanes, c, p, bd in leaves]
    want = trref.fused_update_many(
        [(lanes, c, p, bits_of(bd)) for lanes, c, p, bd in leaves], sw)
    before = trops.LAUNCHES
    got = trops.fused_update_many(jobs, sw)
    torch.cuda.synchronize()
    assert trops.LAUNCHES == before + 1
    singles = [trops.fused_update(lanes, c.clone(), p.clone(), bd, _stripe_mask_t(bd, sw), sw)
               for lanes, c, p, bd in leaves]
    torch.cuda.synchronize()
    assert trops.LAUNCHES == before + 1 + len(leaves)
    for i, (job, (gc, gp), (wc, wp), (sc, sp)) in enumerate(zip(jobs, got, want, singles)):
        assert gc is job[1] and gp is job[2], i
        assert torch.equal(gc, wc) and torch.equal(gp, wp), i
        assert torch.equal(sc, wc) and torch.equal(sp, wp), i


def test_fused_many_two_streams_in_flight_on_card(cuda_device):
    """Two grouped launches of few stripes of 64 KiB blocks (so each splits
    its stripes into runs of tiles and folds their checksums through its
    scratch) in flight at once on two streams, each behind a sleep: each
    equals its plain version, so their scratch is never shared."""
    groups = [[leaf for leaf in _card_leaves(cuda_device, 4, seed) if leaf[0].shape[1] == 16384]
              for seed in (11, 12)]
    want = [trref.fused_update_many([(l, c, p, bits_of(bd)) for l, c, p, bd in grp], 4)
            for grp in groups]
    jobs = [[(l, c.clone(), p.clone(), bits_of(bd)) for l, c, p, bd in grp] for grp in groups]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in groups]
    for st, js in zip(streams, jobs):
        with torch.cuda.stream(st):
            torch.cuda._sleep(50_000_000)
            trops.fused_update_many(js, 4)
    torch.cuda.synchronize()
    for js, ws in zip(jobs, want):
        for (_, c, p, _), (wc, wp) in zip(js, ws):
            assert torch.equal(c, wc) and torch.equal(p, wp)


def test_engine_group_is_one_launch_on_card(cuda_device):
    """An engine of several leaves of mixed shapes (one a padded copy)
    updates them all in one launch, bit for bit as the CPU engine."""
    from repro_torch.core import RedundancyConfig, RedundancyEngine
    rng = np.random.default_rng(5)
    leaves = {"a": rng.standard_normal((300, 1024)).astype(np.float32),
              "b": rng.standard_normal((7, 333)).astype(np.float32),
              "c": rng.standard_normal((64, 4096)).astype(np.float32)}
    leaves = {n: torch.from_numpy(v) for n, v in leaves.items()}
    ev = {"a": torch.from_numpy(rng.random(300) < 0.2), "b": "__all__",
          "c": torch.from_numpy(rng.random(64) < 0.5)}
    new = {n: v * 3 for n, v in leaves.items()}
    cfg = RedundancyConfig(lanes_per_block=4096)
    cpu = RedundancyEngine(leaves, cfg, device="cpu")
    want = cpu.redundancy_step(new, cpu.mark_dirty(cpu.init(leaves), ev))
    card = RedundancyEngine(leaves, cfg)
    red = card.mark_dirty(card.init({n: v.to(cuda_device) for n, v in leaves.items()}),
                          {n: e if isinstance(e, str) else e.to(cuda_device)
                           for n, e in ev.items()})
    before = trops.LAUNCHES
    got = card.redundancy_step({n: v.to(cuda_device) for n, v in new.items()}, red)
    torch.cuda.synchronize()
    assert trops.LAUNCHES == before + 1
    for n in leaves:
        for f in ("checksums", "parity", "dirty", "shadow", "meta_ck"):
            assert torch.equal(getattr(got[n], f).cpu(), getattr(want[n], f)), (n, f)


def test_engine_default_device_on_card(cuda_device):
    """An engine built without ``device=`` targets the card and its update
    goes through K3, bit for bit as the CPU engine's work queue."""
    from repro_torch.core import RedundancyConfig, RedundancyEngine
    rng = np.random.default_rng(3)
    leaf = torch.from_numpy(rng.standard_normal((38, 256)).astype(np.float32))
    cfg = RedundancyConfig(lanes_per_block=256)
    ev = {"x": torch.from_numpy(rng.random(38) < 0.3)}
    new = {"x": leaf * 2}
    cpu = RedundancyEngine({"x": leaf}, cfg, device="cpu")
    want = cpu.redundancy_step(new, cpu.mark_dirty(cpu.init({"x": leaf}), ev))
    card = RedundancyEngine({"x": leaf}, cfg)
    assert card.device.type == "cuda" and card.use_kernels
    gleaf = leaf.to(cuda_device)
    red = card.mark_dirty(card.init({"x": gleaf}),
                          {"x": ev["x"].to(cuda_device)})
    before = trops.LAUNCHES
    got = card.redundancy_step({"x": new["x"].to(cuda_device)}, red)
    torch.cuda.synchronize()
    assert trops.LAUNCHES == before + 1
    for f in ("checksums", "parity", "dirty", "shadow", "meta_ck"):
        assert torch.equal(getattr(got["x"], f).cpu(), getattr(want["x"], f)), f
    with pytest.raises(ValueError, match="lies on cpu"):
        card.redundancy_step(new, got)
