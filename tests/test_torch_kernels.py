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


@pytest.mark.parametrize("ns,p", [(1, 0.0), (7, 1.0), (40, 0.3), (513, 0.05)])
def test_work_queue_lists_dirty_stripes_in_order(ns, p):
    sd = np.random.default_rng(ns).random(ns) < p
    ids, count = trops._work_queue(torch.from_numpy(sd))
    assert count.dtype == ids.dtype == torch.int32 and count.shape == (1,)
    assert int(count) == sd.sum()
    np.testing.assert_array_equal(ids[:int(count)].numpy(), np.flatnonzero(sd))


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
