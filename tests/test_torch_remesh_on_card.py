"""Degraded reads and elastic remesh on the card.

Each test needs a CUDA device and skips without one (decided at run
time).  Grow and shrink under racing writes on the card equal the same run
on the CPU after every tick, every field bit for bit (``RemeshStatus``
too, but for ``overflowed``: the card has no work queue, so it stays 0);
each migration window is one launch of the fused kernel and a window tick
does not wait for the device; after the flush every field equals a fresh
store's on the new mesh.  ``read_verified`` on the card returns the CPU's
rows in its four cases, with one checksum launch a block, and reads the
strided shards of a KV cache.  The module imports no JAX, so on the card
it runs with:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_remesh_on_card.py -k on_card
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import ProtectedStore, RedundancyPolicy, UnrecoverableReadError
from repro_torch.dist import P
from repro_torch.faults import FaultSpec
from repro_torch.faults.inject import apply_fault
from repro_torch.kernels.checksum import ops as ck_ops
from repro_torch.kernels.redundancy import ops as k3_ops
from repro_torch.launch.mesh import make_mesh

AXES = ("pod", "data", "model")
W_SPEC = P(AXES, None)
KV_SPEC = P(None, None, ("pod", "data"), "model", None)
FIELDS = ("checksums", "parity", "dirty", "shadow", "meta_ck")
SPIN_CYCLES = 500_000_000              # about 0.25 s of one SM's clock


@pytest.fixture()
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _store(device, dims, async_tick=False, **kw):
    pol = RedundancyPolicy.single(
        "vilamb", period_steps=2, lanes_per_block=128, async_tick=async_tick,
        precompile=False, remesh_bytes_per_tick=32 * 128 * 4, **kw)
    w = np.random.default_rng(11).standard_normal((64, 2048)).astype(np.float32)
    lv = {"w": torch.from_numpy(w).to(device)}
    store = ProtectedStore(pol, mesh=make_mesh(dims, AXES, device=device)).attach(
        lv, specs={"w": W_SPEC})
    return store, lv, store.init(lv)


def _remesh_run(device, old, new):
    """Writes of 3 rows a step, a remesh at step 4, 3 steps after it; per
    tick the fields (on the host) and the status; the final state.  The
    blocking tick: with the overlapped one the card's live view holds an
    in-flight update's arrays, the CPU's the previous epoch's (ROADMAP
    Queue 3, difference 1)."""
    store, lv, red = _store(device, old)
    rng = np.random.default_rng(3)
    recs, launches, after = [], [], 0
    for step in range(1, 40):
        if step == 4:
            store.remesh(make_mesh(new, AXES, device=device))
        after += store.geometry_version == 1 and not store.remeshing
        if after > 3:
            break
        rows = torch.as_tensor(np.sort(rng.choice(64, size=3, replace=False)), device=device)
        w = lv["w"].clone()
        w[rows] += 0.25 * step
        lv = {"w": w}
        ev = torch.zeros(64, dtype=torch.bool, device=device).index_fill_(0, rows, True)
        red = store.on_write(red, events={"w": ev})
        before = k3_ops.LAUNCHES
        red, rep = store.tick(lv, red, step, scrub_period=0)
        launches.append(k3_ops.LAUNCHES - before)
        if rep.repaired:
            lv = dict(lv, **rep.repaired)
        store.await_inflight()
        st = None if rep.remesh is None else dataclasses.asdict(rep.remesh)
        recs.append(({f: getattr(red["w"], f).cpu() for f in FIELDS}, st))
    red = store.flush(lv, red, step=step)
    return store, lv, red, recs, launches


@pytest.mark.parametrize("old,new", [((1, 2, 2), (2, 2, 2)), ((2, 2, 2), (1, 2, 2))])
def test_remesh_equals_cpu_on_card(cuda_device, old, new):
    """Grow and shrink under racing writes: the card's fields equal the
    CPU's after every tick and after the flush, its status too (its
    ``overflowed`` 0, the CPU's what its queue gave); each migration window
    is one K3 launch (the start tick's due update, which runs before the
    migration starts, one more); after the flush the fields equal a fresh
    store's on the new mesh and the scrub is clean."""
    store, lv, red, recs, launches = _remesh_run(cuda_device, old, new)
    _, _, cred, crecs, _ = _remesh_run(torch.device("cpu"), old, new)
    assert len(recs) == len(crecs)
    windows = 0
    for i, ((f, st), (cf, cst)) in enumerate(zip(recs, crecs)):
        for k in FIELDS:
            assert torch.equal(f[k], cf[k]), (i, k)
        if st is not None:
            assert st["overflowed"] == 0
            assert dict(st, overflowed=0) == dict(cst, overflowed=0), i
            # The window's K3 alone; the start tick may also run the due
            # update, before the migration exists.
            assert launches[i] == 1 or (st["ticks"] == 1 and launches[i] == 2), (i, launches)
            windows += 1
    assert windows == max(r[1]["ticks"] for r in recs if r[1] is not None) > 1
    for k in FIELDS:
        assert torch.equal(getattr(red["w"], k).cpu(), getattr(cred["w"], k)), k
    fresh = ProtectedStore(store.policy, mesh=store.mesh).attach(lv, specs={"w": W_SPEC})
    want = fresh.init(lv)
    for k in FIELDS:
        assert torch.equal(getattr(red["w"], k), getattr(want["w"], k)), k
    assert store.scrub_check(lv, red) == 0


def test_window_tick_does_not_wait_for_the_device_on_card(cuda_device):
    """A migration window's tick behind a spin on the foreground stream
    returns with the spin still running: the window's marks are built on
    the device and its K3 is queued behind the spin (and the writes)."""
    store, lv, red = _store(cuda_device, (2, 2, 2), async_tick=True)
    store.remesh(make_mesh((1, 2, 2), AXES, device=cuda_device))
    red, rep = store.tick(lv, red, 1, scrub_period=0)           # the start + window 1
    assert rep.remesh is not None and not rep.remesh.done
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    spin = torch.cuda.Event()
    spin.record()
    red, rep = store.tick(lv, red, 2, scrub_period=0)
    assert not spin.query(), "a window tick waited for the device"
    assert rep.remesh.ticks == 2 and not rep.remesh.done
    torch.cuda.synchronize()


def _rv_store(device):
    pol = RedundancyPolicy.single("vilamb", period_steps=2, lanes_per_block=64,
                                  read_retry_attempts=2, precompile=False)
    w = np.random.default_rng(5).standard_normal((16, 512)).astype(np.float32)
    lv = {"w": torch.from_numpy(w).to(device)}
    store = ProtectedStore(pol, device=device).attach(lv)
    red = store.init(lv)
    return store, lv, store.flush(lv, red, step=0)


def _rv_cases(device):
    store, lv, red = _rv_store(device)
    out = dict(store.read_verified(lv, red, "w", [0, 5]))
    lv2, red2 = apply_fault(store.metas, lv, red, FaultSpec("data_bitflip", "w", block=3,
                                                            lane=1, bit=7))
    before = ck_ops.LAUNCHES
    out["recon"] = store.read_verified(lv2, red2, "w", [3])[3]
    n_k1 = ck_ops.LAUNCHES - before
    w = lv["w"].clone()
    w[0] += 1.0
    red3 = store.on_write(red, events={"w": torch.zeros(16, dtype=torch.bool, device=device)
                                       .index_fill_(0, torch.tensor([0], device=device), True)})
    out["window"] = store.read_verified({"w": w}, red3, "w", [0])[0]
    for b in (0, 1):
        lv, red = apply_fault(store.metas, lv, red, FaultSpec("data_bitflip", "w", block=b,
                                                              lane=0, bit=1))
    with pytest.raises(UnrecoverableReadError) as e:
        store.read_verified(lv, red, "w", [0, 1])
    out["unrec"] = [(r.leaf, r.stripe, r.blocks, r.reason) for r in e.value.records]
    return out, n_k1


def test_read_verified_equals_cpu_on_card(cuda_device):
    """The four cases on the card return the CPU's rows and records; the
    reconstructed read checksums the block and then its candidate, one K1
    launch each."""
    got, n_k1 = _rv_cases(cuda_device)
    want, _ = _rv_cases(torch.device("cpu"))
    assert n_k1 == 2
    for k in want:
        if k == "unrec":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_read_verified_strided_cache_on_card(cuda_device):
    """A KV cache under cache_specs (strided shards): clean blocks of every
    shard, one in the window and one flipped (in layer 1, whose stripes no
    write marked) and rebuilt from its stripe, equal the CPU's rows and
    the cache's own lane rows."""
    rng = np.random.default_rng(9)
    kv = torch.from_numpy(rng.standard_normal((3, 32, 8, 2, 16)).astype(np.float32)
                          ).to(torch.bfloat16)

    def run(device):
        pol = RedundancyPolicy.single("vilamb", period_steps=2, lanes_per_block=128,
                                      precompile=False)
        x = kv.to(device).clone()
        store = ProtectedStore(pol, mesh=make_mesh((2, 2, 2), AXES, device=device)).attach(
            {"kv": x}, specs={"kv": KV_SPEC})
        red = store.init({"kv": x})
        nb = store.metas["kv"].n_blocks
        ev = torch.zeros((3, 32), dtype=torch.bool, device=device)
        ev[0, 5] = True                 # layer 0's stripes only: layer 1's stay clean
        red = store.on_write(red, events={"kv": ev})
        x.view(torch.int16)[1, 9, 4, 1, 3] ^= 1 << 4   # one block of one shard
        flipped = torch.nonzero(store.scrub({"kv": x}, red)["kv"]).flatten().tolist()
        assert len(flipped) == 1
        ids = [s * nb + b for s in range(8) for b in (0, nb - 1)] + flipped + [5 * nb + 1]
        return store.read_verified({"kv": x}, red, "kv", ids), ids, flipped[0]

    got, ids, flipped = run(cuda_device)
    want, ids_cpu, flipped_cpu = run(torch.device("cpu"))
    assert ids == ids_cpu and flipped == flipped_cpu
    for b in ids:
        np.testing.assert_array_equal(got[b], want[b], err_msg=str(b))
    store = ProtectedStore(RedundancyPolicy.single("vilamb", lanes_per_block=128,
                                                   precompile=False),
                           mesh=make_mesh((2, 2, 2), AXES, device="cpu")).attach(
        {"kv": kv}, specs={"kv": KV_SPEC})
    lanes = store.engine_for("kv").lanes_by_shard(kv, "kv").reshape(-1, 128)
    np.testing.assert_array_equal(got[flipped], lanes[flipped].numpy().view(np.uint32))
