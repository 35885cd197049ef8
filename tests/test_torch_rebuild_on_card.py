"""Cross-shard parity and the shard rebuild on the card.

Each test needs a CUDA device and skips without one (decided at run
time).  K1 over a patrol window of every row-range shard of a leaf, read
in place at the leaf's shard stride, equals its plain version bit for bit;
a shard-loss rebuild on the card equals the same run on the CPU tick by
tick; and the rebuild's paste is ordered after an update held in flight on
the side stream: with the wait the update's parity is the tick's data's,
with it removed the held update reads the pasted rows and the check can
tell; and a rebuild that starts while a write sample is held behind a
spin applies that sample first (with that step removed, rows the sample
alone marks are pasted from stale xpar).  The module imports no JAX, so
on the card it runs with:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_rebuild_on_card.py -k on_card
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import ProtectedStore, RedundancyPolicy, blocks
from repro_torch.dist import P
from repro_torch.faults import FaultSpec
from repro_torch.kernels.checksum import ops as ck_ops, ref as ck_ref
from repro_torch.kernels.parity import ref as par_ref
from repro_torch.launch.mesh import make_mesh

AXES = ("pod", "data", "model")
W_SPEC = P(AXES, None)
HOLD_CYCLES = 200_000_000              # about 0.1 s of one SM's clock
ROWS_LOCAL = 8                         # rows of a shard: 16 blocks a row


@pytest.fixture()
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("L", [128, 1024])
def test_checksum_strided_window_on_card(cuda_device, k, L):
    """K1 over ``lanes[:, start:start + w]`` of a (k, nb, L) leaf: one
    launch reading the view in place (the shards ``nb * L`` lanes apart),
    bit for bit the plain version's, at the first, a middle and the
    clamped last window."""
    nb, w = 37, 11
    g = torch.Generator(device="cpu").manual_seed(k * L)
    leaf = torch.randint(-2**31, 2**31 - 1, (k * nb, L), dtype=torch.int32,
                         generator=g).to(cuda_device)
    meta = blocks.make_meta(blocks.ShapeDtype((nb, L), torch.int32), L)
    for start in (0, 13, nb - w):
        win = blocks.shard_window_lanes(leaf, meta, (k,), start, w)
        assert win.shape == (k, w, L) and win.data_ptr() == leaf[start].data_ptr()
        assert k == 1 or win.stride(0) == nb * L
        before = ck_ops.LAUNCHES
        got = ck_ops.block_checksums(win, start)
        torch.cuda.synchronize()
        assert ck_ops.LAUNCHES == before + 1 and got.shape == (k * w,)
        assert torch.equal(got.cpu(), ck_ref.block_checksums(win.cpu(), start))
        full = ck_ops.block_checksums(leaf.view(k, nb, L)).view(k, nb)
        assert torch.equal(got.view(k, w), full[:, start:start + w])


def _store(device, period_steps=2, **kw):
    pol = RedundancyPolicy.single(
        "vilamb", period_steps=period_steps, lanes_per_block=128, async_tick=True,
        patrol_bytes_per_tick=32 * 128 * 4, precompile=False, **kw)
    w = np.random.default_rng(7).standard_normal((64, 2048)).astype(np.float32)
    lv = {"w": torch.from_numpy(w).to(device)}
    mesh = make_mesh((2, 2, 2), AXES, device=device)
    store = ProtectedStore(pol, mesh=mesh).attach(lv, specs={"w": W_SPEC})
    return store, lv, store.init(lv)


def _rebuild_run(device):
    """Quiet ticks until xpar covers the leaf, a loss of shard 3 declared,
    then ticks with rows of shard 3 rewritten, the rebuild paced at 32
    blocks a tick; the card waits at every tick so its probes land when
    the CPU's do.  Returns the per-tick records and the flushed state."""
    store, lv, red = _store(device, rebuild_bytes_per_tick=32 * 128 * 4)
    pat, log, step = store.patroller, [], 0

    def tick():
        nonlocal lv, red, step
        red, rep = store.tick(lv, red, step, scrub_period=0)
        if device.type == "cuda":
            torch.cuda.synchronize()
        lv = dict(lv, **rep.repaired)
        log.append((rep.patrolled, rep.patrol_mismatches,
                    None if rep.rebuild is None else dataclasses.astuple(rep.rebuild),
                    pat.xpar["w"].xvalid.copy(), pat.xpar["w"].xpar.cpu()))
        step += 1
        return rep

    for _ in range(8):
        tick()
    lv, red = store.inject(lv, red, FaultSpec(kind="shard_loss", leaf="w", block=3))
    store.declare_shard_lost("w", 3, red)
    for i in range(8):
        w = lv["w"].clone()
        w[24 + i % 8] = float(i)
        lv = dict(lv, w=w)
        ev = torch.zeros((64,), dtype=torch.bool, device=device)
        ev[24 + i % 8] = True
        red = store.on_write(red, events={"w": ev})
        if tick().rebuild.done:
            break
    red = store.flush(lv, red, step)
    return log, lv["w"].cpu(), {f: getattr(red["w"], f).cpu() for f in
                                ("checksums", "parity", "dirty", "shadow", "meta_ck")}


def test_rebuild_equals_cpu_on_card(cuda_device):
    got_log, got_w, got_red = _rebuild_run(cuda_device)
    want_log, want_w, want_red = _rebuild_run(torch.device("cpu"))
    assert len(got_log) == len(want_log)
    for i, (g, w) in enumerate(zip(got_log, want_log)):
        assert g[:3] == w[:3], (i, g[:3], w[:3])
        assert np.array_equal(g[3], w[3]) and torch.equal(g[4], w[4]), i
    assert got_log[-1][2][-1] and got_log[-1][2][7] == 4       # done, in 4 windows
    assert torch.equal(got_w.view(torch.int32), want_w.view(torch.int32))
    for f, t in want_red.items():
        assert torch.equal(got_red[f], t), f


@pytest.mark.parametrize("wait", [True, False], ids=["wait", "no_wait"])
def test_paste_waits_for_the_inflight_update_on_card(cuda_device, wait, monkeypatch):
    """The due tick dispatches an update held behind a spin on the side
    stream, then the rebuild pastes the lost shard's rows.  Stripes of 3
    blocks: the written rows fill blocks 0-31, so stripe 10 (blocks 30-32)
    holds a pasted block.  With the wait the update's parity of the
    stripes it recomputes is that of the tick's data (the scribbled shard
    with the written rows); with it removed (``await_inflight`` a no-op)
    the held update reads the pasted block 32, so stripe 10's parity
    differs: the check can tell."""
    if not wait:
        monkeypatch.setattr(ProtectedStore, "await_inflight", lambda self: self)
    store, lv, red = _store(cuda_device, period_steps=1, stripe_data_blocks=3)
    red, _ = store.tick(lv, red, 0, scrub_period=0)           # prime: xpar valid
    store.sync_inflight()
    lv, red = store.inject(lv, red, FaultSpec(kind="shard_loss", leaf="w", block=3))
    store.declare_shard_lost("w", 3, red)
    w = lv["w"].clone()
    w[24:26] = 1.5                                            # blocks 0-31 of shard 3
    lv = dict(lv, w=w)
    ev = torch.zeros((64,), dtype=torch.bool, device=cuda_device)
    ev[24:26] = True
    red = store.on_write(red, events={"w": ev})
    meta = store.metas["w"]
    ns = meta.n_stripes
    lanes = store.engine_for("w").lanes_by_shard(lv["w"], "w")
    want = par_ref.stripe_parity(lanes[3], meta.stripe_data_blocks).clone()
    torch.cuda.synchronize()
    with torch.cuda.stream(store._side_stream()):
        torch.cuda._sleep(HOLD_CYCLES)
    red, rep = store.tick(lv, red, 1, scrub_period=0)
    assert rep.updated and rep.rebuild is not None and rep.rebuild.done
    red = store.settle(red, lv, step=1)
    got = red["w"].parity[3 * ns:4 * ns]
    recomputed = torch.arange(ns, device=cuda_device) < 11    # stripes of blocks 0-32
    same = torch.equal(got[recomputed], want[recomputed])
    if wait:
        assert same, "the held update read the pasted rows"
    else:
        assert not same, "the late read went unseen"



def _held_sample_run(device, hold):
    """Row 8 written, the due tick's write sample held behind a spin on
    the current stream (``hold``), the next tick adopting the update, a
    loss of shard 3 declared, and the tick that starts its rebuild.
    Returns that tick's report, shard 3's rows before and after, and
    whether the sample had landed when the rebuild's tick began."""
    store, lv, red = _store(device, period_steps=1)
    pat = store.patroller
    red, _ = store.tick(lv, red, 0, scrub_period=0)           # prime: all valid
    torch.cuda.synchronize()
    assert pat.xpar["w"].xvalid.all()
    lost = slice(3 * ROWS_LOCAL, 4 * ROWS_LOCAL)
    before = lv["w"][lost].clone()
    w = lv["w"].clone()
    w[ROWS_LOCAL] += 1.0
    lv = dict(lv, w=w)
    ev = torch.zeros((64,), dtype=torch.bool, device=device)
    ev[ROWS_LOCAL] = True
    red = store.on_write(red, events={"w": ev})
    sample = pat._dispatch_sample

    def held(out):
        torch.cuda._sleep(5 * HOLD_CYCLES if hold else 0)
        sample(out)

    pat._dispatch_sample = held
    red, rep = store.tick(lv, red, 1, scrub_period=0)         # consumes the mark
    pat._dispatch_sample = sample
    assert rep.updated
    store._side_stream().synchronize()                        # the update, not the spin
    red, _ = store.tick(lv, red, 2, scrub_period=0)           # adopts the update
    w = lv["w"].clone()
    w[lost].neg_()                                            # shard 3 scribbled
    lv = dict(lv, w=w)
    store.declare_shard_lost("w", 3)
    landed = pat._samples[0][0].query()
    red, rep = store.tick(lv, red, 3, scrub_period=0)
    lv = dict(lv, **rep.repaired)
    torch.cuda.synchronize()
    return rep, store.metas["w"].n_blocks, before, lv["w"][lost], landed


@pytest.mark.parametrize("forced", [True, False], ids=["forced", "not_forced"])
def test_rebuild_start_applies_a_held_write_sample_on_card(cuda_device, forced,
                                                            monkeypatch):
    """Row 8 (shard 1's local blocks 0-15) is written, the due update
    consumes its mark, and that tick's write sample is held behind a spin
    on the current stream while the next tick adopts the update: only the
    unlanded sample still holds the mark.  A loss of shard 3 declared then
    must find those 16 xpar rows stale: with the rebuild start applying
    every sample first they are lost and shard 3's other 112 blocks come
    back bitwise; with that step removed (``_process_sample`` never
    forced) the stale rows are pasted as rebuilt, and the check can tell.
    A first run without the spin allocates the pinned buffers (a first
    pinned allocation can wait for the device)."""
    from repro_torch.scrub import patrol
    if not forced:
        orig = patrol.ScrubPatroller._process_sample
        monkeypatch.setattr(patrol.ScrubPatroller, "_process_sample",
                            lambda self, force=False: orig(self))
    _held_sample_run(cuda_device, hold=False)
    rep, nb, before, got, landed = _held_sample_run(cuda_device, hold=True)
    assert not landed, "the held sample landed before the rebuild's tick"
    st = rep.rebuild
    if forced:
        assert st.done and (st.rebuilt, st.fresh, st.lost) == (nb - 16, 0, 16)
        assert {b for u in rep.unrecoverable for b in u.blocks} == {
            3 * nb + b for b in range(16)}
        assert torch.equal(got[1:].view(torch.int32), before[1:].view(torch.int32))
        assert torch.equal(got[0], -before[0])
    else:
        assert (st.rebuilt, st.lost) == (nb, 0)
        assert not torch.equal(got[0].view(torch.int32), before[0].view(torch.int32))
