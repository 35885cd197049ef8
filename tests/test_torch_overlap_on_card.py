"""The overlapped tick on the card: side stream, events and allocator.

Each test needs a CUDA device and skips without one (decided at run
time).  A heap of 4 KiB rows (one block a row, 4+1 stripes) is driven
through the overlapped store and through a blocking twin with the same
writes; after ``flush`` the two states are equal bit for bit.  The module
imports no JAX, so on the card it runs with:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_overlap_on_card.py

The last test trains an MoE model on the card under deterministic
algorithms, which need ``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS first
runs: it is set here, at collection, before any test touches the card.
"""
import dataclasses
import os
import time

import pytest
import torch

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from repro_torch.core import ProtectedStore, RedundancyPolicy, bits, blocks
from repro_torch.core.state import FIELDS
from repro_torch.kernels.redundancy import ops as fu_ops

ROWS, ROW, STRIPE = 8192, 1024, 4      # 32 MiB of fp32, 8,192 blocks
SLEEP_CYCLES = 500_000_000             # about 0.3 s of one SM's clock


@pytest.fixture()
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the overlapped tick's streams and "
                    "kernels have no CPU mode")
    return torch.device("cuda")


def _policy(async_tick, period=1, **kw):
    return RedundancyPolicy.single("vilamb", period_steps=period,
                                   lanes_per_block=ROW, stripe_data_blocks=STRIPE,
                                   async_tick=async_tick, **kw)


def _heap(dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((ROWS, ROW), generator=g, device=dev)


def _write(store, heap, red, rows, vals):
    """Foreground write: rows of the heap in place, then their dirty marks,
    with ops that never block the host (``heap[rows] = vals`` and
    ``ev[rows] = True`` wait for the stream's earlier work)."""
    heap.index_copy_(0, rows, vals)
    ev = torch.zeros(ROWS, dtype=torch.bool, device=heap.device)
    ev.index_fill_(0, rows, True)
    return store.on_write(red, events={"heap": ev})


def _assert_equal(a, b, msg=""):
    for n in a:
        for f in FIELDS:
            assert torch.equal(getattr(a[n], f), getattr(b[n], f)), f"{msg} {n}.{f}"


def _twins(dev, **kw):
    """An overlapped store and a blocking one over equal heaps."""
    out = []
    for async_tick in (True, False):
        heap = _heap(dev)
        store = ProtectedStore(_policy(async_tick, **kw)).attach({"heap": heap})
        out.append((store, heap, store.init({"heap": heap})))
    return out


def test_fused_update_runs_on_side_stream_on_card(cuda_device, monkeypatch):
    """Every overlapped update launches K3 on the store's side stream, not
    the caller's; the settled state equals the blocking twin's."""
    streams = []
    orig = fu_ops.fused_update_many

    def spy(jobs, *a, **k):
        jobs = list(jobs)
        streams.extend(torch.cuda.current_stream() for _ in jobs)    # one a leaf
        return orig(jobs, *a, **k)

    monkeypatch.setattr(fu_ops, "fused_update_many", spy)
    (sa, ha, ra), (sb, hb, rb) = _twins(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for step in range(1, 6):
        rows = torch.randperm(ROWS, generator=g, device=cuda_device)[:256]
        vals = torch.randn((256, ROW), generator=g, device=cuda_device)
        ra = _write(sa, ha, ra, rows, vals)
        rb = _write(sb, hb, rb, rows, vals)
        streams.clear()
        before = fu_ops.LAUNCHES
        ra, rep = sa.tick({"heap": ha}, ra, step)
        assert rep.updated and fu_ops.LAUNCHES == before + 1
        assert streams == [sa._side] and sa._side != torch.cuda.default_stream()
        rb, _ = sb.tick({"heap": hb}, rb, step)
    ra = sa.flush({"heap": ha}, ra, step=6)
    rb = sb.flush({"heap": hb}, rb, step=6)
    _assert_equal(ra, rb, "after flush")


def test_event_readiness_and_coalescing_on_card(cuda_device):
    """Behind a long foreground kernel the update cannot finish: its event
    queries False, the next due tick coalesces, and once it finished the
    following tick adopts and dispatches the deferred update."""
    (sa, ha, ra), (sb, hb, rb) = _twins(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    plan = [(torch.randperm(ROWS, generator=g, device=cuda_device)[:64],
             torch.randn((64, ROW), generator=g, device=cuda_device)) for _ in range(3)]
    ra = _write(sa, ha, ra, *plan[0])
    torch.cuda._sleep(SLEEP_CYCLES)             # the side stream waits for it
    ra, _ = sa.tick({"heap": ha}, ra, 1)
    grp = next(iter(sa.groups.values()))
    p = grp.pending
    assert p is not None and not p.done.query()
    ra = _write(sa, ha, ra, *plan[1])
    ra, rep = sa.tick({"heap": ha}, ra, 2)
    assert rep.coalesced and grp.pending is p and p.coalesced == 1
    sa.sync_inflight()
    assert p.done.query()
    ra = _write(sa, ha, ra, *plan[2])
    ra, rep = sa.tick({"heap": ha}, ra, 3)
    assert rep.updated and not rep.coalesced
    assert grp.pending is not None and grp.pending.step == 3
    for step, (rows, vals) in enumerate(plan, 1):
        rb = _write(sb, hb, rb, rows, vals)
        rb, _ = sb.tick({"heap": hb}, rb, step)
    _assert_equal(sa.flush({"heap": ha}, ra, step=4), sb.flush({"heap": hb}, rb, step=4),
                  "after flush")


def test_allocator_stress_matches_blocking_twin_on_card(cuda_device):
    """Many due ticks with fresh temporaries every step, foreground writes
    racing the update, and updates held in flight behind long kernels while
    memory is freed and reallocated: bitwise equal to the blocking twin
    after flush, and on clean blocks and stripes after every settle."""
    (sa, ha, ra), (sb, hb, rb) = _twins(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    meta = sa.metas["heap"]
    for step in range(1, 61):
        n = 64 + 64 * (step % 7)
        rows = torch.randperm(ROWS, generator=g, device=cuda_device)[:n]
        vals = torch.randn((n, ROW), generator=g, device=cuda_device)
        if step % 5 == 0:
            torch.cuda._sleep(SLEEP_CYCLES // 20)
        ra, _ = sa.tick({"heap": ha}, _write(sa, ha, ra, rows, vals), step)
        rb, _ = sb.tick({"heap": hb}, _write(sb, hb, rb, rows, vals), step)
        junk = [torch.empty(1 << (12 + step % 9), device=cuda_device) for _ in range(4)]
        del junk
        if step % 10 == 0:
            torch.cuda.empty_cache()
        if step % 15 == 0:
            ra = sa.settle(ra, {"heap": ha}, step=step)
            live = bits.unpack(ra["heap"].dirty | ra["heap"].shadow, meta.n_blocks)
            clean = ~live
            clean_stripes = ~blocks.stripe_dirty_mask(meta, live)
            assert torch.equal(ra["heap"].checksums[clean], rb["heap"].checksums[clean])
            assert torch.equal(ra["heap"].parity[clean_stripes],
                               rb["heap"].parity[clean_stripes])
    ra = sa.flush({"heap": ha}, ra, step=61)
    rb = sb.flush({"heap": hb}, rb, step=61)
    _assert_equal(ra, rb, "after flush")
    assert torch.equal(ha, hb)
    assert int(sa.scrub({"heap": ha}, ra)["heap"].sum()) == 0


def test_grouped_multi_tile_update_matches_blocking_twin_on_card(cuda_device):
    """A group of four leaves at the default 64 KiB blocks (stripes split
    over column tiles, a partial last stripe, a padded copy), due every
    tick: each overlapped due tick is one K3 launch for the whole group,
    updates are held in flight behind sleeps while memory churns, and the
    state equals the blocking twin's on clean blocks after every settle and
    everywhere after flush."""
    shapes = {"a": (8192, 1024), "b": (40, 16384), "c": (11, 16384), "d": (1000, 77)}
    policy = RedundancyPolicy.single("vilamb", period_steps=1)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    twins = []
    for async_tick in (True, False):
        leaves = {n: torch.randn(sh, generator=torch.Generator(device=cuda_device)
                                 .manual_seed(7), device=cuda_device)
                  for n, sh in shapes.items()}
        store = ProtectedStore(dataclasses.replace(policy, async_tick=async_tick)
                               ).attach(leaves)
        twins.append([store, leaves, store.init(leaves)])
    (sa, la, _), _ = twins
    for step in range(1, 31):
        rows = {n: torch.randperm(shapes[n][0], generator=g, device=cuda_device)[:k]
                for n, k in (("a", 96), ("c", 1 + step % 3))}
        vals = {n: torch.randn((len(r), shapes[n][1]), generator=g, device=cuda_device)
                for n, r in rows.items()}
        full = {"b": torch.randn(shapes["b"], generator=g, device=cuda_device)
                if step % 3 == 0 else None,
                "d": torch.randn(shapes["d"], generator=g, device=cuda_device)}
        if step % 4 == 0:
            torch.cuda._sleep(SLEEP_CYCLES // 20)
        for i, (store, leaves, red) in enumerate(twins):
            events = {}
            for n, r in rows.items():
                leaves[n].index_copy_(0, r, vals[n])
                ev = torch.zeros(shapes[n][0], dtype=torch.bool, device=cuda_device)
                ev.index_fill_(0, r, True)
                events[n] = ev
            for n, v in full.items():
                if v is not None:
                    leaves[n].copy_(v)
                    events[n] = "__all__"
            red = store.on_write(red, events=events)
            before = fu_ops.LAUNCHES
            red, rep = store.tick(leaves, red, step)
            if i == 0:      # one launch a dispatch; none where it coalesced
                assert rep.updated, step
                assert fu_ops.LAUNCHES == before + (0 if rep.coalesced else 1), step
            twins[i][2] = red
        junk = [torch.empty(1 << (14 + step % 7), device=cuda_device) for _ in range(3)]
        del junk
        if step % 10 == 0:
            torch.cuda.empty_cache()
            ra = sa.settle(twins[0][2], la, step=step)
            twins[0][2] = ra
            rb = twins[1][2]
            for n, meta in sa.metas.items():
                clean = ~bits.unpack(ra[n].dirty | ra[n].shadow, meta.n_blocks)
                assert torch.equal(ra[n].checksums[clean], rb[n].checksums[clean]), (step, n)
    ra = sa.flush(la, twins[0][2], step=31)
    rb = twins[1][0].flush(twins[1][1], twins[1][2], step=31)
    _assert_equal(ra, rb, "after flush")
    assert int(sum(m.sum() for m in sa.scrub(la, ra).values())) == 0


def _delay_side(store):
    """Hold the store's side stream behind a long kernel."""
    with torch.cuda.stream(store._side_stream()):
        torch.cuda._sleep(SLEEP_CYCLES)


def test_scrub_mid_flight_equals_settled_scrub_on_card(cuda_device):
    """A scrub reads the checksums unsynchronised while the update
    refreshes the in-flight blocks' entries, which it masks out: before,
    during or after the update its mask equals the settled scrub's, and a
    scheduled scrub in the dispatching tick flags nothing in flight."""
    heap = _heap(cuda_device)
    store = ProtectedStore(_policy(True, period=2)).attach({"heap": heap})
    red = store.init({"heap": heap})
    eng = store.engine_for("heap")
    lanes = blocks.to_lanes(heap, store.metas["heap"])
    g = torch.Generator(device=cuda_device).manual_seed(4)

    def write(red):
        rows = torch.randperm(ROWS, generator=g, device=cuda_device)[:2048]
        return rows, _write(store, heap, red, rows, torch.randn(
            (2048, ROW), generator=g, device=cuda_device))

    step = 0
    for delay in ("side", "main", None):
        step += 2
        rows, red = write(red)
        clean = torch.ones(ROWS, dtype=torch.bool, device=cuda_device)
        clean[rows] = False
        bad = int(torch.nonzero(clean)[step].item())
        lanes[bad, 5] ^= 0x1234                  # silent corruption of a clean block
        if delay == "side":
            _delay_side(store)
        red, rep = store.tick({"heap": heap}, red, step)
        assert rep.updated
        if delay == "main":
            torch.cuda._sleep(SLEEP_CYCLES)
        mid = eng.scrub({"heap": heap}, red)["heap"]
        settled = store.scrub({"heap": heap}, red)["heap"]
        assert torch.equal(mid, settled), delay
        assert torch.nonzero(settled).flatten().tolist() == [bad]
        lanes[bad, 5] ^= 0x1234
    for delay in ("side", None):
        step += 2
        _, red = write(red)
        if delay == "side":
            _delay_side(store)
        red, rep = store.tick({"heap": heap}, red, step, scrub_period=2)
        assert rep.updated and rep.scrubbed and (rep.mismatches, rep.alarms) == (0, 0)
    red = store.flush({"heap": heap}, red, step=step + 1)
    assert int(store.scrub({"heap": heap}, red)["heap"].sum()) == 0


def test_readers_wait_for_the_inflight_update_on_card(cuda_device):
    """Mid-flight, verify_meta orders itself after the update on the device,
    so the new meta-checksum meets the refreshed checksums; recover_block
    refuses a block of a stripe being rewritten and rebuilds one of a clean
    stripe exactly."""
    heap = _heap(cuda_device)
    store = ProtectedStore(_policy(True)).attach({"heap": heap})
    red = store.init({"heap": heap})
    meta = store.metas["heap"]
    lanes = blocks.to_lanes(heap, meta)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    rows = torch.randperm(ROWS, generator=g, device=cuda_device)[:1024]
    red = _write(store, heap, red, rows, torch.randn((1024, ROW), generator=g,
                                                     device=cuda_device))
    _delay_side(store)
    red, rep = store.tick({"heap": heap}, red, 1)
    assert rep.updated and not next(iter(store.groups.values())).pending.done.query()
    assert all(bool(v) for v in store.verify_meta(red).values())
    in_flight = blocks.stripe_dirty_mask(meta, bits.unpack(red["heap"].shadow, ROWS))
    for sid, ok_want in ((int(torch.nonzero(in_flight)[0].item()), False),
                         (int(torch.nonzero(~in_flight)[0].item()), True)):
        block = sid * STRIPE + 1
        saved = lanes[block].clone()
        lanes[block] ^= 0x5A5A
        _, ok = store.recover_block(heap, red["heap"], "heap", block)
        assert ok == ok_want
        if ok:
            assert torch.equal(lanes[block], saved)
        lanes[block] = saved
    red = store.flush({"heap": heap}, red, step=2)
    assert int(store.scrub({"heap": heap}, red)["heap"].sum()) == 0


def test_lazy_tick_does_not_block_the_host_on_card(cuda_device):
    """With the update held behind a long kernel on the side stream, the
    dispatching tick and the following lazy tick return to the host long
    before the update finishes: nothing on the overlapped path waits on
    the host for the device."""
    heap = _heap(cuda_device)
    store = ProtectedStore(_policy(True, period=2)).attach({"heap": heap})
    red = store.init({"heap": heap})
    rows = torch.arange(0, ROWS, 7, device=cuda_device)
    vals = torch.zeros((rows.numel(), ROW), device=cuda_device)
    red = _write(store, heap, red, rows, vals)
    torch.cuda.synchronize()
    _delay_side(store)
    t0 = time.perf_counter()
    red, rep = store.tick({"heap": heap}, red, 2)            # dispatches
    red = _write(store, heap, red, rows[:8], vals[:8])
    red, _ = store.tick({"heap": heap}, red, 3)               # lazy: not due
    host_s = time.perf_counter() - t0
    p = next(iter(store.groups.values())).pending
    assert rep.updated and p is not None and not p.done.query()
    assert host_s < 0.1, f"the ticks held the host {host_s:.3f} s"
    store.sync_inflight()
    assert p.done.query()
    red = store.flush({"heap": heap}, red, step=4)
    assert int(store.scrub({"heap": heap}, red)["heap"].sum()) == 0


def test_failed_side_dispatch_reraises_on_card(cuda_device, monkeypatch):
    """A launch failure on the side stream surfaces at resolution."""
    heap = _heap(cuda_device)
    store = ProtectedStore(_policy(True)).attach({"heap": heap})
    red = store.init({"heap": heap})
    red = _write(store, heap, red, torch.arange(8, device=cuda_device),
                 torch.zeros((8, ROW), device=cuda_device))

    def fail(*a, **k):
        raise RuntimeError("fused_update kernel launch failed: CUDA error 1")

    monkeypatch.setattr(fu_ops, "fused_update_many", fail)
    red, rep = store.tick({"heap": heap}, red, 1)
    assert rep.updated
    with pytest.raises(RuntimeError, match="launch failed"):
        store.settle(red, {"heap": heap})


def test_export_mid_flight_holds_one_epoch_on_card(cuda_device, tmp_path):
    """Right after a due tick, with the update held behind a long kernel on
    the side stream, a checkpoint saved and a host copy taken from another
    stream (both passed the store) hold the live view after the update: the
    restored state passes ``verify_meta`` and scrubs clean, and the host
    copy equals the settled one.  A copy that is not ordered after the
    update reads the old checksums (the hazard the store argument closes)."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core import convert
    from repro_torch.train import TrainState
    heap = _heap(cuda_device)
    store = ProtectedStore(_policy(True)).attach({"params": {"heap": heap}})
    red = store.init({"params/heap": heap})
    g = torch.Generator(device=cuda_device).manual_seed(6)
    rows = torch.randperm(ROWS, generator=g, device=cuda_device)[:1024]
    heap.index_copy_(0, rows, torch.randn((1024, ROW), generator=g, device=cuda_device))
    ev = torch.zeros(ROWS, dtype=torch.bool, device=cuda_device)
    ev.index_fill_(0, rows, True)
    red = store.on_write(red, events={"params/heap": ev})
    old = red["params/heap"].checksums.clone()
    _delay_side(store)
    red, rep = store.tick({"params/heap": heap}, red, 1)
    pending = next(iter(store.groups.values())).pending
    assert rep.updated and not pending.done.query()
    state = TrainState(params={"heap": heap}, opt={"m": {}, "v": {}, "count": 0},
                       red=red, step=1)
    other = torch.cuda.Stream(cuda_device)
    other.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(other):
        unordered = red["params/heap"].checksums.cpu()
        assert not pending.done.query()
        host = convert.red_to_numpy(red, store)
        CheckpointManager(tmp_path, device=cuda_device).save(1, state, store=store)
    assert torch.equal(unordered, old.cpu())             # read before the update ran
    torch.cuda.synchronize()
    settled = convert.red_to_numpy(red)
    for f in FIELDS:
        assert (host["params/heap"][f] == settled["params/heap"][f]).all(), f
    assert not torch.equal(red["params/heap"].checksums.cpu(), old.cpu())
    fresh = ProtectedStore(_policy(True)).attach({"params": {"heap": heap}})
    template = TrainState(params={"heap": torch.empty_like(heap)},
                          opt={"m": {}, "v": {}, "count": 0},
                          red={"params/heap": red["params/heap"]}, step=0)
    mgr = CheckpointManager(tmp_path, device=cuda_device)
    got = mgr.restore_into(template)
    assert all(bool(v) for v in fresh.verify_meta(got.red).values())
    assert int(fresh.scrub({"params/heap": got.params["heap"]}, got.red)
               ["params/heap"].sum()) == 0
    assert torch.equal(got.params["heap"], heap)
    restored = mgr.restore_verified(template, fresh)
    assert mgr.last_restore_report.tried == [(1, "ok")] and restored.step == 1


@pytest.mark.parametrize("shape,dtype", [((3, 5), torch.float32), ((5, 3), torch.bfloat16),
                                         ((7,), torch.uint8), ((), torch.int32),
                                         ((4097, 33), torch.bfloat16)])
def test_file_checksum_on_card(cuda_device, shape, dtype):
    """The checkpoint file checksum computed on the card equals its plain
    version (the host fold over the same bytes), chunked or not."""
    import numpy as np
    from repro_torch.ckpt import checkpoint as ck
    g = torch.Generator(device=cuda_device).manual_seed(7)
    n = max(1, int(np.prod(shape)))
    t = torch.randint(0, 256, (n * dtype.itemsize,), dtype=torch.uint8, generator=g,
                      device=cuda_device).view(dtype)[:n].reshape(shape)
    want = ck._np_checksum(t.cpu().reshape(-1).view(torch.uint8).numpy())
    for chunk in (ck.CHUNK_WORDS, 1000, 3):
        assert ck.file_checksum(t, chunk) == want


def test_moe_sparse_step_touches_only_routed_slabs_on_card(cuda_device, monkeypatch):
    """qwen3-moe's routing ratio at smoke width (16 tokens x top-8 of 128
    experts, bf16 moments) on the overlapped store: after the due update
    is adopted, one 16-token step leaves every slab it routed no token to
    bit-identical in params, m and v and never marks its blocks; the flush
    hands K3 exactly the routed slabs' stripes of each expert leaf; a
    scrub is clean."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models import Model, ShapeConfig, build_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train import Trainer, protected_leaves, protected_structs
    cfg = dataclasses.replace(get_smoke("qwen3-moe-235b-a22b"), n_layers=2, n_experts=128,
                              top_k=8, moment_dtype="bfloat16")
    opt = AdamW(lr=warmup_cosine(1e-3, 2, 10), moment_dtype=cfg.moment_dtype)
    meta = Model(cfg, torch.device("meta")).init()
    store = ProtectedStore(RedundancyPolicy.single("vilamb", period_steps=2,
                                                   lanes_per_block=128)).attach(
        protected_structs(meta, opt.init(meta)))
    trainer = Trainer(model=build_model(cfg), opt=opt, store=store, scrub_period_steps=0)
    dense = SyntheticPipeline(cfg, ShapeConfig("t", 64, 4, "train"), seed=0)
    sparse = SyntheticPipeline(cfg, ShapeConfig("s", 16, 1, "train"), seed=1)
    state = trainer.init_state(torch.Generator(device=cuda_device).manual_seed(0))
    state = trainer.settle(trainer.run(state, dense, 2))            # due at 2, adopted
    assert all(not bool((r.dirty | r.shadow).any()) for r in state.red.values())
    with torch.no_grad():
        _, aux = trainer.model.loss(state.params, sparse.get(state.step))
    routed = aux["expert_counts"][:, 0, :] > 0
    assert bool(routed.any()) and not bool(routed.all())
    slabs = {n: t.clone() for n, t in protected_leaves(state.params, state.opt).items()
             if "/moe/w" in n}
    state = trainer.run(state, sparse, 1)
    leaves = protected_leaves(state.params, state.opt)
    calls = []
    launch = fu_ops.fused_update_many

    def spy(jobs, stripe_width=4, **kw):
        jobs = list(jobs)
        for lanes, _, _, words in jobs:          # the stripes each leaf's words mark
            nb = lanes.shape[0]
            bd = bits.unpack(words, nb)
            sd = torch.zeros(-(-nb // stripe_width) * stripe_width, dtype=torch.bool,
                             device=bd.device)
            sd[:nb] = bd
            calls.append((lanes.data_ptr(), int(sd.view(-1, stripe_width).any(1).sum())))
        return launch(jobs, stripe_width, **kw)

    for n, t in slabs.items():
        assert torch.equal(leaves[n][~routed].view(torch.int16), t[~routed].view(torch.int16)), n
        assert not torch.equal(leaves[n][routed], t[routed]), n
        meta = store.metas[n]
        want = blocks.row_mask_block_mask(meta, routed, row_dims=2)
        r = state.red[n]
        assert torch.equal(bits.unpack(r.dirty | r.shadow, meta.n_blocks), want), n
    want = {blocks.to_lanes(leaves[n], store.metas[n]).data_ptr(): int(
        blocks.stripe_dirty_mask(store.metas[n], blocks.row_mask_block_mask(
            store.metas[n], routed, row_dims=2)).sum()) for n in slabs}
    monkeypatch.setattr(fu_ops, "fused_update_many", spy)
    state = trainer.flush(state)
    monkeypatch.setattr(fu_ops, "fused_update_many", launch)
    got = {p: c for p, c in calls if p in want}
    assert got == want
    assert trainer.scrub_check(state) == 0
