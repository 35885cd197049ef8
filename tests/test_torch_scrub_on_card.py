"""The scrub patroller and the health governor on the card.

Each test needs a CUDA device and skips without one (decided at run
time).  A probe on the card (the checksum kernel over a window at a
runtime block offset) gives the CPU's verdicts for the same seed, tick by
tick; a probe dispatched while the due update is held in flight on the
side stream returns without waiting for it and judges the clean blocks as
it would once the update finished; and rung 1 of the governor abandons a
held update without a verify_meta alarm, with every field after
``flush`` equal to a blocking twin's.  The module imports no JAX, so on
the card it runs with:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_scrub_on_card.py
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import ProtectedStore, RedundancyPolicy, convert
from repro_torch.core.state import FIELDS
from repro_torch.faults import FaultSpec
from repro_torch.health import HEALTHY, HealthPolicy
from repro_torch.kernels.checksum import ops as ck_ops

ROWS, ROW, STRIPE = 8192, 1024, 4      # 32 MiB of fp32, 8,192 blocks
E_ROWS, E_ROW = 250, 2000             # bf16 rows straddle blocks; a partial last one
WINDOW = 1024                          # blocks a probe (4 MiB)
SLEEP_CYCLES = 500_000_000             # about 0.3 s of one SM's clock


@pytest.fixture()
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the store's side stream and kernels "
                    "have no CPU mode")
    return torch.device("cuda")


def _leaves(dev):
    rng = np.random.default_rng(0)
    heap = rng.standard_normal((ROWS, ROW)).astype(np.float32)
    e = rng.standard_normal((E_ROWS, E_ROW)).astype(np.float32)
    return {"heap": torch.from_numpy(heap).to(dev),
            "e": torch.from_numpy(e).to(dev).to(torch.bfloat16)}


def _store(dev, async_tick=True, **kw):
    pol = RedundancyPolicy.single(
        "vilamb", period_steps=2, lanes_per_block=ROW, stripe_data_blocks=STRIPE,
        async_tick=async_tick, precompile=False, **kw)
    return ProtectedStore(pol, device=dev).attach(_leaves(dev))


def _hold(store):
    """Queue a spin on the side stream: the next update runs behind it."""
    with torch.cuda.stream(store._side_stream()):
        torch.cuda._sleep(SLEEP_CYCLES)


def _write(store, leaves, red, rng, dev):
    """64 random heap rows of the first half and 2 bf16 rows shifted, on
    copies; the second half of the heap is never written."""
    events = {}
    for name, n, k in (("heap", ROWS // 2, 64), ("e", E_ROWS // 2, 2)):
        idx = torch.as_tensor(np.sort(rng.choice(n, size=k, replace=False)), device=dev)
        v = leaves[name].clone()
        v[idx] += 0.5
        leaves = dict(leaves, **{name: v})
        events[name] = torch.zeros(leaves[name].shape[0], dtype=torch.bool,
                                   device=dev).index_fill_(0, idx, True)
    return leaves, store.on_write(red, events=events)


def _host(store, leaves, red):
    return ({k: v.detach().cpu().contiguous().view(torch.uint8).numpy()
             for k, v in leaves.items()}, convert.red_to_numpy(red, store))


def _assert_same(a, b, msg=""):
    (al, ar), (bl, br) = a, b
    for k in bl:
        np.testing.assert_array_equal(al[k], bl[k], err_msg=f"{msg} {k}")
    for n in br:
        for f in FIELDS:
            np.testing.assert_array_equal(ar[n][f], br[n][f], err_msg=f"{msg} {n}.{f}")


FAULTS = {3: FaultSpec("data_bitflip", "heap", block=6000, lane=7, bit=31),
          5: FaultSpec("data_bitflip", "e", block=225, lane=1,
                       payload=0x7FC00000),
          8: FaultSpec("data_bitflip", "heap", block=7777, lane=1000, bit=0)}


def _patrol_run(dev, steps=48):
    """The same seeded writes and faults through a store of ``dev`` with the
    patroller on; the card synchronises before each tick, so every probe
    and update has landed when the tick looks (as on the CPU)."""
    store = _store(dev, patrol_bytes_per_tick=WINDOW * ROW * 4)
    leaves = _leaves(dev)
    red = store.flush(leaves, store.init(leaves), 0)
    rng = np.random.default_rng(1)
    ticks = []
    for step in range(1, steps + 1):
        leaves, red = _write(store, leaves, red, rng, dev)
        if step in FAULTS:
            leaves, red = store.inject(leaves, red, FAULTS[step])
            store.patroller.expect_injection(FAULTS[step].leaf, FAULTS[step].block, step)
        if dev != "cpu":
            torch.cuda.synchronize()
        red, rep = store.tick(leaves, red, step, scrub_period=0)
        leaves = dict(leaves, **rep.repaired)
        ticks.append((rep.patrolled, rep.patrol_mismatches, rep.patrol_starved_ticks,
                      rep.updated, sorted(rep.repaired), rep.unrecoverable))
    pat = store.patroller
    obs = ([(d.leaf, d.block, d.step, d.latency_steps) for d in pat.detections],
           pat.blocks_scanned, dict(pat.cursor))
    red = store.flush(leaves, red, steps + 1)
    return store, ticks, obs, _host(store, leaves, red)


def test_patrol_on_card_equals_cpu(cuda_device):
    """Every tick's report, the detections with their latencies, and the
    repaired and flushed state equal the CPU's; the probes ran the
    checksum kernel."""
    before = ck_ops.LAUNCHES
    store, ticks, obs, state = _patrol_run(cuda_device)
    probes = ck_ops.LAUNCHES - before
    _, pticks, pobs, pstate = _patrol_run("cpu")
    for step, (g, w) in enumerate(zip(ticks, pticks), start=1):
        assert g == w, f"tick {step}"
    assert obs == pobs
    _assert_same(state, pstate)
    assert {d[:2] for d in obs[0]} == {(s.leaf, s.block) for s in FAULTS.values()}
    assert probes >= sum(len(t[0]) for t in ticks) > 0


def test_probe_never_waits_for_a_held_update_on_card(cuda_device):
    """A probe dispatched while the due update is held behind a spin on
    the side stream: the tick returns well inside the spin, the update is
    still in flight after it, and the probe's verdicts (a corrupted clean
    block among them) equal the same window's once the update finished."""
    store = _store(cuda_device, patrol_bytes_per_tick=WINDOW * ROW * 4)
    leaves = _leaves(cuda_device)
    red = store.flush(leaves, store.init(leaves), 0)
    pat = store.patroller
    rng = np.random.default_rng(1)
    leaves, red = _write(store, leaves, red, rng, cuda_device)
    red, _ = store.tick(leaves, red, 1, scrub_period=0)     # a first probe
    torch.cuda.synchronize()
    # Point the next probe at heap [4096, 5120), in the never-written half,
    # and corrupt a clean block there.
    leaves, red = store.inject(leaves, red, FaultSpec("data_bitflip", "heap",
                                                      block=4600, lane=3, bit=5))
    pat.cursor["heap"] = 4096
    pat._ti = pat.targets.index("heap")
    leaves, red = _write(store, leaves, red, rng, cuda_device)
    torch.cuda.synchronize()
    _hold(store)
    red, rep = store.tick(leaves, red, 2, scrub_period=0)   # due: held K3
    group = next(iter(store.groups.values()))
    pending = group.pending
    assert rep.updated and not pending.done.query()
    t = time.perf_counter()
    red, rep = store.tick(leaves, red, 3, scrub_period=0)   # quiet: a probe
    host_ms = (time.perf_counter() - t) * 1e3
    assert rep.patrolled == ("heap",), rep
    assert not pending.done.query(), "the probe tick waited for the update"
    assert host_ms < 100, host_ms
    name, start, w, masks, done, _, _ = pat._probe
    torch.cuda.synchronize()
    got = masks.clone()
    mism, clean = store.engine_for("heap").verify_window_fn("heap", w)(
        leaves["heap"], red["heap"], start)
    assert torch.equal(got[0], mism[0].cpu()) and torch.equal(got[1], clean[0].cpu())
    assert bool(got[0, 4600 - start]) and int(got[0].sum()) == 1
    red = store.settle(red, leaves, step=3)
    assert all(bool(v) for v in store.verify_meta(red).values())


def test_rung1_abandons_a_held_update_on_card(cuda_device):
    """Rung 1 with the update held on the side stream: retries, then
    exhaustion and the sync escalation's blocking updates, then recovery
    to HEALTHY; verify_meta never alarms from the first blocking pass on
    and after ``flush``, and every field then equals a blocking twin's
    that took the same writes."""
    hp = HealthPolicy(dispatch_timeout_s=0.02, dispatch_retry_attempts=2,
                      retry_backoff_s=0.0, backpressure="spin",
                      backpressure_spin_s=0.0, recovery_ticks=2,
                      violation_mode="report")
    store = _store(cuda_device, health=hp)
    twin = _store(cuda_device, async_tick=False)
    leaves, tleaves = _leaves(cuda_device), _leaves(cuda_device)
    red = store.flush(leaves, store.init(leaves), 0)
    tred = twin.flush(tleaves, twin.init(tleaves), 0)
    rng, trng = np.random.default_rng(1), np.random.default_rng(1)
    kinds, states, metas = [], [], []
    for step in range(1, 21):
        leaves, red = _write(store, leaves, red, rng, cuda_device)
        tleaves, tred = _write(twin, tleaves, tred, trng, cuda_device)
        if step == 2:
            _hold(store)
        if 3 <= step <= 6:
            time.sleep(0.03)              # older than the timeout, still held
        red, rep = store.tick(leaves, red, step, scrub_period=0)
        tred, _ = twin.tick(tleaves, tred, step, scrub_period=0)
        kinds += [a.kind for a in rep.health.actions]
        states.append(rep.health.worst)
        if "retry_exhausted" in kinds:
            # From the first blocking pass on, which already waits for the
            # held update on the device.  Earlier, verify_meta would order
            # the foreground after the held update, and the next step's
            # index copy from pageable host memory would wait for it.
            metas.append(torch.stack([v.reshape(()) for v in
                                      store.verify_meta(red).values()]))
    assert {"retry_timeout", "retry_exhausted", "sync_escalate"} <= set(kinds), kinds
    assert states[-1] == HEALTHY and "critical" in states
    red = store.flush(leaves, red, 21)
    tred = twin.flush(tleaves, tred, 21)
    metas.append(torch.stack([v.reshape(()) for v in store.verify_meta(red).values()]))
    assert bool(torch.stack(metas).all()), "verify_meta alarmed"
    _assert_same(_host(store, leaves, red), _host(twin, tleaves, tred))
