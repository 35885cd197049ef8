"""The fault battery on the card, against the port's CPU path.

Each test needs a CUDA device and skips without one (decided at run
time).  The same seeded leaves and schedule run through a store on the
card and one on the CPU (the plain versions, held against the reference
by tests/test_torch_faults.py): injected state, the oracle's reports,
repairs, a crash at a dispatch whose update is still running on the side
stream, and redundancy faults injected mid-flight give equal results, bit
for bit.  The last test shows where the card differs: a scribble in place
on the live view's checksums mid-flight survives adoption on the card
(the update refreshes those very tensors) and is dropped on the CPU; on
the card verify_meta catches it.  The module imports no JAX, so on the
card it runs with:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_faults_on_card.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import ProtectedStore, RedundancyPolicy, convert
from repro_torch.core.state import FIELDS
from repro_torch.faults import (CrashPlan, CrashPointMachine, FaultInjector,
                                FaultSpec, check_detection)

ROWS, ROW, STRIPE = 8192, 1024, 4      # 32 MiB of fp32, 8,192 blocks
E_ROWS = 256                           # 2 MiB of bf16, 4 KiB rows
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
    e = rng.standard_normal((E_ROWS, 2 * ROW)).astype(np.float32)
    return {"heap": torch.from_numpy(heap).to(dev),
            "e": torch.from_numpy(e).to(dev).to(torch.bfloat16)}


def _store(dev):
    pol = RedundancyPolicy.single("vilamb", period_steps=2, max_vulnerable_steps=3,
                                  lanes_per_block=ROW, stripe_data_blocks=STRIPE,
                                  work_queue_frac=0.5, async_tick=True,
                                  precompile=False)
    return ProtectedStore(pol, device=dev).attach(_leaves(dev))


def _hold(store):
    """On the card, queue a spin on the side stream: the next update runs
    behind it, still in flight while the host goes on."""
    if store.device.type == "cuda":
        with torch.cuda.stream(store._side_stream()):
            torch.cuda._sleep(SLEEP_CYCLES)


def _drive(dev, steps=6, hold_last=False):
    """64 random heap rows and 4 bf16 rows shifted a step (of copies), on a
    store of ``dev``; the last step's update held in flight on the card."""
    store, leaves = _store(dev), _leaves(dev)
    red = store.init(leaves)
    rng = np.random.default_rng(1)
    for step in range(1, steps + 1):
        events = {}
        for name, n, k in (("heap", ROWS, 64), ("e", E_ROWS, 4)):
            idx = torch.as_tensor(np.sort(rng.choice(n, size=k, replace=False)),
                                  device=dev)
            v = leaves[name].clone()
            v[idx] += 0.5 * step
            leaves = dict(leaves, **{name: v})
            events[name] = torch.zeros(n, dtype=torch.bool, device=dev).index_fill_(
                0, idx, True)
        red = store.on_write(red, events=events)
        if hold_last and step == steps:
            _hold(store)
        red, _ = store.tick(leaves, red, step)
    return store, leaves, red


def _host(store, leaves, red):
    """Leaves as raw bytes and red as uint32 fields, on the host."""
    return ({k: v.detach().cpu().contiguous().view(torch.uint8).numpy()
             for k, v in leaves.items()}, convert.red_to_numpy(red, store))


def _assert_same(card, cpu, msg=""):
    (cl, cr), (pl, pr) = _host(*card), _host(*cpu)
    for k in pl:
        np.testing.assert_array_equal(cl[k], pl[k], err_msg=f"{msg} {k}")
    for n in pr:
        for f in FIELDS:
            np.testing.assert_array_equal(cr[n][f], pr[n][f], err_msg=f"{msg} {n}.{f}")


KIND_SPECS = [
    FaultSpec("data_bitflip", "heap", block=5, lane=7, bit=31),
    FaultSpec("data_bitflip", "e", block=3, lane=2, payload=0xFFFFFFFF),
    FaultSpec("checksum_bitflip", "heap", block=9, bit=31),
    FaultSpec("parity_bitflip", "heap", block=9, lane=1000, payload=0x7FC00000),
    FaultSpec("meta_bitflip", "e", bit=31),
    FaultSpec("torn_write", "heap", block=3, blocks=(3, 4, 5)),
    FaultSpec("stale_redundancy", "e", block=7, blocks=(7,), payload=0xFF800000),
    FaultSpec("shard_loss", "e", block=0),
    FaultSpec("mesh_shrink", "heap", block=0, payload=0x80000001),
    FaultSpec("mesh_grow", "e", block=0),
]


def _settled(store, leaves, red):
    return store, leaves, store.settle(red, leaves)


@pytest.mark.parametrize("spec", KIND_SPECS, ids=lambda s: f"{s.kind}-{s.leaf}")
def test_inject_on_card(cuda_device, spec):
    """Every kind equals the CPU's: injected into a settled store, and
    injected mid-flight then adopted (the live view differs while in
    flight: the card's holds the update's arrays).  The card's inputs stay
    untouched."""
    card, cpu = _settled(*_drive(cuda_device)), _settled(*_drive("cpu"))
    _assert_same((card[0], *card[0].inject(card[1], card[2], spec)),
                 (cpu[0], *cpu[0].inject(cpu[1], cpu[2], spec)), spec.kind)
    card, cpu = _drive(cuda_device, hold_last=True), _drive("cpu")
    before = _host(*card)
    got = card[0].inject(card[1], card[2], spec)
    want = cpu[0].inject(cpu[1], cpu[2], spec)
    after = _host(*card)
    for k in before[0]:
        np.testing.assert_array_equal(before[0][k], after[0][k])
    for n in before[1]:
        for f in FIELDS:
            np.testing.assert_array_equal(before[1][n][f], after[1][n][f])
    _assert_same(_settled(card[0], *got), _settled(cpu[0], *want), spec.kind)


def test_oracle_on_card(cuda_device):
    """Planned clean-block faults, the oracle's report, the repair and the
    rescrub on the card equal the CPU's."""
    out = []
    for dev in (cuda_device, "cpu"):
        store, leaves, red = _drive(dev, hold_last=True)
        inj = FaultInjector(store, seed=3)
        specs = inj.plan_clean_blocks(red, 32, ("data_bitflip", "stale_redundancy"))
        specs += inj.plan(2, ("torn_write",), leaf="heap")
        lv, red2 = inj.inject_many(leaves, red, specs)
        rep = check_detection(store, lv, red2, specs)
        masks = store.scrub(lv, red2)
        fixed_lv, fixed, lost = store.repair(lv, red2, masks)
        left = {k: torch.nonzero(m).flatten().tolist()
                for k, m in store.scrub(fixed_lv, red2).items()}
        out.append((specs, dataclasses.asdict(rep), fixed, lost, left,
                    _host(store, fixed_lv, red2)))
    (cs, crep, cf, cl, cleft, ch), (ps, prep, pf, pl, pleft, ph) = out
    assert cs == ps and crep == prep and (cf, cl) == (pf, pl) and cleft == pleft
    assert crep["expected"] and not crep["missed"] and not crep["false_positives"]
    for k in ph[0]:
        np.testing.assert_array_equal(ch[0][k], ph[0][k], err_msg=k)


def _machine(dev, tmp, ready_at_dispatch):
    """The crash machine over the reference smoke's schedule, with step 6's
    update held in flight on the card; records at every dispatch whether
    the update had finished on the device."""
    def make_store():
        store = _store(dev)

        def probe(phase, info):
            if phase == "dispatch":
                p = next(g.pending for g in store.groups.values() if g.pending)
                ready_at_dispatch.append(p.done is None or p.done.query())
        store.add_phase_hook(probe)
        return store

    return CrashPointMachine(make_store, lambda: _leaves(dev), tmp, seed=0, steps=6,
                             scrub_every=5, hold_inflight_steps=(3, 4),
                             actions={6: lambda store, leaves, red: _hold(store)})


def test_crash_at_midflight_dispatch_on_card(cuda_device, tmp_path):
    """A crash at the last dispatch, its update still running on the side
    stream: the persisted view is read after it, and the outcome (step,
    classification, diverged and window blocks, post-flush scrub) equals
    the CPU's, with and without a fault landing while the process is down."""
    ready = []
    card = _machine(cuda_device, tmp_path / "card", ready)
    cpu = _machine("cpu", tmp_path / "cpu", [])
    fired = cpu.enumerate_phases()
    assert card.enumerate_phases() == fired
    plan = [CrashPlan(p, o) for p, o in fired if p == "dispatch"][-1]
    key = lambda o: (o.step, o.classification, o.diverged, o.window,
                     o.scrub_after_flush)
    ready.clear()
    got = card.run_crash(plan)
    assert ready[-1] is False, "the update had finished before the crash"
    want = cpu.run_crash(plan)
    assert key(got) == key(want) and got.classification == "recovered_bitwise"
    window = sorted(got.window["heap"])
    fault = FaultSpec("data_bitflip", "heap", block=window[0], lane=3, bit=7)
    got, want = card.run_crash(plan, (fault,)), cpu.run_crash(plan, (fault,))
    assert key(got) == key(want) and got.classification == "lost_within_window"


@pytest.mark.parametrize("kind", ["checksum_bitflip", "meta_bitflip"])
def test_inflight_redundancy_fault_on_card(cuda_device, kind):
    """Injected while the update is in flight: caught by verify_meta, and
    after settle the card's red equals the CPU's (the fault-free adoption)."""
    out = []
    for dev in (cuda_device, "cpu"):
        store, leaves, red = _drive(dev, steps=2, hold_last=True)
        assert all(g.pending is not None for g in store.groups.values())
        _, red2 = store.inject(leaves, red, FaultSpec(kind, "heap", block=100, bit=31))
        assert not bool(store.verify_meta(red2)["heap"])
        settled = store.settle(red2, leaves, step=2)
        assert all(bool(v) for v in store.verify_meta(settled).values())
        out.append((store, leaves, settled))
    _assert_same(out[0], out[1], kind)


def test_inplace_checksum_scribble_midflight_on_card(cuda_device):
    """A scribble in place on the live view's checksums while the update is
    in flight (not what ``inject`` does: it writes copies) survives
    adoption on the card, whose update refreshes those very tensors, and is
    dropped on the CPU, where the live view holds the previous epoch's
    arrays (as the reference's does).  On the card verify_meta catches it:
    the fault is kept, never silent."""
    kept = {}
    for dev in (cuda_device, "cpu"):
        store, leaves, red = _drive(dev, steps=2, hold_last=True)
        store.await_inflight()
        red["heap"].checksums[100] ^= -2**31
        settled = store.settle(red, leaves, step=2)
        kept[torch.device(dev).type] = not bool(store.verify_meta(settled)["heap"])
    assert kept == {"cuda": True, "cpu": False}
