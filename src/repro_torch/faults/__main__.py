"""Fault-injection battery:  ``python -m repro_torch.faults --smoke``.

The port of ``python -m repro.faults``, on the card unless ``--device
cpu`` is given.  Seeded, deterministic passes:

1. **Crash sweep**: enumerate every lifecycle phase the pipelined tick
   fires (dispatch, coalesce while held in flight, lazy adoption, forced
   resolve, scrub, flush, ...) and crash and restart at each one; every
   outcome must be bitwise-recoverable.
2. **Crash + corruption**: at a mid-flight crash point, corrupt one block
   outside the vulnerability window (must be parity-repaired on restore)
   and one inside it (the loss must lie provably within the window).
3. **Oracle**: scrub over injected single-stripe corruptions must detect
   100% outside the window with zero false positives, across >= 3 seeds.
4. **Patroller**: a bitflip on a settled store must be found by the
   background patrol alone (no scheduled scrub), repaired bitwise, and
   leave the store clean.

5. **Sharded battery** (the reference's ``sharded_child``): a store on a
   simulated (2, 2, 2) mesh, every shard on the battery's one device; the
   oracle over global block geometry (several shards hit), then the crash
   subset (dispatch, coalesce, adopt, adopt_forced, the batched launch and
   the wait for it, flush), then a shard wiped wholesale and rebuilt
   bitwise from the patroller's cross-shard parity while the store keeps
   ticking.  The reference's sharded process needs forced host devices;
   the port runs the pass in this process (``--no-sharded`` skips it,
   ``--sharded-child`` runs it alone).

The reference's ``--chaos`` soak is not ported yet (ROADMAP.md, Queue 1
item 11.5 (c), the chaos soak) and raises.

Exit status 1 on any violation.
"""
from __future__ import annotations

import argparse
import functools
import sys
import tempfile
import time

import numpy as np
import torch

from ..common import resolve_device
from ..core import ProtectedStore, RedundancyPolicy
from ..dist import P
from ..launch.mesh import make_mesh
from .crashpoints import CrashPlan, CrashPointMachine
from .inject import FaultInjector, FaultSpec
from .oracle import check_detection, vulnerability_window

# The pipeline phases a sweep must prove crash-safe: dispatch, mid-flight,
# lazy adoption, forced resolve, the batched launch and the wait for it,
# and the classic write/tick/flush points.
REQUIRED_PHASES = ("dispatch", "coalesce", "adopt", "adopt_forced",
                   "dispatcher_enqueue", "dispatcher_join",
                   "on_write", "tick", "flush")

CHAOS_REFUSAL = ("the chaos soak (repro.faults.chaos) is not ported yet: "
                 "ROADMAP.md, Queue 1 item 11.5 (c), the chaos soak")


def _make_leaves(device):
    """The reference smoke's leaves (its shapes and dtypes; the values are
    numpy's, seeded)."""
    w = np.random.default_rng(0).standard_normal((24, 200)).astype(np.float32)
    e = np.random.default_rng(1).standard_normal((16, 64)).astype(np.float32)
    return {"w": torch.from_numpy(w).to(device),
            "e": torch.from_numpy(e).to(device=device, dtype=torch.bfloat16)}


def _make_store(device):
    # period 2 + a deadline of 3 + a scrub at step 5 exercises dispatch
    # (step 2), coalescing while held in flight (step 4), deadline- and
    # scrub-forced resolution (step 5) and lazy adoption (step 6).
    pol = RedundancyPolicy.single(
        "vilamb", period_steps=2, max_vulnerable_steps=3,
        lanes_per_block=128, work_queue_frac=0.5, async_tick=True,
        precompile=False)
    return ProtectedStore(pol, device=device).attach(_make_leaves(device))


def _machine(device, tmp, seed, steps, scrub_every):
    return CrashPointMachine(
        functools.partial(_make_store, device),
        functools.partial(_make_leaves, device), tmp, seed=seed, steps=steps,
        scrub_every=scrub_every, hold_inflight_steps=(3, 4))


def crash_sweep(device, seed: int, steps: int, tmp: str) -> int:
    outcomes = _machine(device, tmp, seed, steps, 5).sweep(
        require_phases=REQUIRED_PHASES)
    bad = [o for o in outcomes if not o.ok]
    byc = {}
    for o in outcomes:
        byc[o.classification] = byc.get(o.classification, 0) + 1
    print(f"  crash sweep seed={seed}: {len(outcomes)} crash points, "
          f"outcomes={byc}")
    for o in bad:
        print(f"    FAIL {o.plan.phase}#{o.plan.occurrence} step={o.step}: "
              f"{o.classification} diverged={o.diverged} "
              f"scrub_after={o.scrub_after_flush}")
    return len(bad)


def crash_with_corruption(device, seed: int, steps: int, tmp: str) -> int:
    """Corrupt the persisted state at a mid-flight crash: outside-window
    blocks must repair, inside-window blocks must be provably in-window."""
    machine = _machine(device, f"{tmp}/fx", seed, steps, 0)
    fired = machine.enumerate_phases()
    plans = [CrashPlan(p, o) for p, o in fired if p == "dispatch"]
    if not plans:
        print("  crash+corruption: no dispatch phase fired (workload bug)")
        return 1
    plan = plans[-1]
    probe = machine.run_crash(plan)            # learn the window at the crash
    fails = 0
    meta = machine._probe().protected_metas["w"]
    window_w = probe.window.get("w", set())
    clean = [b for b in range(meta.n_blocks)
             if b not in window_w
             and not any((b // meta.stripe_data_blocks)
                         == (v // meta.stripe_data_blocks)
                         for v in window_w)]
    if clean:
        out = machine.run_crash(plan, faults=(
            FaultSpec(kind="data_bitflip", leaf="w", block=clean[0],
                      lane=3, bit=7),))
        ok = out.classification == "recovered_bitwise"
        print(f"  crash+corruption outside window @{plan.phase}: "
              f"{out.classification} {'OK' if ok else 'FAIL'}")
        fails += 0 if ok else 1
    if window_w:
        b = sorted(window_w)[0]
        out = machine.run_crash(plan, faults=(
            FaultSpec(kind="data_bitflip", leaf="w", block=b, lane=3,
                      bit=7),))
        ok = out.ok
        print(f"  crash+corruption inside window @{plan.phase}: "
              f"{out.classification} {'OK' if ok else 'FAIL'}")
        fails += 0 if ok else 1
    return fails


def oracle_pass(device, seed: int, steps: int) -> int:
    store = _make_store(device)
    leaves = _make_leaves(device)
    inj = FaultInjector(store, seed=seed)
    rng = np.random.default_rng(seed)
    red = store.init(leaves)
    for step in range(1, steps + 1):
        rows = rng.choice(24, size=int(rng.integers(1, 4)), replace=False)
        idx = torch.as_tensor(np.sort(rows), device=device)
        w = leaves["w"].clone()
        w[idx] += 0.5
        leaves = dict(leaves, w=w)
        ev = torch.zeros((24,), dtype=torch.bool, device=device).index_fill_(0, idx, True)
        red = store.on_write(red, events={"w": ev})
        red, _ = store.tick(leaves, red, step)
    # single-stripe corruptions outside the live window: all must detect
    specs = inj.plan_clean_blocks(red, n=5, kinds=("data_bitflip",
                                                   "stale_redundancy"))
    window = vulnerability_window(store, red)
    leaves2, red2 = inj.inject_many(leaves, red, specs)
    report = check_detection(store, leaves2, red2, specs, window=window)
    ok = report.ok and sum(len(v) for v in report.expected.values()) == len(
        {(s.leaf, b) for s in specs for b in s.touched_blocks})
    print(f"  oracle seed={seed}: {report.summary()} "
          f"{'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


def patrol_pass(device, seed: int, steps: int) -> int:
    """Patroller detection leg: an injected bitflip on a settled store must
    be found by the background patrol (no scheduled scrub) within about two
    sweeps of quiet ticks, repaired bitwise, and leave the store clean."""
    pol = RedundancyPolicy.single(
        "vilamb", period_steps=2, lanes_per_block=128, async_tick=True,
        patrol_bytes_per_tick=8 * 128 * 4, precompile=False)
    leaves = _make_leaves(device)
    store = ProtectedStore(pol, device=device).attach(leaves)
    rng = np.random.default_rng(seed)
    red = store.init(leaves)
    for step in range(1, steps + 1):
        rows = rng.choice(24, size=int(rng.integers(1, 4)), replace=False)
        idx = torch.as_tensor(np.sort(rows), device=device)
        w = leaves["w"].clone()
        w[idx] += 0.5
        leaves = dict(leaves, w=w)
        ev = torch.zeros((24,), dtype=torch.bool, device=device).index_fill_(0, idx, True)
        red = store.on_write(red, events={"w": ev})
        red, _ = store.tick(leaves, red, step)
    red = store.flush(leaves, red, steps + 1)      # settle: V -> 0
    expected = {n: v.clone() for n, v in leaves.items()}
    blk = 5 + seed
    leaves, red = store.inject(leaves, red, FaultSpec(
        kind="data_bitflip", leaf="w", block=blk, lane=3, bit=7))
    step = steps + 2
    store.patroller.expect_injection("w", blk, step)
    # Round robin over both leaves, a probe landing one tick after its
    # dispatch, plus repair pacing: two full sweeps plus slack.
    nb = sum(store.protected_metas[n].n_blocks for n in ("w", "e"))
    budget = 4 * (nb // 8 + 2) + 16
    detected = repaired = False
    for _ in range(budget):
        red, rep = store.tick(leaves, red, step, scrub_period=0)
        step += 1
        if rep.repaired:
            leaves = dict(leaves, **rep.repaired)
            repaired = True
        if store.patroller.latencies:
            detected = True
        if detected and repaired:
            break
    clean = store.scrub_check(leaves, red) == 0
    bitwise = all(torch.equal(leaves[n].view(torch.uint8), expected[n].view(torch.uint8))
                  for n in expected)
    pat = store.patroller
    lat = pat.latency_stats(step_seconds=1.0)
    ok = detected and repaired and clean and bitwise
    diag = ("" if ok else
            f" [budget={budget} starved={pat.starved_ticks} "
            f"sweeps={dict(pat.sweeps)} scanned={pat.blocks_scanned} "
            f"probe_out={pat._probe is not None}]")
    print(f"  patrol seed={seed}: detected={detected} (latency "
          f"{lat['mean_s']:.0f} ticks) repaired={repaired} clean={clean} "
          f"bitwise={bitwise} {'OK' if ok else 'FAIL'}{diag}")
    return 0 if ok else 1


def sharded_child(device, seed: int, steps: int) -> int:
    """The sharded battery: the oracle over global block geometry, the
    crash subset and the shard rebuild, on a store over a simulated (2, 2,
    2) mesh."""
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device=device)
    specs = {"w": P(("pod", "data", "model"), None)}

    def make_leaves():
        w = np.random.default_rng(0).standard_normal((64, 2048)).astype(np.float32)
        return {"w": torch.from_numpy(w).to(device)}

    def make_store():
        pol = RedundancyPolicy.single(
            "vilamb", period_steps=2, max_vulnerable_steps=3,
            lanes_per_block=128, work_queue_frac=0.5, async_tick=True,
            precompile=False)
        return ProtectedStore(pol, mesh=mesh).attach(make_leaves(), specs=specs)

    fails = 0
    # -- oracle over global block geometry (multiple shards must be hit) --
    store = make_store()
    leaves = make_leaves()
    inj = FaultInjector(store, seed=seed)
    rng = np.random.default_rng(seed)
    red = store.init(leaves)
    for step in range(1, steps + 1):
        rows = rng.choice(64, size=int(rng.integers(1, 4)), replace=False)
        idx = torch.as_tensor(np.sort(rows), device=device)
        w = leaves["w"].clone()
        w[idx] += 0.5
        leaves = dict(leaves, w=w)
        ev = torch.zeros((64,), dtype=torch.bool, device=device).index_fill_(0, idx, True)
        red = store.on_write(red, events={"w": ev})
        red, _ = store.tick(leaves, red, step)
    spec_list = inj.plan_clean_blocks(red, n=6, kinds=("data_bitflip",
                                                      "stale_redundancy"))
    nb = store.protected_metas["w"].n_blocks
    shards_hit = {s.block // nb for s in spec_list}
    window = vulnerability_window(store, red)
    leaves2, red2 = inj.inject_many(leaves, red, spec_list)
    report = check_detection(store, leaves2, red2, spec_list, window=window)
    ok = report.ok and len(shards_hit) > 1
    print(f"  sharded oracle seed={seed}: {report.summary()} "
          f"shards_hit={sorted(shards_hit)} {'OK' if ok else 'FAIL'}")
    fails += 0 if ok else 1
    # -- crash-point subset on the sharded overlap pipeline --
    with tempfile.TemporaryDirectory() as tmp:
        machine = CrashPointMachine(
            make_store, make_leaves, tmp, seed=seed, steps=steps,
            scrub_every=5, hold_inflight_steps=(3, 4))
        fired = machine.enumerate_phases()
        plans = []
        for ph in ("dispatch", "coalesce", "adopt", "adopt_forced",
                   "dispatcher_enqueue", "dispatcher_join", "flush"):
            occ = [o for p, o in fired if p == ph]
            if occ:
                plans.append(CrashPlan(ph, occ[-1]))
        for plan in plans:
            out = machine.run_crash(plan)
            print(f"  sharded crash @{plan.phase}#{plan.occurrence}: "
                  f"{out.classification} {'OK' if out.ok else 'FAIL'}")
            fails += 0 if out.ok else 1
    # -- wholesale shard loss: the online rebuild from cross-shard parity --
    fails += sharded_rebuild_case(device, seed, mesh, specs)
    return fails


def sharded_rebuild_case(device, seed: int, mesh, specs) -> int:
    """One shard wiped wholesale must rebuild bitwise from the patroller's
    cross-shard parity while the store keeps ticking (no restore)."""
    pol = RedundancyPolicy.single(
        "vilamb", period_steps=2, lanes_per_block=128, async_tick=True,
        patrol_bytes_per_tick=32 * 128 * 4, precompile=False)
    w = np.random.default_rng(seed).standard_normal((64, 2048)).astype(np.float32)
    leaves = {"w": torch.from_numpy(w).to(device)}
    store = ProtectedStore(pol, mesh=mesh).attach(leaves, specs={"w": specs["w"]})
    red = store.init(leaves)
    rng = np.random.default_rng(seed)
    step = 0
    for _ in range(3):
        rows = rng.choice(64, size=4, replace=False)
        idx = torch.as_tensor(np.sort(rows), device=device)
        w = leaves["w"].clone()
        w[idx] += 0.5
        leaves = dict(leaves, w=w)
        ev = torch.zeros((64,), dtype=torch.bool, device=device).index_fill_(0, idx, True)
        red = store.on_write(red, events={"w": ev})
        red, _ = store.tick(leaves, red, step)
        step += 1
    red = store.flush(leaves, red, step)
    pat = store.patroller
    for _ in range(48):          # quiet sweeps until xpar covers the leaf
        red, _ = store.tick(leaves, red, step, scrub_period=0)
        step += 1
        xp = pat.xpar.get("w")
        # Probes racing the warm writes fail adoption (their slabs saw
        # live rows), so sweep counts under-promise: wait for coverage.
        if xp is not None and bool(xp.xvalid.all()):
            break
    else:
        print(f"  sharded shard-loss rebuild seed={seed}: xpar never "
              "covered the leaf FAIL")
        return 1
    expected = leaves["w"].clone()
    lost = 3
    leaves, red = store.inject(leaves, red, FaultSpec(
        kind="shard_loss", leaf="w", block=lost))
    store.declare_shard_lost("w", lost, red)
    status = None
    for _ in range(32):
        red, rep = store.tick(leaves, red, step, scrub_period=0)
        step += 1
        if rep.repaired:
            leaves = dict(leaves, **rep.repaired)
        if rep.rebuild is not None and rep.rebuild.done:
            status = rep.rebuild
            break
    red = store.flush(leaves, red, step)
    clean = store.scrub_check(leaves, red) == 0
    bitwise = torch.equal(leaves["w"].view(torch.int32), expected.view(torch.int32))
    ok = (status is not None and status.lost == 0 and clean and bitwise)
    print(f"  sharded shard-loss rebuild seed={seed}: "
          f"status={status} clean={clean} bitwise={bitwise} "
          f"{'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--smoke", action="store_true",
                   help="CI budget: 1 crash-sweep seed, 3 oracle seeds")
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--device", default=None,
                   help="where the stores run (default: the card)")
    p.add_argument("--no-sharded", action="store_true",
                   help="skip the sharded battery")
    p.add_argument("--chaos", action="store_true",
                   help="the reference's chaos soak (not ported yet: raises)")
    p.add_argument("--sharded-child", action="store_true",
                   help="run only the sharded battery (seed = --seeds)")
    p.add_argument("--chaos-child", action="store_true",
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.chaos or args.chaos_child:
        raise NotImplementedError(CHAOS_REFUSAL)
    device = resolve_device(args.device, "python -m repro_torch.faults")
    if args.sharded_child:
        return 1 if sharded_child(device, args.seeds, args.steps) else 0
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"== fault battery on {device} ({name}) ==")

    t0 = time.time()
    fails = 0
    sweep_seeds = 1 if args.smoke else args.seeds
    with tempfile.TemporaryDirectory() as tmp:
        print("== crash-point sweep ==")
        for seed in range(sweep_seeds):
            fails += crash_sweep(device, seed, args.steps, f"{tmp}/s{seed}")
        print("== crash + corruption ==")
        fails += crash_with_corruption(device, 0, args.steps, tmp)
    print("== vulnerability-window oracle ==")
    for seed in range(max(args.seeds, 3)):
        fails += oracle_pass(device, seed, args.steps)
    print("== scrub patroller detection ==")
    for seed in range(1 if args.smoke else max(args.seeds, 2)):
        fails += patrol_pass(device, seed, args.steps)
    if not args.no_sharded:
        print("== sharded battery (2x2x2 mesh, simulated on one device) ==")
        fails += sharded_child(device, 0, args.steps)
    dt = time.time() - t0
    print(f"== fault battery {'OK' if not fails else f'FAILED ({fails})'} "
          f"in {dt:.1f}s ==")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
