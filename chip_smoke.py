#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Vilamb on one GPU and check it.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a machine with an sm_90a card (H100).
Phases, each of which must pass or the script exits non-zero:

1. device: the nvidia-smi name/power-limit line; a CUDA device is required;
2. build: every kernel under src/repro_torch/csrc compiles (nvcc, sm_90a);
3. kernels: each kernel is bitwise equal to its plain PyTorch version at
   small shapes (partial stripes, L in {128, 1024, 16384}, a block offset,
   zero/one/all-dirty work queues, NaN/Inf/zero/saturated payloads);
4. main path: a ProtectedStore over an 8 GiB vilamb heap of 4 KiB rows
   (2,097,152 blocks, 4+1 stripes, T=16, deadline 32) plus a 64 MiB sync
   params leaf: attach, init, 64 steps of 4,096 random row writes with
   on_write + tick, flush, one corrupted lane found by scrub, recover_block,
   a clean rescrub and verify_meta; the kernel launch counts of this run;
5. each kernel at the main path's shapes against its plain version, timed,
   then a chunked plain recompute of all checksums and parity, bitwise.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON record.  All data comes from ``--seed``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import LeafPolicy, ProtectedStore, RedundancyPolicy  # noqa: E402
from repro_torch.core import blocks  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.checksum import ops as ck_ops, ref as ck_ref  # noqa: E402
from repro_torch.kernels.parity import ops as par_ops, ref as par_ref  # noqa: E402
from repro_torch.kernels.redundancy import ops as fu_ops, ref as fu_ref  # noqa: E402

# H100 SXM peaks at 700 W: the HBM3 rate (NVIDIA data sheet), and the
# INT32 rate for the kernels' integer operations: 132 SMs x 64 INT32
# lanes x 1.98 GHz boost.  (The data sheet's 67 TFLOP/s float32 figure
# counts 128 FP32 lanes and an FMA as two operations.)
HBM_BYTES_PER_SEC = 3.35e12
ALU_OPS_PER_SEC = 132 * 64 * 1.98e9

N_ROWS, ROW = 2_097_152, 1024           # 8 GiB of fp32, one 4 KiB block per row
STRIPE, PERIOD, DEADLINE = 4, 16, 32
STEPS, ROWS_PER_STEP = 64, 4096
CHUNK = 65_536                          # blocks per chunk of the plain full check
DEVICE = "cuda"

SPECIALS = [0x7FC00000, 0x7F800000, 0xFF800000, 0x7F800001, 0x00000000, 0xFFFFFFFF]


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def timed(fn):
    """(result, ms) of ``fn`` between CUDA events around a synchronised region."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def per_call_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back calls after a warm-up.
    Each call's output is dropped before the next, so the caching allocator
    reuses one buffer instead of allocating ``reps`` of them."""
    def run():
        for _ in range(reps):
            fn()
    fn()                                 # warm-up
    _, ms = timed(run)
    return ms / reps


def abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def rand_i32(g, *shape) -> torch.Tensor:
    return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, generator=g,
                         device=DEVICE)


def specials(nb: int, L: int, offset: int) -> torch.Tensor:
    vals = torch.tensor([v - (1 << 32) if v >= 1 << 31 else v for v in SPECIALS],
                        dtype=torch.int32, device=DEVICE)
    idx = (torch.arange(nb * L, device=DEVICE) + offset) % len(SPECIALS)
    return vals[idx].reshape(nb, L)


def stripe_mask(bd: torch.Tensor, P: int) -> torch.Tensor:
    ns = -(-bd.shape[0] // P)
    pad = torch.zeros(ns * P, dtype=torch.bool, device=bd.device)
    pad[: bd.shape[0]] = bd
    return pad.view(ns, P).any(dim=1)


def phase_kernels(g) -> dict:
    """Every kernel against its plain version at small shapes, bitwise."""
    err = {"checksum": 0, "parity": 0, "fused_update": 0}
    for nb, L, off, special in [(13, 128, 0, False), (37, 1024, 5, False),
                                (6, 16384, 1000, False), (13, 256, 3, True)]:
        lanes = specials(nb, L, off) if special else rand_i32(g, nb, L)
        got, want = ck_ops.block_checksums(lanes, off), ck_ref.block_checksums(lanes, off)
        check(torch.equal(got, want), f"checksum kernel != plain at {nb}x{L} off={off}")
        err["checksum"] = max(err["checksum"], abs_err(got, want))
    for nb, L, P, special in [(13, 128, 4, False), (37, 1024, 4, False),
                              (6, 16384, 4, False), (10, 128, 5, True), (9, 256, 2, False)]:
        lanes = specials(nb, L, 1) if special else rand_i32(g, nb, L)
        got, want = par_ops.stripe_parity(lanes, P), par_ref.stripe_parity(lanes, P)
        check(torch.equal(got, want), f"parity kernel != plain at {nb}x{L} P={P}")
        err["parity"] = max(err["parity"], abs_err(got, want))
    cases = [("zero dirty", 13, 128, lambda nb: torch.zeros(nb, dtype=torch.bool)),
             ("one dirty", 37, 1024, lambda nb: torch.arange(nb) == 17),
             ("all dirty", 12, 16384, lambda nb: torch.ones(nb, dtype=torch.bool)),
             ("partial last stripe", 38, 1024, lambda nb: torch.arange(nb) >= 36),
             ("random", 41, 128, lambda nb: torch.arange(nb) % 3 == 0),
             ("specials", 12, 256, lambda nb: torch.arange(nb) % 5 == 0)]
    for name, nb, L, mk in cases:
        lanes = specials(nb, L, 2) if name == "specials" else rand_i32(g, nb, L)
        bd = mk(nb).to(DEVICE)
        sd = stripe_mask(bd, STRIPE)
        old_c, old_p = rand_i32(g, nb), rand_i32(g, sd.shape[0], L)
        want = fu_ref.fused_update(lanes, old_c, old_p, bd, sd, STRIPE)
        got = fu_ops.fused_update(lanes, old_c.clone(), old_p.clone(), bd, sd, STRIPE)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"fused_update kernel != plain ({name}, {nb}x{L})")
        err["fused_update"] = max(err["fused_update"], abs_err(got[0], want[0]),
                                  abs_err(got[1], want[1]))
    torch.cuda.synchronize()
    return err


def phase_main(g) -> dict:
    """The store lifecycle on the 8 GiB heap; returns state and timings."""
    dev = torch.device(DEVICE)
    heap = torch.randn((N_ROWS, ROW), generator=g, device=dev)
    params = torch.randn((16384, 1024), generator=g, device=dev)      # 64 MiB
    state = {"heap": heap, "params": params}
    policy = RedundancyPolicy(
        default=LeafPolicy(mode="vilamb", period_steps=PERIOD,
                           max_vulnerable_steps=DEADLINE),
        rules=(("params*", LeafPolicy(mode="sync")),),
        lanes_per_block=ROW, stripe_data_blocks=STRIPE)
    torch.cuda.synchronize()
    ck_ops.LAUNCHES = par_ops.LAUNCHES = fu_ops.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()

    store, init_ms = timed(lambda: ProtectedStore(policy).attach(state))
    red, ms = timed(lambda: store.init(state))
    init_ms += ms
    meta = store.metas["heap"]
    check((meta.n_blocks, meta.n_stripes) == (N_ROWS, N_ROWS // STRIPE),
          f"heap geometry {meta.n_blocks} blocks, {meta.n_stripes} stripes")
    due_ms, updated_steps = [], []
    for step in range(STEPS):            # steps 0..63: due at 16, 32, 48
        rows = torch.randperm(N_ROWS, generator=g, device=dev)[:ROWS_PER_STEP]
        heap[rows] = torch.randn((ROWS_PER_STEP, ROW), generator=g, device=dev)
        old_params = params.clone()
        params.mul_(0.999)
        ev = torch.zeros(N_ROWS, dtype=torch.bool, device=dev)
        ev[rows] = True
        red = store.on_write(red, events={"heap": ev}, old={"params": old_params},
                             new={"params": params})
        (red, report), ms = timed(lambda: store.tick(state, red, step))
        if report.updated:
            due_ms.append(ms)
            updated_steps.append(step)
    check(updated_steps == [16, 32, 48], f"due ticks at {updated_steps}")
    stats = {k: int(v) for k, v in store.dirty_stats(red)["heap"].items()}
    est = store.estimate_flush(red)
    red, flush_ms = timed(lambda: store.flush(state, red, step=STEPS))

    lanes = blocks.to_lanes(heap, meta)
    check(lanes.data_ptr() == heap.data_ptr(), "heap lane view is not a view")
    bad = int(torch.randint(0, N_ROWS, (1,), generator=g, device=dev))
    saved = lanes[bad].clone()
    lanes[bad, 99] ^= 0xBAD
    masks, scrub_ms = timed(lambda: store.scrub(state, red))
    flagged = torch.nonzero(masks["heap"]).flatten().tolist()
    check(flagged == [bad], f"scrub flagged {flagged[:8]}, expected [{bad}]")
    check(int(masks["params"].sum()) == 0, "scrub flagged params blocks")
    (fixed, ok), recover_ms = timed(
        lambda: store.recover_block(heap, red["heap"], "heap", bad))
    check(ok and fixed.data_ptr() == heap.data_ptr(), "recover_block refused or copied")
    check(torch.equal(lanes[bad], saved), "recovered block differs from the original")
    masks, rescrub_ms = timed(lambda: store.scrub(state, red))
    check(sum(int(m.sum()) for m in masks.values()) == 0,
          "scrub after repair still flags blocks")
    check(all(bool(v) for v in store.verify_meta(red).values()), "verify_meta failed")
    torch.cuda.synchronize()
    launches = {"checksum": ck_ops.LAUNCHES, "parity": par_ops.LAUNCHES,
                "fused_update": fu_ops.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for name, n in launches.items():
        check(n > 0, f"{name} kernel never launched on the main path")
    return {
        "store": store, "state": state, "red": red, "launches": launches,
        "timings": {
            "init_ms": init_ms, "due_tick_ms_mean": sum(due_ms) / len(due_ms),
            "due_tick_ms": due_ms, "flush_ms": flush_ms, "scrub_ms": scrub_ms,
            "rescrub_ms": rescrub_ms, "recover_ms": recover_ms, "peak_mem_gb": peak_gb,
            "flush_dirty_blocks": stats["dirty_blocks"],
            "flush_vulnerable_stripes": stats["vulnerable_stripes"],
            "flush_estimate_ms": est.seconds * 1e3,
            "copy_gb_per_s": store.copy_bytes_per_sec() / 1e9,
        },
    }


def phase_update_profile(g, main: dict) -> None:
    """A due tick's update, warm: time it with CUDA events, then trace the
    same work with torch.profiler for the device time by kernel.  Also time
    a repeat of init (its result is discarded)."""
    store, state = main["store"], main["state"]
    ev = torch.zeros(N_ROWS, dtype=torch.bool, device=DEVICE)
    for _ in range(PERIOD):
        ev[torch.randperm(N_ROWS, generator=g, device=DEVICE)[:ROWS_PER_STEP]] = True
    heap_engine = store.engine_for("heap")

    def mark(red):
        return dict(red, **heap_engine.mark_dirty({"heap": red["heap"]}, {"heap": ev}))

    red, update_ms = timed(lambda: store.flush(state, mark(main["red"])))
    red = mark(red)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        red = store.flush(state, red)
        torch.cuda.synchronize()
    launches = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel: dict = {}
    for e in launches:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    main["red"] = red
    _, init_ms = timed(lambda: store.init(state))
    main["timings"].update({
        "due_update_warm_ms": update_ms, "init_warm_ms": init_ms,
        "due_update_device_busy_ms": (sum(by_kernel.values()) if launches
                                      else "not measured"),
        "due_update_device_launches": len(launches),
        "due_update_top_kernels_ms": dict(sorted(
            by_kernel.items(), key=lambda kv: -kv[1])[:8]),
    })


def bound(bytes_moved: float, ops: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_SEC, ops / ALU_OPS_PER_SEC
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_kernel_times(g, main: dict, err: dict) -> list:
    """Each kernel at the main path's shapes: bitwise against its plain
    version, its time, the plain version's time and the bound."""
    red = main["red"]["heap"]
    meta = main["store"].metas["heap"]
    lanes = blocks.to_lanes(main["state"]["heap"], meta)
    nb, L = lanes.shape
    ns = nb // STRIPE
    rows = []

    got, want = ck_ops.block_checksums(lanes), ck_ref.block_checksums(lanes)
    check(torch.equal(got, want), "checksum kernel != plain on the 8 GiB heap")
    err["checksum"] = max(err["checksum"], abs_err(got, want))
    del got, want
    rows.append(("checksum", "checksum.cu", "checksum/checksum.py:49",
                 per_call_ms(lambda: ck_ops.block_checksums(lanes), 10),
                 per_call_ms(lambda: ck_ref.block_checksums(lanes), 2),
                 *bound(nb * L * 4 + nb * 4, nb * L * 12)))

    got, want = par_ops.stripe_parity(lanes, STRIPE), par_ref.stripe_parity(lanes, STRIPE)
    check(torch.equal(got, want), "parity kernel != plain on the 8 GiB heap")
    err["parity"] = max(err["parity"], abs_err(got, want))
    del got, want
    rows.append(("parity", "parity.cu", "parity/parity.py:29",
                 per_call_ms(lambda: par_ops.stripe_parity(lanes, STRIPE), 10),
                 per_call_ms(lambda: par_ref.stripe_parity(lanes, STRIPE), 2),
                 *bound(nb * L * 4 + ns * L * 4, nb * L)))

    # A due tick's queue: 16 steps of 4,096 random rows.
    bd = torch.zeros(nb, dtype=torch.bool, device=DEVICE)
    for _ in range(PERIOD):
        bd[torch.randperm(nb, generator=g, device=DEVICE)[:ROWS_PER_STEP]] = True
    sd = stripe_mask(bd, STRIPE)
    n_dirty, n_stripes = int(bd.sum()), int(sd.sum())
    old_c = red.checksums.clone()
    old_c[bd] ^= 0x5A5A5A5A
    old_p = red.parity.clone()
    old_p[sd] ^= 0x0F0F0F0F
    want = fu_ref.fused_update(lanes, old_c, old_p, bd, sd, STRIPE)
    got = fu_ops.fused_update(lanes, old_c.clone(), old_p, bd, sd, STRIPE)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "fused_update kernel != plain on the 8 GiB heap")
    err["fused_update"] = max(err["fused_update"], abs_err(got[0], want[0]),
                              abs_err(got[1], want[1]))
    del want
    cks = got[0]
    fu_ms = per_call_ms(lambda: fu_ops.fused_update(lanes, cks, old_p, bd, sd, STRIPE), 20)
    plain_ms = per_call_ms(lambda: fu_ref.fused_update(lanes, cks, old_p, bd, sd, STRIPE), 2)
    # The queued stripes' members (read), their parity rows (written), the
    # dirty checksums (written), the members' dirty-mask bytes, the ids and
    # the count (read).
    fu_bytes = (n_stripes * STRIPE * L * 4 + n_stripes * L * 4 + n_dirty * 4
                + n_stripes * STRIPE + n_stripes * 4 + 4)
    rows.append(("fused_update", "redundancy.cu", "redundancy/redundancy.py:93",
                 fu_ms, plain_ms, *bound(fu_bytes, n_stripes * STRIPE * L * 13)))
    del old_c, old_p, got, cks
    main["timings"]["fused_queue"] = {"dirty_blocks": n_dirty, "stripes": n_stripes}

    return [{"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
             "replaces": f"src/repro/kernels/{tpu}", "launches": main["launches"][name],
             "max_abs_err": err[name], "ms": ms, "plain_ms": pms, "bound_ms": bms,
             "bound_by": by, "library_ms": None}
            for name, src, tpu, ms, pms, bms, by in rows]


def phase_full_check(main: dict) -> None:
    """Chunked plain recompute of every checksum and parity row, bitwise."""
    store, state, red = main["store"], main["state"], main["red"]
    for name, leaf in state.items():
        meta = store.metas[name]
        lanes = blocks.to_lanes(leaf, meta)
        r = red[name]
        for s in range(0, meta.n_blocks, CHUNK):
            e = min(meta.n_blocks, s + CHUNK)
            check(torch.equal(ck_ref.block_checksums(lanes[s:e], s), r.checksums[s:e]),
                  f"{name}: checksums of blocks {s}..{e} differ from a plain recompute")
            check(torch.equal(par_ref.stripe_parity(lanes[s:e], STRIPE),
                              r.parity[s // STRIPE: -(-e // STRIPE)]),
                  f"{name}: parity of blocks {s}..{e} differs from a plain recompute")
    check(all(bool(v) for v in store.verify_meta(red).values()), "final verify_meta")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or line.startswith("=="):
            print("  " + line.strip())

    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    err = phase_kernels(g)
    print(f"kernels == plain at small shapes: {err}", flush=True)

    t0 = time.perf_counter()
    main_run = phase_main(g)
    print(f"main path ({time.perf_counter() - t0:.1f} s): launches "
          f"{main_run['launches']}", flush=True)
    phase_update_profile(g, main_run)
    kernels = phase_kernel_times(g, main_run, err)
    phase_full_check(main_run)
    print("full check: checksums and parity of every block match a chunked plain "
          "recompute")
    print(json.dumps({"main": main_run["timings"]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
