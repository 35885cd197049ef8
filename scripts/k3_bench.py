"""Time K3 (``csrc/redundancy.cu``) on the card at the main paths' shapes.

    python scripts/k3_bench.py [--cases heap,xlstm,jamba,train] [--old-source F]

Each case is one due group's update, every leaf's packed dirty words in
one ``fused_update_many`` call, checked bitwise against its plain version
(``ref.fused_update_many``) and then timed: CUDA events around 10 calls
after a warm-up, and the kernel's own device time from a profiler trace
of one call.  The bound counts the dirty stripes' members read, their
parity rows and the dirty checksums written, and the packed words read,
at 3.35 TB/s (H100 SXM).  Cases:

* ``heap``: the 8 GiB heap of 4 KiB blocks (2,097,152 rows of 1,024
  fp32, 4+1 stripes) after 16 steps of 4,096 random row writes; beside
  it two yardsticks of the memory system on the same bytes: a gather of
  the dirty stripes (``index_select``, random 16 KiB rows) and a copy of
  as many consecutive stripes, each reading and writing them once;
* ``heap_all``: the same heap with every block dirty;
* ``heap_even``: the same heap with as many dirty stripes, spread so that
  every CTA of the persistent grid finds as many in its share;
* ``xlstm``: 16 ALL-dirty leaves of 64 KiB blocks, 1.41 GB in all;
* ``jamba``: 14 ALL-dirty leaves, 7 of 128 blocks and 7 of 12 (64.5 MB);
* ``train``: 33 ALL-dirty leaves of 64 KiB blocks, 32.15 GB in all.

``--old-source F`` also builds the per-leaf kernel of an earlier
``redundancy.cu`` (its C entry ``vilamb_fused_update``, a work queue of
dirty stripe ids built on the device as its wrapper did) and times it on
the same data, in turns with the new one (old, new, new, old).  The card's
name and power limit are printed first.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import bits  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.redundancy import ops, ref  # noqa: E402

HBM_BYTES_PER_SEC = 3.35e12
P = 4


def leaves_of(case: str, g):
    """(lanes, words) of each leaf of the case, on the card."""
    dev = "cuda"
    if case in ("heap", "heap_all", "heap_even"):
        nb, L = 2_097_152, 1024
        bd = torch.zeros(nb, dtype=torch.bool, device=dev)
        for _ in range(16):
            bd[torch.randperm(nb, generator=g, device=dev)[:4096]] = True
        if case == "heap_all":
            bd[:] = True
        if case == "heap_even":
            # As many dirty stripes, the same number in each CTA's share of
            # the persistent grid's static stride (CTA c takes stripes c,
            # c + G, ...), at random places inside it: one dirty block each.
            ns, grid = nb // P, ops.grid(torch.cuda.current_device(), P, 256)
            k = int(bd.view(-1, P).any(1).sum()) // grid
            per = -(-ns // grid)
            pick = torch.rand((grid, per), generator=g, device=dev).argsort(1)[:, :k]
            stripes = (torch.arange(grid, device=dev)[:, None] + pick * grid).flatten()
            bd[:] = False
            bd[stripes[stripes < ns] * P] = True
        lanes = torch.randint(-2**31, 2**31, (nb, L), dtype=torch.int32, generator=g, device=dev)
        return [(lanes, bits.pack_mask(bd))]
    blocks = {"xlstm": [1344] * 15 + [1344 - 30],
              "jamba": [128] * 7 + [12] * 7,
              "train": [14896] * 33}[case]
    out = []
    for nb in blocks:
        lanes = torch.randint(-2**31, 2**31, (nb, 16384), dtype=torch.int32, generator=g,
                              device=dev)
        out.append((lanes, bits.pack_mask(torch.ones(nb, dtype=torch.bool, device=dev))))
    return out


def bound_ms(leaves) -> float:
    n = 0
    for lanes, words in leaves:
        nb, L = lanes.shape
        bd = bits.unpack(words, nb)
        pad = torch.zeros(-(-nb // P) * P, dtype=torch.bool, device=bd.device)
        pad[:nb] = bd
        ns = int(pad.view(-1, P).any(1).sum())
        n += ns * (P + 1) * L * 4 + int(bd.sum()) * 4 + words.numel() * 4
    return n / HBM_BYTES_PER_SEC * 1e3


def events_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, name: str):
    """Summed device time of the kernels named ``name`` in a trace of one
    call (a traced warm-up call first)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1), acc_events=True) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    ks = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
          and name in e.name]
    return (sum(e.time_range.elapsed_us() for e in ks) / 1e3, len(ks))


def old_library(source: Path):
    """The earlier per-leaf K3 built alone (its C entry vilamb_fused_update)."""
    out = Path(tempfile.mkdtemp(dir=_build.BUILD_ROOT.parent)) / "libk3old.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC),
                    "-o", str(out), str(source)], check=True)
    lib = ctypes.CDLL(str(out))
    v, i = ctypes.c_void_p, ctypes.c_int64
    lib.vilamb_fused_update.argtypes = [v, v, v, v, v, v, i, i, i, i, v]
    lib.vilamb_fused_update.restype = ctypes.c_int
    return lib


def old_call(lib, jobs):
    """The earlier wrapper: per leaf, unpack, stripe mask, a work queue of
    dirty ids (cumsum and scatter) and one launch."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for lanes, cks, par, words in jobs:
        nb, L = lanes.shape
        bd = bits.unpack(words, nb)
        ns = -(-nb // P)
        pad = torch.zeros(ns * P, dtype=torch.bool, device=bd.device)
        pad[:nb] = bd
        sd = pad.view(ns, P).any(1)
        pos = torch.cumsum(sd, 0, dtype=torch.int32)
        buf = torch.empty((ns + 1,), dtype=torch.int32, device=sd.device)
        buf[torch.where(sd, pos, 0)] = torch.arange(ns, dtype=torch.int32, device=sd.device)
        rc = lib.vilamb_fused_update(lanes.data_ptr(), cks.data_ptr(), par.data_ptr(),
                                     bd.data_ptr(), buf[1:].data_ptr(), pos[-1:].data_ptr(),
                                     nb, L, P, min(ns, sms * 16),
                                     torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "old fused_update")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default="heap,xlstm,jamba,train")
    ap.add_argument("--old-source", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_bench: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip())
    _build.library()
    old = old_library(args.old_source) if args.old_source else None
    g = torch.Generator(device="cuda").manual_seed(0)
    for case in args.cases.split(","):
        leaves = leaves_of(case, g)
        jobs = [(lanes, torch.randint(-2**31, 2**31, (lanes.shape[0],), dtype=torch.int32,
                                      generator=g, device="cuda"),
                 torch.randint(-2**31, 2**31, (-(-lanes.shape[0] // P), lanes.shape[1]),
                               dtype=torch.int32, generator=g, device="cuda"), words)
                for lanes, words in leaves]
        want = ref.fused_update_many(jobs, P) if case != "train" else None
        got = ops.fused_update_many([(l, c.clone(), p.clone(), w) for l, c, p, w in jobs], P)
        ok = want is None or all(torch.equal(a, c) and torch.equal(b, d)
                                 for (a, b), (c, d) in zip(got, want))
        if want is None:        # 32 GB: hold the first three leaves to the plain version
            small = jobs[:3]
            ok = all(torch.equal(a, c) and torch.equal(b, d) for (a, b), (c, d) in zip(
                ops.fused_update_many([(l, c.clone(), p.clone(), w) for l, c, p, w in small], P),
                ref.fused_update_many(small, P)))
        del want, got
        rec = {"case": case, "leaves": len(jobs), "bitwise": ok, "bound_ms": bound_ms(leaves)}

        def new():
            ops.fused_update_many(jobs, P)
        if old is not None:
            if case != "train":
                oj = [(l, c.clone(), p.clone(), w) for l, c, p, w in jobs]
                old_call(old, oj)
                nj = [(l, c.clone(), p.clone(), w) for l, c, p, w in jobs]
                ops.fused_update_many(nj, P)
                rec["old_equals_new"] = all(torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
                                            for a, b in zip(oj, nj))
                del oj, nj
            turns = [events_ms(lambda: old_call(old, jobs)), events_ms(new), events_ms(new),
                     events_ms(lambda: old_call(old, jobs))]
            rec["turns_ms_old_new_new_old"] = turns
            rec["old_device_ms"] = device_ms(lambda: old_call(old, jobs), "fused_update_kernel")
        if case == "heap":
            lanes, words = leaves[0]
            nb, L = lanes.shape
            bd = bits.unpack(words, nb)
            ids = bd.view(-1, P).any(1).nonzero().flatten()
            rows = lanes.view(-1, P * L)
            moved = 2 * ids.numel() * P * L * 4
            gms = events_ms(lambda: rows.index_select(0, ids))
            sms = events_ms(lambda: rows[:ids.numel()].clone())
            rec["yardsticks"] = {"gather_ms": gms, "gather_tb_s": moved / gms / 1e9,
                                 "copy_ms": sms, "copy_tb_s": moved / sms / 1e9}
        rec["ms"] = events_ms(new)
        rec["device_ms"] = device_ms(new, "fused_update_kernel")
        rec["share_of_bound"] = rec["bound_ms"] / rec["device_ms"][0]
        print(json.dumps(rec), flush=True)
        del jobs, leaves
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
