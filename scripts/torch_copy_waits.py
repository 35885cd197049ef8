"""Which host-side calls on the current stream wait for another stream's work?

    python scripts/torch_copy_waits.py [--sleep-cycles 1000000000]

On one CUDA device: for each call below, queue a spin of ``--sleep-cycles``
SM clocks on a side stream (as the store's in-flight update runs there),
make the call on the current stream, and report the host milliseconds it
took and whether the side stream was still busy when it returned.  A call
that waits for the side stream takes about the spin's length and reports
``side_busy_after: false``.  The calls: a device-to-host copy of a small
tensor, a host-to-device copy from pageable memory (what
``torch.tensor(data, device="cuda")`` and ``.to("cuda")`` of a CPU tensor
do), the same from pinned memory with ``non_blocking=True``, a 4 MiB
device allocation, a clone of an 8 GiB tensor (a fresh 8 GiB allocation:
the allocator's cache is emptied before each call), and 80 rows of that
tensor gathered by ids copied from the host.  Prints the card's name and
power limit, then one JSON line a call.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def calls(dev):
    small = torch.zeros(1024, dtype=torch.int32, device=dev)
    host = np.arange(4096, dtype=np.int64)
    pinned = torch.from_numpy(host).pin_memory()
    big = torch.zeros((2_097_152, 1024), dtype=torch.float32, device=dev)
    rows = list(range(0, 2_097_152, 26_000))
    return {
        "clone_8gib": lambda: big.clone(),
        "gather_rows": lambda: big[torch.tensor(rows, device=dev)].clone(),
        "device_to_host": lambda: small.cpu(),
        "host_to_device_pageable": lambda: torch.from_numpy(host).to(dev),
        "torch_tensor_list": lambda: torch.tensor(host.tolist(), device=dev),
        "host_to_device_pinned_non_blocking": lambda: pinned.to(dev, non_blocking=True),
        "device_alloc": lambda: torch.empty(1 << 20, device=dev),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sleep-cycles", type=int, default=1_000_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    side = torch.cuda.Stream(dev)
    for name, fn in calls(dev).items():
        fn()                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        done = torch.cuda.Event()
        with torch.cuda.stream(side):
            torch.cuda._sleep(args.sleep_cycles)
            done.record(side)
        t = time.perf_counter()
        fn()
        ms = (time.perf_counter() - t) * 1e3
        busy = not done.query()
        torch.cuda.synchronize()
        print(json.dumps({"call": name, "host_ms": ms, "side_busy_after": busy}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
