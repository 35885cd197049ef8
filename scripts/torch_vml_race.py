"""Count fresh processes whose first parallel ``torch.exp`` on the CPU is off.

    PYTHONPATH=src python scripts/torch_vml_race.py [--runs 240] [--jobs 8]

Each child process computes ``exp`` of the 32 x 512 shifted logits of the
port's cross-entropy test (16,384 elements: split over the OpenMP threads)
twice, as its first and second call into the CPU's vector math, and
reports whether the two differ bit for bit.  Modes, in turns: ``none``
(the parallel call is the process's first), ``exp`` and ``log`` (one call
on a one-element tensor first), ``port`` (``import repro_torch`` first,
which makes that call).  The race shows more often on a busy host.
"""
from __future__ import annotations

import argparse
import collections
import subprocess
import sys

CHILD = r"""
import sys
mode = sys.argv[1]
import numpy as np, torch
if mode == "exp":
    torch.exp(torch.zeros(1))
elif mode == "log":
    torch.log(torch.ones(1))
elif mode == "port":
    import repro_torch  # noqa: F401
a = np.random.default_rng(1).standard_normal((32, 512)).astype(np.float32)
lf = torch.from_numpy(a) * 4
lf[:, 500:] = -1e30
x = lf - lf.amax(dim=-1, keepdim=True)
first, second = torch.exp(x), torch.exp(x)
rows = (first.view(torch.int32) != second.view(torch.int32)).any(-1).nonzero().flatten()
print("off" if len(rows) else "same", rows.tolist())
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=240)
    ap.add_argument("--jobs", type=int, default=8)
    args = ap.parse_args(argv)
    modes = ("none", "exp", "log", "port")
    counts = collections.Counter()
    for start in range(0, args.runs, args.jobs):
        procs = [(m, subprocess.Popen([sys.executable, "-c", CHILD, m],
                                      stdout=subprocess.PIPE, text=True))
                 for m in (modes[(start + i) % len(modes)]
                           for i in range(min(args.jobs, args.runs - start)))]
        for mode, p in procs:
            out = p.communicate(timeout=300)[0].split()
            counts[(mode, out[0] if out else "failed")] += 1
    for mode in modes:
        print(f"{mode}: first parallel exp off in {counts[(mode, 'off')]} of "
              f"{sum(v for (m, _), v in counts.items() if m == mode)} processes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
