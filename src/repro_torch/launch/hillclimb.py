"""Perf hill-climbing: one dry-run cell with knob overrides.

The port of ``repro.launch.hillclimb``: runs a tagged dry-run variant of
one cell (``launch.dryrun``, traced on the meta device) with config or
knob overrides and prints its three roofline terms against the untagged
cell's, so that each hypothesis -> change -> measure -> validate
iteration is one command:

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch glm4-9b \\
      --shape train_4k --variant accum=1 --variant remat=none --tag noaccum

The knobs are the fields the port's ``ModelConfig`` has, plus ``accum``.
The reference's mesh-only knobs (``seq_parallel``, ``attn_kv_gather_first``,
``opt_grad_barrier``, ``unroll_layers``) are refused: they wait for Queue 1
item 11.7.
"""
import argparse
import dataclasses
import json
import pathlib

from ..configs import get_arch
from .dryrun import RESULTS, run_cell

PERF_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "perf"

KNOB_TYPES = {
    "accum": int, "capacity_factor": float, "remat": str, "attn_tile": int,
    "moe_every": int, "expand": int, "param_dtype": str, "moment_dtype": str,
    "top_k": int, "norm_vjp": str,
    "bf16_grad_boundaries": lambda s: s == "true",
}
MESH_ONLY_KNOBS = ("seq_parallel", "attn_kv_gather_first", "opt_grad_barrier",
                   "unroll_layers")


def parse_variant(kvs):
    cfg_kw, accum = {}, None
    for kv in kvs:
        k, _, v = kv.partition("=")
        if k in MESH_ONLY_KNOBS:
            raise NotImplementedError(
                f"knob {k!r} acts on a mesh of several devices; the port runs "
                "on one card: Queue 1 item 11.7 (torch.distributed across cards)")
        if k not in KNOB_TYPES:
            raise ValueError(f"unknown knob {k!r}; the port's knobs: {sorted(KNOB_TYPES)}")
        if k == "accum":
            accum = int(v)
        else:
            cfg_kw[k] = KNOB_TYPES[k](v)
    return cfg_kw, accum


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--mode", default="vilamb")
    ap.add_argument("--variant", action="append", default=[],
                    help="knob=value (repeatable); e.g. accum=1 remat=none")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--out", default=str(PERF_DIR))
    ap.add_argument("--base", default=str(RESULTS),
                    help="directory of the untagged cells (the dry run's)")
    args = ap.parse_args(argv)

    try:
        cfg_kw, accum = parse_variant(args.variant)
    except (NotImplementedError, ValueError) as e:
        ap.error(str(e))
    cfg = get_arch(args.arch)
    if cfg_kw:
        cfg = dataclasses.replace(cfg, **cfg_kw)

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rec = run_cell(args.arch, args.shape, args.mesh == "multi", mode=args.mode,
                   out_dir=out, tag=args.tag, cfg_override=cfg, accum=accum)

    base_file = pathlib.Path(args.base) / f"{args.arch}__{args.shape}__{args.mesh}.json"
    base = json.loads(base_file.read_text()) if base_file.exists() else None
    rl = rec["roofline"]
    print(f"\n=== {args.arch} {args.shape} {args.mesh} [{args.tag}] "
          f"variant={args.variant} ===")
    print(f"compute {rl['compute_s']:.3f}s  memory {rl['memory_s']:.3f}s  "
          f"collective {rl['collective_s']:.3f}s  bottleneck={rl['bottleneck']}  "
          f"frac={rl['roofline_fraction']:.4f}  fits={rec.get('fits_hbm')}")
    if base and base["status"] == "ok":
        b = base["roofline"]
        for term in ("compute_s", "memory_s", "collective_s"):
            delta = (rl[term] - b[term]) / max(b[term], 1e-12) * 100
            print(f"  {term:13s} {b[term]:8.3f} -> {rl[term]:8.3f}  ({delta:+.1f}%)")
        print(f"  frac          {b['roofline_fraction']:.4f} -> "
              f"{rl['roofline_fraction']:.4f}")
    return rec


if __name__ == "__main__":
    main()
