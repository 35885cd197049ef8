"""Dry run: trace every (arch x shape x mesh) cell on the meta device.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell's step with no TPU, which proves the distribution config
coherent at full size; here the cell's step runs once on PyTorch's
``meta`` device, at the cell's global shapes, under the cost counter
(``launch.cost_analysis``): every op checks its shapes and dtypes, every
hand kernel's wrapper runs the card's argument checks (head dims, dtypes,
grid, shard and stripe limits), and nothing is computed or allocated.  It
runs on any machine, with no card (and on one, it touches no device
memory).  Each cell's record: its status (or the reference's skip
string), the trace's seconds (the reference's ``compile_s``), the
fallback log, the counted FLOPs, bytes and kernel launches of each part
(the store's init, the step, the redundancy step's full pass), per-chip
terms as an even split over the mesh's chips, the collectives (none on
one card), the itemised HBM model (``launch.memory_model``) and the
roofline.  The reference extrapolates its costs from 1- and 2-group
compiles because XLA's cost analysis counts a ``scan`` body once; an eager
trace counts every layer, so the record says ``"unrolled_exact": true``.
Records go to ``build/dryrun/`` as JSON.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import sys
import time
import traceback
from typing import Callable, Dict, Optional

import torch

from ..common import flatten_dict
from ..configs import get_arch, list_archs
from ..core.engine import RedundancyConfig, RedundancyEngine
from ..dist.sharding import param_specs
from ..models.config import SHAPES
from ..models.model import Model
from ..optim import AdamW, warmup_cosine
from ..train.state import protected_leaves, protected_structs
from ..train.train_loop import deterministic
from . import cost_analysis as C
from .memory_model import analytic_hbm
from .mesh import make_production_mesh
from .specs import (META, build_decode_setup, build_prefill_setup, build_train_setup,
                    default_accum, make_ctx, meta_red)

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"


def cell_applicability(cfg, shape) -> str:
    """'' if runnable, else the documented skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "SKIP(full-attention arch; 500k decode requires sub-quadratic mixer)"
    return ""


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS per assignment: 6*N*D train (N_active for MoE), 2*N*D fwd."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def run_parts(kind: str, step_fn: Callable, store, args: tuple,
              redundancy_fn: Optional[Callable] = None) -> Dict[str, C.Costs]:
    """One cell's parts, each counted alone, on whatever device ``args``
    lie (the meta device for the dry run, the card for ``chip_smoke.py``'s
    check that a trace counts what the card runs):

    - ``train``, ``args = (state, batch)``: with a store, its ``init`` over
      the protected leaves (K1, K2); the train step (its ``on_write``
      included); the redundancy step, a full pass (K3);
    - ``decode``, ``args = (params, caches, red, token, pos)``: with a
      store, its ``init`` over the caches; the decode step; the store's
      redundancy step over the caches;
    - ``prefill``, ``args = (params, batch)``: the prefill (flash).

    Training runs under the train loop's deterministic mode, serving under
    inference mode, as on the card."""
    parts: Dict[str, C.Costs] = {}
    mode = deterministic() if kind == "train" else torch.inference_mode()
    with mode:
        if kind == "prefill":
            with C.count_costs() as parts["step"]:
                step_fn(*args)
            return parts
        if kind == "train":
            state, batch = args
            leaves = protected_leaves(state.params, state.opt)
            if store is not None:
                with C.count_costs() as parts["init"]:
                    state = dataclasses.replace(state, red=store.init(leaves))
            with C.count_costs() as parts["step"]:
                state, _ = step_fn(state, batch)
            if store is not None:
                with C.count_costs() as parts["redundancy"]:
                    redundancy_fn(state)
            return parts
        params, caches, red, token, pos = args
        if store is not None:
            with C.count_costs() as parts["init"]:
                red = store.init(flatten_dict(caches))
        with C.count_costs() as parts["step"]:
            _, caches, red, _ = step_fn(params, caches, red, token, pos)
        if store is not None:
            with C.count_costs() as parts["redundancy"]:
                store.redundancy_step(flatten_dict(caches), red)
    return parts


def setup_args(setup, kind: str) -> tuple:
    if kind == "train":
        return setup.state_struct, setup.batch_struct
    return setup.args_struct


def build_setup(cfg, shape, mesh, mode: str, accum: int, max_len=None, pos=None):
    if shape.kind == "train":
        return build_train_setup(cfg, shape, mesh, mode=mode, accum_steps=accum)
    if shape.kind == "prefill":
        return build_prefill_setup(cfg, shape, mesh, max_len=max_len)
    return build_decode_setup(cfg, shape, mesh, mode=mode, pos=pos)


def trace_cell(cfg, shape, mesh, mode: str = "vilamb", accum: Optional[int] = None,
               max_len: Optional[int] = None, pos: Optional[int] = None):
    """Build a cell's setup and trace its parts on the meta device;
    returns ``(setup, parts, seconds)``."""
    if accum is None:
        accum = default_accum(cfg, shape, mesh)
    t0 = time.perf_counter()
    setup = build_setup(cfg, shape, mesh, mode, accum, max_len, pos)
    parts = run_parts(shape.kind, setup.step_fn, getattr(setup, "store", None),
                      setup_args(setup, shape.kind), getattr(setup, "redundancy_fn", None))
    return setup, parts, time.perf_counter() - t0


def run_cell(arch: str, shape_name: str, multi_pod: bool, mode: str = "vilamb",
             out_dir: pathlib.Path = RESULTS, tag: str = "",
             cfg_override=None, accum: "int|None" = None) -> dict:
    """One dry-run cell: the setup built and its parts traced once on the
    meta device at the cell's global shapes (every layer counted: no
    extrapolation), then its record written to ``out_dir``."""
    cfg = cfg_override or get_arch(arch)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "mode": mode, "tag": tag, "status": "ok"}
    skip = cell_applicability(cfg, shape)
    if skip:
        rec["status"] = skip
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod, device=META)
    chips = mesh.size
    if accum is None:
        accum = default_accum(cfg, shape, mesh)
    rec["accum_steps"] = accum
    setup, parts, secs = trace_cell(cfg, shape, mesh, mode, accum)
    rec["trace_s"] = round(secs, 2)
    rec["fallbacks"] = setup.fallback_log
    rec["costs"] = {name: c.as_dict() for name, c in parts.items()}
    step = parts["step"]
    rec["per_chip"] = {"split": f"even over the mesh's {chips} chips",
                       "flops": step.total_flops / chips,
                       "bytes": step.total_bytes / chips}
    rec["collectives"] = step.as_dict()["collectives"]
    rec["unrolled_exact"] = True
    rec["hbm_model"] = analytic_hbm(cfg, shape, mesh, setup, mode, accum)
    rl = C.roofline_terms(flops_per_chip=step.total_flops / chips,
                          bytes_per_chip=step.total_bytes / chips,
                          coll_bytes_per_chip=step.collectives.total_bytes / chips,
                          chips=chips, model_flops=model_flops(cfg, shape))
    rec["roofline"] = rl.as_dict()
    rec["hbm_bytes_per_device"] = int(rec["hbm_model"]["total"])
    rec["fits_hbm"] = bool(rec["hbm_model"]["fits_hbm_analytic"])

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{arch}__{shape_name}__{mesh_name}{('__' + tag) if tag else ''}.json"
    (out_dir / name).write_text(json.dumps(rec, indent=2, default=str))
    return rec


def run_redundancy_cell(arch: str, multi_pod: Optional[bool] = False,
                        stripe: int = 4, lanes: int = 16384, dirty_frac: float = 1.0,
                        out_dir: pathlib.Path = RESULTS, tag: str = "red",
                        cfg_override=None) -> dict:
    """Algorithm 1 itself over an arch's protected params and moments,
    traced on the meta device: the paper's technique as its own roofline
    cell, memory-bound by construction, with no collective (machine-local,
    §3.3).  The trace is the full pass (every stripe: K3's worst case, the
    flush); ``dirty_frac`` scales the analytic amortised traffic.
    ``multi_pod=None`` takes one card (no mesh)."""
    cfg = cfg_override or get_arch(arch)
    mesh = None if multi_pod is None else make_production_mesh(multi_pod=multi_pod,
                                                                device=META)
    chips = 1 if mesh is None else mesh.size
    ctx = make_ctx(cfg, mesh)
    params = Model(cfg, META).init()
    opt = AdamW(lr=warmup_cosine(3e-4, 100, 10000), moment_dtype=cfg.moment_dtype)
    opt_state = opt.init(params)
    p_specs, _ = param_specs(flatten_dict(params), ctx)
    prot = protected_structs(params, opt_state)
    specs = {k: p_specs[k.partition("/")[2]] for k in prot} if mesh is not None else None
    rcfg = RedundancyConfig(mode="vilamb", stripe_data_blocks=stripe, lanes_per_block=lanes)
    t0 = time.perf_counter()
    engine = RedundancyEngine(prot, rcfg, device=META, mesh=mesh, specs=specs)
    red = meta_red(engine.red_structs())
    with C.count_costs() as costs:
        engine.redundancy_step(protected_leaves(params, opt_state), red)
    rec = {"arch": arch, "cell": "redundancy_step", "tag": tag,
           "mesh": "none" if mesh is None else ("multi" if multi_pod else "single"),
           "stripe": stripe, "lanes_per_block": lanes,
           "trace_s": round(time.perf_counter() - t0, 2), "status": "ok",
           "costs": costs.as_dict()}
    bytes_chip = costs.total_bytes / chips
    ops_chip = sum(k.ops for k in costs.kernels.values()) / chips
    rl = C.roofline_terms(costs.total_flops / chips, bytes_chip,
                          costs.collectives.total_bytes / chips, chips, model_flops=0.0)
    rec["roofline"] = rl.as_dict()
    rec["bound_ms"], rec["bound_by"] = C.bound(bytes_chip, ops_chip)
    rec["collectives"] = costs.as_dict()["collectives"]
    state_bytes = sum(math.prod(v.shape) * v.dtype.itemsize for v in prot.values()) / chips
    rec["state_bytes_per_chip"] = int(state_bytes)
    # useful traffic = read dirty stripes once + write parity/checksums
    useful = state_bytes * dirty_frac * (1 + 1.0 / stripe)
    rec["useful_bytes_per_chip"] = int(useful)
    rec["memory_efficiency"] = useful / max(bytes_chip, 1.0)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{arch}__redundancy__{tag}.json").write_text(
        json.dumps(rec, indent=2, default=str))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--mode", default="vilamb", choices=["none", "sync", "vilamb"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args()

    archs = list_archs() if (args.all or args.arch == "all") else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape == "all") else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    out_dir = pathlib.Path(args.out)

    failures = 0
    t_all = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "multi" if mp else "single"
                fname = out_dir / f"{arch}__{shape}__{mesh_name}{('__' + args.tag) if args.tag else ''}.json"
                if args.skip_existing and fname.exists():
                    print(f"[skip] {arch} {shape} {mesh_name} (cached)")
                    continue
                label = f"{arch:26s} {shape:12s} {mesh_name:6s}"
                try:
                    rec = run_cell(arch, shape, mp, mode=args.mode,
                                   out_dir=out_dir, tag=args.tag)
                    if rec["status"] != "ok":
                        print(f"[----] {label} {rec['status']}")
                        out_dir.mkdir(parents=True, exist_ok=True)
                        fname.write_text(json.dumps(rec, indent=2))
                        continue
                    rl = rec["roofline"]
                    print(f"[ ok ] {label} trace={rec['trace_s']}s "
                          f"accum={rec['accum_steps']} "
                          f"bottleneck={rl['bottleneck']} "
                          f"frac={rl['roofline_fraction']:.3f} "
                          f"fitsHBM={rec.get('fits_hbm', '?')}", flush=True)
                except Exception as e:  # a cell's failure is reported, the sweep goes on
                    failures += 1
                    print(f"[FAIL] {label} {type(e).__name__}: {e}")
                    traceback.print_exc()
    print(f"dryrun: {time.perf_counter() - t_all:.1f} s, {failures} failed", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
