"""Training launcher: model, data, AdamW and a ProtectedStore over the params
and both Adam moments, driven by the Trainer.

Examples (on the card; ``--device cpu`` runs on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --smoke \\
      --steps 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \\
      --steps 50 --redundancy vilamb --period 8

Per-leaf policies (params sync-protected, Adam moments amortised):
  ... --policy "params/*=sync,m/*=vilamb:16,v/*=vilamb:16" \\
      --max-vulnerable-steps 64

The weights come from a generator seeded 0 on the chosen device, the data
from the reference's synthetic zipf stream with seed 0.  Checkpoints and
resumption (``--ckpt-dir``, ``--ckpt-every``, ``--resume``) and the
corruption demo (``--inject-corruption``) are not ported yet and are
refused by name.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

NOT_PORTED = {
    "ckpt_dir": "ckpt/ and the preemption handler: ROADMAP.md, Queue 1 item 9",
    "ckpt_every": "ckpt/ and the preemption handler: ROADMAP.md, Queue 1 item 9",
    "resume": "ckpt/ and the preemption handler: ROADMAP.md, Queue 1 item 9",
    "inject_corruption": "store.repair (core/repairs.py): ROADMAP.md, Queue 1 item 6",
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--redundancy", default="vilamb", choices=["none", "sync", "vilamb"])
    ap.add_argument("--period", type=int, default=8)
    ap.add_argument("--scrub-period", type=int, default=32)
    ap.add_argument("--policy", default="",
                    help='per-leaf rules "pattern=mode[:period],..." '
                         "(fnmatch over params/... m/... v/... paths)")
    ap.add_argument("--max-vulnerable-steps", type=int, default=0,
                    help="freshness deadline: force an update after this "
                         "many steps regardless of period/back-off")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="", help="not ported (refused)")
    ap.add_argument("--ckpt-every", type=int, default=0, help="not ported (refused)")
    ap.add_argument("--resume", action="store_true", help="not ported (refused)")
    ap.add_argument("--inject-corruption", type=int, default=0,
                    help="not ported (refused)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    for flag, owner in NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet: it needs {owner}")
    from ..common import resolve_device
    from ..configs import get_arch, get_smoke
    from ..core import ProtectedStore, RedundancyPolicy
    from ..data import SyntheticPipeline
    from ..models import ShapeConfig, build_model
    from ..optim import AdamW, warmup_cosine
    from ..train import Trainer, protected_structs

    device = resolve_device(args.device, "repro_torch.launch.train")
    if device.type == "cuda":
        # Deterministic cuBLAS for the train step's determinism mode: read
        # when cuBLAS first runs, so set before any product.
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    model = build_model(cfg, device)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    data = SyntheticPipeline(cfg, shape, seed=0, device=device)
    opt = AdamW(lr=warmup_cosine(args.lr, 10, args.steps), moment_dtype=cfg.moment_dtype)

    store = None
    if args.redundancy != "none" or args.policy:
        params0 = dataclasses.replace(model, device=torch.device("meta")).init()
        policy = RedundancyPolicy.from_spec(
            args.policy, default_mode=args.redundancy, period_steps=args.period,
            scrub_period_steps=args.scrub_period,
            max_vulnerable_steps=args.max_vulnerable_steps)
        store = ProtectedStore(policy, device=device).attach(
            protected_structs(params0, opt.init(params0)))

    trainer = Trainer(model=model, opt=opt, store=store,
                      scrub_period_steps=args.scrub_period)
    state = trainer.init_state(torch.Generator(device=device).manual_seed(0))

    def on_step(st, metrics):
        if st.step % args.log_every == 0:
            print(f"[train] step {st.step} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")

    t0 = time.perf_counter()
    state = trainer.run(state, data, args.steps, on_step=on_step)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"[train] done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps * shape.seq_len * shape.global_batch / dt:.0f} tok/s) on "
          f"{device} alarms={trainer.corruption_alarms}")
    return state


if __name__ == "__main__":
    main()
