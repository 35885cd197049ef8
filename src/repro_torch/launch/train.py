"""Training launcher: model, data, AdamW and a ProtectedStore over the params
and both Adam moments, driven by the Trainer, with checkpoints, resumption,
the preemption handler and the corruption demo.

Examples (on the card; ``--device cpu`` runs on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --smoke \\
      --steps 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \\
      --steps 50 --redundancy vilamb --period 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --smoke \\
      --steps 8 --ckpt-dir /tmp/ckpt --ckpt-every 4 --inject-corruption 6
  (then the same with ``--resume``: ``[train] resumed from step 8``)

Per-leaf policies (params sync-protected, Adam moments amortised):
  ... --policy "params/*=sync,m/*=vilamb:16,v/*=vilamb:16" \\
      --max-vulnerable-steps 64

The weights come from a generator seeded 0 on the chosen device, the data
from the reference's synthetic zipf stream with seed 0.  SIGTERM (or
SIGUSR1) drains: a redundancy flush, a checkpoint, exit code 42.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch


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
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-corruption", type=int, default=0,
                    help="flip bits in a block at this step, then scrub and "
                         "repair it (demo)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    from ..ckpt import CheckpointManager, PreemptionHandler
    from ..common import resolve_device
    from ..configs import get_arch, get_smoke
    from ..core import ProtectedStore, RedundancyPolicy
    from ..core import blocks as B
    from ..data import SyntheticPipeline
    from ..kernels.common import i32
    from ..models import ShapeConfig, build_model
    from ..optim import AdamW, warmup_cosine
    from ..train import Trainer, protected_leaves, protected_structs, replace_protected

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
    handler = PreemptionHandler().install()
    try:
        ckpt = CheckpointManager(args.ckpt_dir, device=device) if args.ckpt_dir else None

        state = None
        if ckpt is not None and args.resume:
            # Verified restore: scrub against the saved redundancy and
            # parity-repair single-block corruption before resuming.
            state = ckpt.restore_verified(trainer.state_struct(), trainer.store)
            if state is not None:
                print(f"[train] resumed from step {state.step}")
        if state is None:
            state = trainer.init_state(torch.Generator(device=device).manual_seed(0))

        t0 = time.perf_counter()
        done = 0
        while done < args.steps:
            def on_step(st, metrics):
                nonlocal done
                done += 1
                if st.step % args.log_every == 0:
                    print(f"[train] step {st.step} loss {float(metrics['loss']):.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f}")
                if ckpt is not None and args.ckpt_every and st.step % args.ckpt_every == 0:
                    # Ordered after an update this step's tick may have put in
                    # flight (the live view's redundancy is refreshed in place).
                    ckpt.save(st.step, st, blocking=False, store=trainer.store)

            chunk = min(args.steps - done, 10)
            state = trainer.run(state, data, chunk, on_step=on_step)

            # Demonstration: SDC injection -> scrub detect -> parity repair,
            # in place on the live state.
            if args.inject_corruption and done >= args.inject_corruption and trainer.store:
                args.inject_corruption = 0
                state = trainer.flush(state)  # make everything clean and covered
                st_store = trainer.store
                leaves = protected_leaves(state.params, state.opt)
                name = sorted(st_store.protected_metas)[0]
                meta = st_store.metas[name]
                with torch.no_grad():
                    lanes = B.to_lanes(leaves[name], meta)
                    lanes[0, 0] += i32(0xDEAD)
                    if lanes.data_ptr() != leaves[name].data_ptr():   # a padded copy
                        leaves[name] = B.from_lanes(lanes, meta)
                mm = st_store.scrub(leaves, state.red)
                n_bad = sum(int(v.sum()) for v in mm.values())
                repaired, fixed, lostn = st_store.repair(leaves, state.red, mm)
                mm2 = st_store.scrub(repaired, state.red)
                n_after = sum(int(v.sum()) for v in mm2.values())
                state = replace_protected(state, repaired)
                print(f"[vilamb] injected corruption: detected={n_bad} "
                      f"repaired={fixed} unrecoverable={lostn} residual={n_after}")

            if handler.requested:
                state = handler.drain(trainer, state, ckpt)
                print(f"[train] preempted: flushed in {handler.flush_seconds:.3f}s, "
                      f"checkpointed at step {state.step}")
                sys.exit(handler.exit_code)

        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        print(f"[train] done: {args.steps} steps in {dt:.1f}s "
              f"({args.steps * shape.seq_len * shape.global_batch / dt:.0f} tok/s) on "
              f"{device} alarms={trainer.corruption_alarms}")
        if ckpt is not None:
            state = trainer.flush(state)
            ckpt.save(state.step, state, blocking=True)
        return state
    finally:
        handler.uninstall()


if __name__ == "__main__":
    main()
