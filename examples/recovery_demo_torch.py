"""Fault-tolerance walkthrough: train -> SDC injection -> scrub detection ->
parity reconstruction -> training continues; then a vulnerable-stripe case
falls back to a checkpoint restore.  The PyTorch port of
``examples/recovery_demo.py``.

    PYTHONPATH=src python examples/recovery_demo_torch.py [--device cpu]

Its counts (blocks detected, fixed, lost; the restored step) equal the JAX
run's.  The port corrupts and repairs the live leaves in place, where the
reference builds new arrays; the checkpoints go to a temporary directory
that is removed at the end.
"""
import argparse
import shutil
import sys
import tempfile

sys.path.insert(0, "src")

import torch

from repro_torch.common import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.core import ProtectedStore, RedundancyPolicy
from repro_torch.core import blocks as B
from repro_torch.data import SyntheticPipeline
from repro_torch.models import Model, ShapeConfig, build_model
from repro_torch.optim import AdamW
from repro_torch.train import Trainer, protected_leaves, protected_structs, replace_protected


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device, "the example")

    cfg = get_smoke("llama3.2-3b")
    model = build_model(cfg, dev)
    opt = AdamW(lr=lambda s: 1e-3)
    meta = Model(cfg, torch.device("meta")).init()
    store = ProtectedStore(RedundancyPolicy.single("vilamb", period_steps=4),
                           device=dev).attach(protected_structs(meta, opt.init(meta)))
    trainer = Trainer(model=model, opt=opt, store=store)
    data = SyntheticPipeline(cfg, ShapeConfig("d", 64, 4, "train"), seed=0, device=dev)
    ckpt_dir = tempfile.mkdtemp(prefix="vilamb_recovery_ckpt_")
    try:
        ckpt = CheckpointManager(ckpt_dir, keep=2, device=dev)

        state = trainer.init_state(torch.Generator(device=dev).manual_seed(0))
        state = trainer.run(state, data, 4)
        state = trainer.flush(state)
        ckpt.save(state.step, state, blocking=True)
        print("trained 4 steps, flushed, checkpointed.")

        # --- Scenario 1: clean-stripe corruption -> parity repair ----------
        leaves = protected_leaves(state.params, state.opt)
        name = "params/embed"
        meta_e = store.metas[name]
        bad_block = meta_e.n_blocks // 2
        with torch.no_grad():
            B.to_lanes(leaves[name], meta_e)[bad_block, 3] += 0xBEEF
        print("\n[1] injected a bit flip into", name, "block", bad_block)
        mm = store.scrub(leaves, state.red)
        print("    scrub detected:", sum(int(v.sum()) for v in mm.values()), "block(s)")
        repaired, fixed, lost = store.repair(leaves, state.red, mm)
        print(f"    parity repair: fixed={fixed} unrecoverable={lost}")
        state = replace_protected(state, repaired)
        losses = []
        state = trainer.run(state, data, 2, on_step=lambda s, m: losses.append(m["loss"]))
        print("    training continued; loss finite:",
              bool(torch.isfinite(torch.stack(losses)).all()))

        # --- Scenario 2: corruption inside the vulnerability window --------
        # One fresh (unflushed) step leaves every written block dirty: a
        # corruption there is silent — the paper's tunable window of
        # vulnerability (§3.3).  The checkpoint layer is the safety net.
        state2 = trainer.run(state, data, 1)   # fresh dirt, no redundancy pass yet
        leaves = protected_leaves(state2.params, state2.opt)
        with torch.no_grad():
            B.to_lanes(leaves[name], store.metas[name])[0, 0] += 1
        mm = store.scrub(leaves, state2.red)
        n_det = sum(int(v.sum()) for v in mm.values())
        print(f"\n[2] corruption on a DIRTY page: scrub detected={n_det} "
              "(silent — inside the paper's vulnerability window)")
        restored = ckpt.restore_verified(trainer.state_struct(), store)
        print("    safety net: checkpoint restore at step", restored.step,
              "- the deterministic pipeline replays the exact stream from there.")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
