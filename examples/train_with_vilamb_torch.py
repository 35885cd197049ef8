"""End-to-end training example: an LM trained with asynchronous redundancy,
periodic scrubbing, checkpointing and the preemption flush.  The PyTorch
port of ``examples/train_with_vilamb.py``.

Quick demo:
    PYTHONPATH=src python examples/train_with_vilamb_torch.py [--device cpu]

Full ~100M-param run (a few hundred steps):
    PYTHONPATH=src python examples/train_with_vilamb_torch.py --full --steps 300

The parameter count and the measured MTTDL uplift (from the dirty
statistics of the reference's data stream) are counts the JAX run prints
too; the losses come from the port's own random weights.  Checkpoints go
to a temporary directory (removed after a run that was not preempted)
unless ``--ckpt`` names one.
"""
import argparse
import shutil
import sys
import tempfile
import time

sys.path.insert(0, "src")

import torch

from repro_torch.common import resolve_device
from repro_torch.ckpt import CheckpointManager, PreemptionHandler
from repro_torch.configs import get_smoke
from repro_torch.core import ProtectedStore, RedundancyPolicy, mttdl
from repro_torch.data import SyntheticPipeline
from repro_torch.models import Model, ModelConfig, ShapeConfig, build_model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import Trainer, protected_structs


def model_100m() -> ModelConfig:
    return ModelConfig(
        name="demo-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=32768,
        norm="rmsnorm", activation="swiglu", param_dtype="float32")


def param_count(cfg: ModelConfig) -> int:
    """The reference's analytic count (``ModelConfig.param_count``) for a
    dense decoder: embeddings, attention, FFN and norms."""
    d, hd = cfg.d_model, cfg.hd
    emb = cfg.vocab_size * d
    per_layer = (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                 + (3 if cfg.activation == "swiglu" else 2) * d * cfg.d_ff
                 + (2 * d if cfg.norm != "nonparam_ln" else 0))
    return (emb if cfg.tie_embeddings else 2 * emb) + cfg.n_layers * per_layer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="~100M params")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--period", type=int, default=8)
    ap.add_argument("--ckpt", default="", help="checkpoint directory (default: a "
                                               "temporary one, removed at the end)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "the example")

    cfg = model_100m() if args.full else get_smoke("olmo-1b")
    print(f"model: {cfg.name} ({param_count(cfg)/1e6:.1f}M params)")
    model = build_model(cfg, dev)
    opt = AdamW(lr=warmup_cosine(3e-4, 20, args.steps))
    meta = Model(cfg, torch.device("meta")).init()
    store = ProtectedStore(RedundancyPolicy.single(
        "vilamb", period_steps=args.period, scrub_period_steps=4 * args.period),
        device=dev).attach(protected_structs(meta, opt.init(meta)))
    trainer = Trainer(model=model, opt=opt, store=store)
    handler = PreemptionHandler().install()
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="vilamb_demo_ckpt_")
    ckpt = CheckpointManager(ckpt_dir, keep=2, device=dev)

    shape = ShapeConfig("demo", 256 if args.full else 64, 8, "train")
    data = SyntheticPipeline(cfg, shape, seed=0, device=dev)

    state = trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    t0 = time.time()
    trace = []

    def on_step(st, m):
        s = st.step
        trace.append({n: {k: int(v) for k, v in d.items()}
                      for n, d in store.dirty_stats(st.red).items()})
        if s % 10 == 0:
            tput = s * shape.seq_len * shape.global_batch / (time.time() - t0)
            print(f"step {s:4d} loss {float(m['loss']):.4f} {tput:,.0f} tok/s")
        if s % 50 == 0:
            ckpt.save(s, st, blocking=False, store=store)
        if handler.requested:
            handler.drain(trainer, st, ckpt)
            print(f"preempted: checkpointed at step {s} in {ckpt_dir}")
            sys.exit(42)

    try:
        state = trainer.run(state, data, args.steps, on_step=on_step)
        state = trainer.flush(state)
        ckpt.save(state.step, state, blocking=True)
    finally:
        handler.uninstall()
    if not args.ckpt:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    avg = mttdl.average_stats(trace)
    up = mttdl.aggregate_uplift(avg, store.policy.stripe_data_blocks + 1)
    print(f"done. scrub alarms: {trainer.corruption_alarms}; "
          f"measured MTTDL uplift over No-Redundancy: {up:.1f}x")


if __name__ == "__main__":
    main()
