"""How far fp32 training of the xLSTM smoke can agree between two packages.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_recurrent_grad_precision.py

A CPU diagnostic behind the tolerances of
``tests/test_torch_recurrent_train.py`` (a few minutes; not a test).  It
prints, for the xLSTM smoke (fp32, one sequence of 512 tokens):

1. each package's fp32 gradient against a float64 gradient (the port's
   modules copied to a temporary directory with every fp32 cast made
   float64), as the largest error over each leaf's max |g|: both packages
   sit about equally far from it;
2. how far a 1e-6 relative change of the initial params moves the loss
   after each of four steps of the port's ``Trainer``, at lr 3e-3 and 1e-3;
3. along four reference steps from the port's init (seed 0, lr 1e-3), the
   smallest distance of any mLSTM normaliser input ``|n q|`` from the kink
   of ``max(|n q|, 1)``, beside the largest gradient difference between
   the packages at the same state: where an input lies within rounding of
   1, rounding picks the branch, and the gradients part by far more than
   rounding.
"""
import dataclasses
import pathlib
import re
import shutil
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_recurrent_train as T  # noqa: E402
from repro.common import flatten_dict as jflatten  # noqa: E402
from repro.data import SyntheticPipeline as JPipeline  # noqa: E402
from repro.models.config import ShapeConfig as JShape  # noqa: E402
from repro.optim import AdamW as JAdamW, warmup_cosine as jwarmup_cosine  # noqa: E402
from repro_torch.common import flatten_dict, tree_map  # noqa: E402
from repro_torch.data import SyntheticPipeline  # noqa: E402
from repro_torch.models import ShapeConfig, params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402
from repro_torch.train import Trainer, TrainState  # noqa: E402
from repro_torch.train.train_loop import loss_and_grads  # noqa: E402

S = T.STACKS[T.XLSTM]["S"]


def worst(got: dict, want: dict):
    """The largest |got - want| over each leaf's max |want|, and its leaf."""
    out = []
    for n, w in want.items():
        w = np.asarray(w, np.float64)
        scale = np.abs(w).max()
        if scale > 0:
            out.append((float(np.abs(np.asarray(got[n], np.float64) - w).max() / scale), n))
    return max(out)


def port_steps(tm, params, steps: int, lr: float, perturb: float = 0.0) -> list:
    """The losses of ``steps`` of the port's ``Trainer.run`` (no store) from
    a copy of ``params``, each first scaled by ``1 + perturb * N(0, 1)``."""
    opt = AdamW(lr=warmup_cosine(lr, 5, 100))
    params = tree_map(torch.clone, params)
    with torch.no_grad():
        g = torch.Generator().manual_seed(5)
        for p in flatten_dict(params).values():
            p.mul_(1 + perturb * torch.randn(p.shape, generator=g))
    data = SyntheticPipeline(tm.cfg, ShapeConfig("t", S, 1, "train"), seed=0, device="cpu")
    losses = []
    Trainer(model=tm, opt=opt).run(TrainState.create(params, opt.init(params), {}), data,
                                   steps, on_step=lambda s, m: losses.append(float(m["loss"])))
    return losses


def float64_grads(weights, batch) -> dict:
    """The port's gradients with every fp32 cast of its model, train and
    optimizer modules made float64, from a copy in a temporary directory."""
    root = pathlib.Path(tempfile.mkdtemp())
    src = pathlib.Path(txlstm.__file__).resolve().parents[1]
    shutil.copytree(src, root / "repro_torch")
    for sub in ("models", "train", "optim"):
        for f in (root / "repro_torch" / sub).glob("*.py"):
            t = f.read_text()
            f.write_text(re.sub(r"\.float\(\)", ".double()", t).replace(
                "torch.float32", "torch.float64"))
    saved = {m: sys.modules.pop(m) for m in list(sys.modules) if m.startswith("repro_torch")}
    sys.path.insert(0, str(root))
    try:
        from repro_torch.configs import get_smoke
        from repro_torch.models import build_model, params_from_numpy as p64
        from repro_torch.train.train_loop import loss_and_grads as lg64
        cfg = dataclasses.replace(get_smoke(T.XLSTM), param_dtype="float64")
        params = p64(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), weights),
                     cfg, "cpu")
        _, _, grads = lg64(build_model(cfg, "cpu"), params, batch)
        return {n: g.numpy() for n, g in grads.items()}
    finally:
        sys.path.remove(str(root))
        for m in [m for m in sys.modules if m.startswith("repro_torch")]:
            del sys.modules[m]
        sys.modules.update(saved)
        shutil.rmtree(root)


def main():
    jm, jp, jgrad, tm, tp = T._stack_pair(T.XLSTM)
    jd = JPipeline(jm.cfg, JShape("t", S, 1, "train"), seed=0)
    batch = jd.get(0)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    _, jg = jgrad(jp, batch)
    _, _, tg = loss_and_grads(tm, tp, tb)
    g64 = float64_grads(jax.tree_util.tree_map(np.asarray, jp), tb)
    print("1. fp32 gradients against float64, at the reference's init (PRNGKey 0):")
    print("   reference", worst(jflatten(jg), g64))
    print("   port     ", worst({n: g.numpy() for n, g in tg.items()}, g64))

    print("2. the loss after each of four port steps, moved by a 1e-6 relative "
          "change of the initial params:")
    for lr in (3e-3, 1e-3):
        base = port_steps(tm, tp, 4, lr)
        nudged = port_steps(tm, tp, 4, lr, perturb=1e-6)
        print(f"   lr {lr:g}:", [f"{abs(a - b) / a:.1e}" for a, b in zip(base, nudged)])

    print("3. four reference steps from the port's init (seed 0), lr 1e-3:")
    weights = params_to_numpy(tm.init(torch.Generator().manual_seed(0)))
    params = jax.tree_util.tree_map(jnp.array, weights)
    jopt = JAdamW(lr=jwarmup_cosine(1e-3, 5, 100))
    update = jax.jit(jopt.update)
    opt = jopt.init(params)
    margins = []
    real = txlstm._normaliser

    def spy(nq):
        margins.append(float((nq.detach().abs() - 1).abs().min()))
        return real(nq)
    txlstm._normaliser = spy
    try:
        for step in range(4):
            batch = jd.get(step)
            (_, aux), grads = jgrad(params, batch)
            state = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tm.cfg, "cpu")
            margins.clear()
            _, _, tg = loss_and_grads(tm, state, {k: torch.from_numpy(np.array(v))
                                                  for k, v in batch.items()})
            err = worst({n: g.numpy() for n, g in tg.items()}, jflatten(grads))
            print(f"   step {step + 1}: the normaliser's closest input to the kink "
                  f"{min(margins):.1e} away; gradients apart by {err[0]:.1e} of {err[1]}'s max")
            masks = {k: v for k, v in jm.dirty_events_train(batch, aux).items()
                     if not isinstance(v, str)}
            params, opt, _ = update(grads, opt, params, masks)
    finally:
        txlstm._normaliser = real


if __name__ == "__main__":
    main()
