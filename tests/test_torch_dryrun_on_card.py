"""The dry run's counts against the card's, at smoke size.

Each test needs a CUDA device and skips without one (decided at run
time).  A smoke step (head dim 64, one group of layers) of each kind,
with a vilamb store where the kind has one, runs once on the card under
the cost counter and once traced on the meta device: every part's FLOPs,
bytes and per-kernel launches and work are equal, and each kernel's
counted launches equal its wrapper's ``LAUNCHES`` (the card ran the
kernels, not their plain versions).  The module imports no JAX, so on the
card it runs with:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_dryrun_on_card.py -k on_card
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import ProtectedStore, RedundancyPolicy
from repro_torch.data import SyntheticPipeline
from repro_torch.kernels.checksum import ops as ck_ops
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.parity import ops as par_ops
from repro_torch.kernels.redundancy import ops as fu_ops
from repro_torch.launch import dryrun
from repro_torch.models import Model
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.serve import make_decode_step, make_prefill
from repro_torch.train import (TrainState, make_redundancy_step, make_train_step,
                               protected_structs)

SHAPE = {"train": ShapeConfig("t", 128, 2, "train"),
         "prefill": ShapeConfig("p", 128, 2, "prefill"),
         "decode": ShapeConfig("d", 160, 2, "decode")}
WRAPPERS = {"checksum": ck_ops, "parity": par_ops, "fused_update": fu_ops,
            "flash_attn": fa_ops}


@pytest.fixture()
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _parts(cfg, kind, dev):
    model = Model(cfg, torch.device(dev))
    gen = torch.Generator(device=dev).manual_seed(0) if dev != "meta" else None
    params = model.init(gen)
    shape = SHAPE[kind]
    batch = SyntheticPipeline(cfg, shape, seed=0, device="cpu").get(0)
    batch = {k: (torch.empty(v.shape, dtype=v.dtype, device="meta") if dev == "meta"
                 else v.to(dev)) for k, v in batch.items()}
    policy = RedundancyPolicy.single("vilamb", precompile=False)
    if kind == "prefill":
        return dryrun.run_parts(kind, make_prefill(model, shape.seq_len), None, (params, batch))
    if kind == "train":
        opt = AdamW(lr=warmup_cosine(1e-3, 10, 100), moment_dtype=cfg.moment_dtype)
        state = TrainState.create(params, opt.init(params))
        store = ProtectedStore(policy, device=dev).attach(protected_structs(params, state.opt))
        return dryrun.run_parts(kind, make_train_step(model, opt, store), store, (state, batch),
                                make_redundancy_step(store))
    B, S = shape.global_batch, shape.seq_len
    enc = 64 if cfg.enc_dec else 0
    store = ProtectedStore(policy, device=dev).attach(model.cache_shapes(B, S, enc))
    token = torch.zeros((B,), dtype=torch.int32, device=dev)
    return dryrun.run_parts(kind, make_decode_step(model, store), store,
                            (params, model.init_caches(B, S, enc), {}, token, S // 2))


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
@pytest.mark.parametrize("arch", ("llama3.2-3b", "qwen3-moe-235b-a22b", "internvl2-1b",
                                  "seamless-m4t-medium"))
def test_counted_step_equals_the_meta_trace_on_card(cuda_device, arch, kind):
    cfg = dataclasses.replace(get_smoke(arch), head_dim=64)
    cfg = dataclasses.replace(cfg, n_layers=cfg.group_size)
    before = {n: m.LAUNCHES for n, m in WRAPPERS.items()}
    card = _parts(cfg, kind, "cuda")
    torch.cuda.synchronize()
    launched = {n: m.LAUNCHES - before[n] for n, m in WRAPPERS.items()}
    meta = _parts(cfg, kind, "meta")
    assert list(card) == list(meta)
    for part in card:
        assert card[part].key() == meta[part].key(), (part, {
            k: (card[part].by_op.get(k), meta[part].by_op.get(k))
            for k in set(card[part].by_op) | set(meta[part].by_op)
            if card[part].by_op.get(k) != meta[part].by_op.get(k)})
    counted = {n: sum(c.kernels[n].launches for c in card.values() if n in c.kernels)
               for n in WRAPPERS}
    assert counted == launched
    assert sum(launched.values()) > 0
