"""The port's end-to-end story on the qwen3-moe smoke model, on the CPU:
the twin of the JAX package's ``tests/test_system.py::test_full_lifecycle``
on the port's own API.

Train with periodic redundancy -> expert slabs dirty only where tokens were
routed -> inject a silent corruption -> scrub detects it -> parity repair ->
preemption drain (flush + checkpoint) -> a verified restore -> the restored
run continues bit for bit like the live one.
"""
import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager, PreemptionHandler
from repro_torch.common import flatten_dict
from repro_torch.configs import get_smoke
from repro_torch.core import ProtectedStore, RedundancyPolicy, bits, blocks as B
from repro_torch.data import SyntheticPipeline
from repro_torch.models import Model, ShapeConfig, build_model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import Trainer, protected_leaves, protected_structs, replace_protected

LEAF = "params/stack/slot_0/moe/wi"


def _trainer(cfg, async_tick: bool) -> Trainer:
    opt = AdamW(lr=warmup_cosine(1e-3, 5, 100))
    mp = Model(cfg, torch.device("meta")).init()
    store = ProtectedStore(RedundancyPolicy.single(
        "vilamb", period_steps=3, lanes_per_block=128, async_tick=async_tick),
        device="cpu").attach(protected_structs(mp, opt.init(mp)))
    return Trainer(model=build_model(cfg, "cpu"), opt=opt, store=store,
                   scrub_period_steps=4)


def test_full_lifecycle(tmp_path):
    cfg = get_smoke("qwen3-moe-235b-a22b")      # sparse (MoE): real dirty tracking
    trainer = _trainer(cfg, async_tick=True)
    store = trainer.store
    data = SyntheticPipeline(cfg, ShapeConfig("t", 32, 4, "train"), seed=0, device="cpu")
    sparse = SyntheticPipeline(cfg, ShapeConfig("t", 4, 1, "train"), seed=1, device="cpu")

    # 1) train with periodic redundancy (due at 3 and 6, a scrub at 4).
    state = trainer.init_state(torch.Generator().manual_seed(0))
    losses = []
    state = trainer.run(state, data, 6, on_step=lambda s, m: losses.append(float(m["loss"])))
    assert losses[-1] < losses[0]
    assert trainer.corruption_alarms == 0

    # 2) one step of four tokens (8 of 8 choices a layer) after the due
    # tick: the expert slabs' dirty blocks are exactly those of the slabs
    # it routed to, and some slabs stay clean.
    state = trainer.settle(state)
    with torch.no_grad():
        _, aux = trainer.model.loss(state.params, sparse.get(state.step))
    routed = aux["expert_counts"][:, 0, :] > 0
    state = trainer.run(state, sparse, 1)
    assert state.step == 7
    meta = store.metas[LEAF]
    marked = bits.unpack(state.red[LEAF].dirty, meta.n_blocks)
    assert torch.equal(marked, B.row_mask_block_mask(meta, routed, row_dims=2))
    stats = store.dirty_stats(state.red)[LEAF]
    assert 0 < int(stats["dirty_blocks"]) < int(stats["total_blocks"])
    assert not bool(routed.all())

    # 3) silent corruption -> scrub detects it -> parity repair in place.
    state = trainer.flush(state)
    leaves = protected_leaves(state.params, state.opt)
    saved = leaves[LEAF].clone()
    lanes = B.to_lanes(leaves[LEAF], meta)
    assert lanes.data_ptr() == leaves[LEAF].data_ptr()
    lanes[0, 11] += 0xF00D
    mm = store.scrub(leaves, state.red)
    assert sum(int(v.sum()) for v in mm.values()) == 1 and bool(mm[LEAF][0])
    repaired, fixed, lost = store.repair(leaves, state.red, mm)
    assert (fixed, lost) == (1, 0)
    assert torch.equal(repaired[LEAF].view(torch.int16), saved.view(torch.int16))
    state = replace_protected(state, repaired)
    assert trainer.scrub_check(state) == 0

    # 4) preemption: flush + checkpoint.
    handler = PreemptionHandler()
    ckpt = CheckpointManager(tmp_path, device="cpu")
    state = handler.drain(trainer, state, ckpt)
    assert handler.flush_seconds is not None and ckpt.steps() == [state.step]

    # 5) a verified restore into a fresh trainer continues bit for bit.
    fresh = _trainer(cfg, async_tick=True)
    st_re = ckpt.restore_verified(fresh.state_struct(), fresh.store)
    assert st_re.step == state.step
    assert ckpt.last_restore_report.tried == [(state.step, "ok")]
    cont1 = trainer.run(state, data, 2)
    cont2 = fresh.run(st_re, data, 2)
    for n, p in flatten_dict(cont1.params).items():
        assert torch.equal(p, flatten_dict(cont2.params)[n]), n
    for k in ("m", "v"):
        for n, p in flatten_dict(cont1.opt[k]).items():
            assert torch.equal(p, flatten_dict(cont2.opt[k])[n]), f"{k}/{n}"
    cont1, cont2 = trainer.flush(cont1), fresh.flush(cont2)
    for n, r in cont1.red.items():
        np.testing.assert_array_equal(r.checksums.numpy(), cont2.red[n].checksums.numpy(),
                                      err_msg=n)
