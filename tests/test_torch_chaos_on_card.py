"""The chaos soak on the card.

Each test needs a CUDA device and skips without one (decided at run
time).  The machine-local and the sharded smoke soaks keep every
invariant on the card's overlapped tick, and after the final flush the
card's checksums and parity equal the plain versions recomputed from the
card's final leaf, bit for bit, shard by shard.  The card's tick adopts
updates at other ticks than the CPU's, so the runs are held to the
invariants and to the recompute, not to the CPU's counters.  The module
imports no JAX, so on the card it runs with:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_chaos_on_card.py -k on_card
"""
import pytest
import torch

from repro_torch.faults import ChaosSchedule
from repro_torch.faults.chaos import _ChaosRunner
from repro_torch.kernels.checksum import ops as ck_ops, ref as ck_ref
from repro_torch.kernels.parity import ops as par_ops, ref as par_ref
from repro_torch.kernels.redundancy import ops as k3_ops

STRIPE = 4


@pytest.fixture()
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _plain_fields_equal(runner):
    store, leaf, r = runner.store, runner.leaves["w"], runner.red["w"]
    meta = store.metas["w"]
    lanes = store.engine_for("w").lanes_by_shard(leaf, "w")
    k = lanes.shape[0]
    assert k == store.shard_factor("w")
    cks = torch.cat([ck_ref.block_checksums(lanes[s], 0) for s in range(k)])
    par = torch.cat([par_ref.stripe_parity(lanes[s], STRIPE) for s in range(k)])
    assert cks.shape[0] == k * meta.n_blocks and par.shape[0] == k * meta.n_stripes
    assert torch.equal(cks, r.checksums) and torch.equal(par, r.parity)
    assert not bool((r.dirty | r.shadow).any())
    assert all(bool(v) for v in store.verify_meta(runner.red).values())


@pytest.mark.parametrize("sharded", [False, True], ids=["machine_local", "sharded"])
def test_smoke_soak_on_card(cuda_device, sharded):
    before = (ck_ops.LAUNCHES, par_ops.LAUNCHES, k3_ops.LAUNCHES)
    runner = _ChaosRunner(ChaosSchedule.default(0, sharded=sharded, smoke=True),
                          sharded=sharded, device=cuda_device)
    res = runner.run()
    torch.cuda.synchronize()
    assert res.ok(), res.summary()
    assert res.bitflips_repaired == res.bitflips_injected > 0
    assert res.crash_restores == 1 and res.reads_checked > 0
    assert res.reads_stale == 0 and res.silent_violations == 0
    assert res.final_clean and res.final_bitwise
    if sharded:
        assert res.rebuild_done and res.remesh_done
        assert runner.store.shard_factor("w") == 8 and runner.store.geometry_version == 1
    after = (ck_ops.LAUNCHES, par_ops.LAUNCHES, k3_ops.LAUNCHES)
    assert all(a > b for a, b in zip(after, before)), (before, after)
    _plain_fields_equal(runner)
