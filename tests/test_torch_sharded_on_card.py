"""The sharded store's kernels on the card: every shard of a leaf in one
launch, against the plain versions.

Each test needs a CUDA device and skips without one (decided at run
time).  K1 and K2 take a leading shard axis, ``(k, n_blocks, L)``, for k
in {1, 3, 8}, shards of partial blocks and partial stripes included, and
equal their plain versions bit for bit; K3 updates a due group of sharded
and unsharded leaves in one launch, one job a shard; a strided (KV-spec)
leaf is staged into one copy and its fields equal the CPU store's.  The
module imports no JAX, so on the card it runs with:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_sharded_on_card.py -k on_card
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ProtectedStore, RedundancyEngine, RedundancyPolicy, blocks
from repro_torch.core.engine import RedundancyConfig
from repro_torch.core.state import FIELDS
from repro_torch.dist import P
from repro_torch.kernels.checksum import ops as ck_ops, ref as ck_ref
from repro_torch.kernels.parity import ops as par_ops, ref as par_ref
from repro_torch.kernels.redundancy import ops as fu_ops
from repro_torch.launch.mesh import make_mesh

AXES = ("pod", "data", "model")
KV_SPEC = P(None, None, ("pod", "data"), "model", None)


@pytest.fixture()
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _lanes(k, nb, L, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randint(-2**31, 2**31 - 1, (k, nb, L), dtype=torch.int32, generator=g)
    return x.to(device)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("nb,L,offset", [(13, 128, 0), (5, 1024, 7), (2, 16384, 0)])
def test_checksum_shard_axis_on_card(cuda_device, k, nb, L, offset):
    lanes = _lanes(k, nb, L, k * nb, cuda_device)
    before = ck_ops.LAUNCHES
    got = ck_ops.block_checksums(lanes, offset)
    torch.cuda.synchronize()
    assert ck_ops.LAUNCHES == before + 1 and got.shape == (k * nb,)
    assert torch.equal(got.cpu(), ck_ref.block_checksums(lanes.cpu(), offset))
    if k == 1:      # the machine-local launch, unchanged bits
        assert torch.equal(got, ck_ops.block_checksums(lanes[0], offset))


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("nb,L,sw", [(13, 128, 4), (9, 1024, 2), (6, 16384, 4), (3, 256, 5)])
def test_parity_shard_axis_on_card(cuda_device, k, nb, L, sw):
    lanes = _lanes(k, nb, L, 100 + k * nb, cuda_device)
    before = par_ops.LAUNCHES
    got = par_ops.stripe_parity(lanes, sw)
    torch.cuda.synchronize()
    ns = -(-nb // sw)
    assert par_ops.LAUNCHES == before + 1 and got.shape == (k * ns, L)
    assert torch.equal(got.cpu(), par_ref.stripe_parity(lanes.cpu(), sw))
    for s in range(k):
        assert torch.equal(got[s * ns:(s + 1) * ns], par_ops.stripe_parity(lanes[s], sw))


def test_padded_shard_copies_on_card(cuda_device):
    """A leaf whose shards end inside a block: the padded (k, nb, L) copy
    through K1 and K2 equals the plain versions and one launch a shard."""
    leaf = torch.randn((8 * 5, 300), device=cuda_device)
    meta = blocks.make_meta(blocks.ShapeDtype((5, 300), torch.float32), 512, 4)
    lanes = blocks.shard_lanes(leaf, meta, (8, 1))
    assert lanes.shape == (8, meta.n_blocks, 512) and lanes.data_ptr() != leaf.data_ptr()
    cks = ck_ops.block_checksums(lanes)
    par = par_ops.stripe_parity(lanes, 4)
    for s in range(8):
        one = blocks.to_lanes(leaf[s * 5:(s + 1) * 5], meta)
        nb = meta.n_blocks
        assert torch.equal(cks[s * nb:(s + 1) * nb], ck_ops.block_checksums(one))
        assert torch.equal(par[s * meta.n_stripes:(s + 1) * meta.n_stripes],
                           par_ops.stripe_parity(one, 4))
    assert torch.equal(cks.cpu(), ck_ref.block_checksums(lanes.cpu()))


def _group(device, mesh):
    structs = {"w": blocks.ShapeDtype((64, 2048), torch.float32),
               "e": blocks.ShapeDtype((16, 1024), torch.bfloat16),
               "u": blocks.ShapeDtype((24, 200), torch.float32),
               "kv": blocks.ShapeDtype((4, 16, 8, 8, 64), torch.bfloat16)}
    specs = {"w": P(("pod", "data", "model"), None), "e": P(("pod", "data"), None),
             "kv": KV_SPEC}
    cfg = RedundancyConfig(lanes_per_block=128, work_queue_frac=0.0)
    return RedundancyEngine(structs, cfg, device=device, mesh=mesh, specs=specs)


def _leaves(device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return {"w": torch.randn((64, 2048), generator=g).to(device),
            "e": torch.randn((16, 1024), generator=g).to(torch.bfloat16).to(device),
            "u": torch.randn((24, 200), generator=g).to(device),
            "kv": torch.randn((4, 16, 8, 8, 64), generator=g).to(torch.bfloat16).to(device)}


def test_sharded_group_is_one_launch_on_card(cuda_device):
    """Init is one K1 and one K2 launch a leaf, every shard together; the
    group's update is one K3 launch, one job a shard of every leaf; the
    state equals the CPU engine's (the plain versions) bit for bit."""
    card = _group(cuda_device, make_mesh((2, 2, 2), AXES, device=cuda_device))
    cpu = _group("cpu", make_mesh((2, 2, 2), AXES, device="cpu"))
    leaves = _leaves(cuda_device, 0)
    n1, n2 = ck_ops.LAUNCHES, par_ops.LAUNCHES
    red = card.init(leaves)
    torch.cuda.synchronize()
    assert (ck_ops.LAUNCHES - n1, par_ops.LAUNCHES - n2) == (4, 4)
    cred = cpu.init({k: v.cpu() for k, v in leaves.items()})
    ev = {"w": torch.zeros(64, dtype=torch.bool), "e": "__all__",
          "kv": torch.zeros((4, 16), dtype=torch.bool), "u": torch.zeros(24, dtype=torch.bool)}
    ev["w"][[0, 9, 63]] = True
    ev["kv"][1, [2, 5]] = True
    ev["u"][[3]] = True
    new = {k: v.clone() for k, v in leaves.items()}
    new["w"][[0, 9, 63]] += 1.0
    new["e"] += 1
    new["kv"][1, [2, 5]] *= -1
    new["u"][3] -= 2.0
    red = card.mark_dirty(red, {k: v if isinstance(v, str) else v.to(cuda_device)
                                for k, v in ev.items()})
    cred = cpu.mark_dirty(cred, ev)
    calls = []
    orig = fu_ops.fused_update_many

    def spy(jobs, *a, **kw):
        jobs = list(jobs)
        calls.append(len(jobs))
        return orig(jobs, *a, **kw)
    fu_ops.fused_update_many = spy
    try:
        n3 = fu_ops.LAUNCHES
        red = card.redundancy_step(new, red)
        torch.cuda.synchronize()
    finally:
        fu_ops.fused_update_many = orig
    assert fu_ops.LAUNCHES - n3 == 1 and calls == [8 + 4 + 1 + 8]
    cred = cpu.redundancy_step({k: v.cpu() for k, v in new.items()}, cred)
    for n in red:
        for f in FIELDS:
            assert torch.equal(getattr(red[n], f).cpu(), getattr(cred[n], f)), (n, f)
    scrub = card.scrub(new, red)
    assert all(int(m.sum()) == 0 for m in scrub.values())
    assert all(bool(v) for v in card.verify_meta(red).values())


@pytest.mark.parametrize("async_tick", [False, True], ids=["blocking", "overlapped"])
def test_staged_strided_leaf_equals_cpu_on_card(cuda_device, async_tick):
    """A KV cache's spec: the card stages the leaf's strided shards into one
    copy for K3 (and K1/K2), in place into the global arrays; after each
    tick and the flush the fields equal the CPU store's."""
    def store(device):
        pol = RedundancyPolicy.single("vilamb", period_steps=1, lanes_per_block=128,
                                      async_tick=async_tick, precompile=False)
        mesh = make_mesh((2, 2, 2), AXES, device=device)
        kv = torch.zeros((4, 16, 8, 8, 64), dtype=torch.bfloat16, device=device)
        return ProtectedStore(pol, mesh=mesh).attach({"kv": kv}, specs={"kv": KV_SPEC})
    card, cpu = store(cuda_device), store("cpu")
    kv = _leaves(cuda_device, 3)["kv"]
    red, cred = card.init({"kv": kv}), cpu.init({"kv": kv.cpu()})
    g = np.random.default_rng(0)
    for step in range(1, 5):
        ev = torch.zeros((4, 16), dtype=torch.bool)
        ev[g.integers(0, 4), g.choice(16, 3, replace=False)] = True
        kv = kv.clone()
        kv[ev.to(cuda_device)] += 1
        red = card.on_write(red, events={"kv": ev.to(cuda_device)})
        cred = cpu.on_write(cred, events={"kv": ev})
        red, _ = card.tick({"kv": kv}, red, step)
        cred, _ = cpu.tick({"kv": kv.cpu()}, cred, step)
    red = card.flush({"kv": kv}, red, 5)
    cred = cpu.flush({"kv": kv.cpu()}, cred, 5)
    torch.cuda.synchronize()
    for f in FIELDS:
        assert torch.equal(getattr(red["kv"], f).cpu(), getattr(cred["kv"], f)), f
    assert int(card.scrub({"kv": kv}, red)["kv"].sum()) == 0
