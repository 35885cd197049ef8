"""The port's cost counter (``repro_torch.launch.cost_analysis``), the
kernels' meta branches and the analytic parameter counts, on the CPU.

* ``param_count`` and ``active_param_count`` equal the reference's for
  every arch, full and smoke; ``effective_bytes`` and ``roofline_terms``
  equal ``repro.launch.hlo_analysis``'s (a module with no JAX import), the
  roofline given the reference's TPU v5e peaks.
* A smoke step with no store counts the same on the meta device as on a
  real CPU run of the same step: FLOPs, bytes, and each kernel's launches
  and work, for the dense, MoE, hybrid, xLSTM, vision and
  encoder-decoder archs and for train, prefill and decode.  With a vilamb
  store the kernels' launches and work agree too: K1 and K2 at init as
  they are, and K3 in the redundancy step with the CPU store's engines on
  the card's path (``use_kernels``, no work queue; K3 then runs its plain
  version), which the meta device takes.
* Each kernel's meta branch gives the card branch's shapes, raises on the
  card branch's bad arguments and leaves ``LAUNCHES`` unchanged.
* The bounds ``chip_smoke.py`` prints, now computed here, equal the
  script's earlier arithmetic (kept below as the oracle) at the shapes its
  phases use.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401  (torch's threads: each worker's share)
from repro import configs as ref_configs
from repro.launch import hlo_analysis as H
from repro_torch.configs import get_arch, get_smoke, list_archs
from repro_torch.core import ProtectedStore, RedundancyPolicy
from repro_torch.data import SyntheticPipeline
from repro_torch.kernels.checksum import ops as ck_ops
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.parity import ops as par_ops
from repro_torch.kernels.redundancy import ops as fu_ops
from repro_torch.launch import cost_analysis as C
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.serve import make_decode_step, make_prefill
from repro_torch.train import TrainState, make_redundancy_step, make_train_step

FAMILIES = ("llama3.2-3b", "qwen3-moe-235b-a22b", "jamba-1.5-large-398b", "xlstm-1.3b",
            "internvl2-1b", "seamless-m4t-medium")
KINDS = ("train", "prefill", "decode")
SHAPE = {"train": ShapeConfig("t", 32, 2, "train"), "prefill": ShapeConfig("p", 32, 2, "prefill"),
         "decode": ShapeConfig("d", 48, 2, "decode")}
META = torch.device("meta")


def smoke(arch):
    cfg = dataclasses.replace(get_smoke(arch), head_dim=64)
    return dataclasses.replace(cfg, n_layers=cfg.group_size)


# ------------------------------------------------------------ reference parity
@pytest.mark.parametrize("size", ("full", "smoke"))
@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_equal_reference(arch, size):
    get = {"full": (get_arch, ref_configs.get_arch),
           "smoke": (get_smoke, ref_configs.get_smoke)}[size]
    cfg, ref = get[0](arch), get[1](arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert cfg.sub_quadratic == ref.sub_quadratic


@pytest.mark.parametrize("g", (1, 2, 8, 16, 256))
@pytest.mark.parametrize("op", H.COLLECTIVES)
def test_effective_bytes_equal_reference(op, g):
    for n in (0, 4, 1 << 20, 3 * 5 * 7 * 1024):
        assert C.effective_bytes(op, n, g) == H.effective_bytes(op, n, g)


@pytest.mark.parametrize("terms", [(1e15, 3e10, 0.0, 256, 5e17), (2e12, 8e12, 1e9, 512, 1e14),
                                   (0.0, 1e9, 0.0, 1, 0.0), (5e13, 1e9, 7e10, 16, 9e15)])
def test_roofline_terms_equal_reference(terms):
    got = C.roofline_terms(*terms, peak_flops=H.PEAK_BF16_FLOPS, hbm_bw=H.HBM_BW,
                           link_bw=H.ICI_BW)
    assert got.as_dict() == H.roofline_terms(*terms).as_dict()


# ----------------------------------------------------- meta against the CPU
def _cell(cfg, kind, dev, mode):
    """One step's parts (``dryrun.run_parts``) on ``dev``: random CPU
    tensors from the seed, or shapes only on meta."""
    model = Model(cfg, torch.device(dev))
    gen = torch.Generator().manual_seed(0) if dev == "cpu" else None
    params = model.init(gen)
    shape = SHAPE[kind]
    if dev == "cpu":
        batch = SyntheticPipeline(cfg, shape, seed=0, device="cpu").get(0)
    else:
        batch = {k: torch.empty(v.shape, dtype=v.dtype, device=META) for k, v in
                 SyntheticPipeline(cfg, shape, seed=0, device="cpu").get(0).items()}
    policy = RedundancyPolicy.single(mode, precompile=False)

    def store_of(structs):
        if mode == "none":
            return None
        st = ProtectedStore(policy, device=dev).attach(structs)
        for g in st._protected():            # the card's path on the CPU too
            g.engine.use_kernels = True
            g.engine._queue_caps = {n: 0 for n in g.engine._queue_caps}
        return st

    if kind == "prefill":
        return dryrun.run_parts(kind, make_prefill(model, shape.seq_len), None, (params, batch))
    if kind == "train":
        opt = AdamW(lr=warmup_cosine(1e-3, 10, 100), moment_dtype=cfg.moment_dtype)
        state = TrainState.create(params, opt.init(params))
        from repro_torch.train import protected_structs
        store = store_of(protected_structs(params, state.opt))
        return dryrun.run_parts(kind, make_train_step(model, opt, store), store,
                                (state, batch),
                                make_redundancy_step(store) if store is not None else None)
    B, S = shape.global_batch, shape.seq_len
    enc = 16 if cfg.enc_dec else 0
    caches = model.init_caches(B, S, enc)
    store = store_of(model.cache_shapes(B, S, enc))
    token = torch.zeros((B,), dtype=torch.int32, device=dev)
    return dryrun.run_parts(kind, make_decode_step(model, store), store,
                            (params, caches, {}, token, S // 2))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_counts_on_meta_equal_a_cpu_run(arch, kind):
    """Mode none: every part's FLOPs, bytes, aten ops by name and kernels."""
    cfg = smoke(arch)
    meta, cpu = _cell(cfg, kind, "meta", "none"), _cell(cfg, kind, "cpu", "none")
    assert list(meta) == list(cpu) == ["step"]
    assert meta["step"].key() == cpu["step"].key()
    assert meta["step"].by_op == cpu["step"].by_op
    assert meta["step"].flops > 0 and meta["step"].bytes > 0
    if kind == "prefill" and cfg.ssm_kind != "xlstm":
        assert meta["step"].kernels["flash_attn"].launches > 0


@pytest.mark.parametrize("kind", ("train", "decode"))
@pytest.mark.parametrize("arch", ("llama3.2-3b", "qwen3-moe-235b-a22b", "seamless-m4t-medium"))
def test_kernel_counts_with_a_store_equal_a_cpu_run(arch, kind):
    cfg = smoke(arch)
    meta, cpu = _cell(cfg, kind, "meta", "vilamb"), _cell(cfg, kind, "cpu", "vilamb")
    assert list(meta) == list(cpu) == ["init", "step", "redundancy"]
    for part in meta:
        assert meta[part].key()["kernels"] == cpu[part].key()["kernels"], part
    assert set(meta["init"].kernels) == {"checksum", "parity"}
    assert set(meta["redundancy"].kernels) == {"fused_update"}
    assert meta["step"].launches() == {}


def test_counter_skips_ops_inside_a_wrapper_and_nests():
    lanes = torch.zeros((8, 128), dtype=torch.int32)
    with C.count_costs() as outer:
        torch.ones(4).add_(1)
        with C.count_costs() as inner:
            ck_ops.block_checksums(lanes)
    assert inner.n_ops == 0 and inner.kernels["checksum"].launches == 1
    assert inner.kernels["checksum"].bytes == 8 * 128 * 4 + 8 * 4
    assert outer.n_ops == 2 and outer.kernels == inner.kernels


# ------------------------------------------------------ the kernels' meta branches
def _meta(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device=META)


def _launches():
    return ck_ops.LAUNCHES, par_ops.LAUNCHES, fu_ops.LAUNCHES, fa_ops.LAUNCHES


def test_meta_branches_give_the_cards_shapes_and_launch_nothing():
    before = _launches()
    assert ck_ops.block_checksums(_meta(10, 128)).shape == (10,)
    assert ck_ops.block_checksums(_meta(3, 10, 128)).shape == (30,)
    assert par_ops.stripe_parity(_meta(10, 128), 4).shape == (3, 128)
    assert par_ops.stripe_parity(_meta(3, 10, 128), 4).shape == (9, 128)
    lanes, cks, par, words = _meta(10, 128), _meta(10), _meta(3, 128), _meta(1)
    out = fu_ops.fused_update_many([(lanes, cks, par, words)], 4)
    assert out[0][0] is cks and out[0][1] is par
    q = _meta(2, 33, 8, 128, dtype=torch.bfloat16)
    kv = _meta(2, 40, 2, 128, dtype=torch.bfloat16)
    o = fa_ops.flash_attention(q, kv, kv, causal=False)
    assert o.shape == q.shape and o.dtype == q.dtype and o.device == META
    cpu = fa_ops.flash_attention(torch.zeros(2, 33, 8, 128, dtype=torch.bfloat16),
                                 torch.zeros(2, 40, 2, 128, dtype=torch.bfloat16),
                                 torch.zeros(2, 40, 2, 128, dtype=torch.bfloat16), causal=False)
    assert cpu.shape == o.shape and cpu.dtype == o.dtype
    assert _launches() == before


@pytest.mark.parametrize("case", [
    ("flash hd 96", lambda: fa_ops.flash_attention(
        _meta(1, 8, 2, 96, dtype=torch.bfloat16), _meta(1, 8, 2, 96, dtype=torch.bfloat16),
        _meta(1, 8, 2, 96, dtype=torch.bfloat16)), "hd must be one of"),
    ("flash fp32", lambda: fa_ops.flash_attention(
        _meta(1, 8, 2, 64, dtype=torch.float32), _meta(1, 8, 2, 64, dtype=torch.float32),
        _meta(1, 8, 2, 64, dtype=torch.float32)), "bf16 or fp16"),
    ("flash grid", lambda: fa_ops.flash_attention(
        _meta(1 << 16, 1 << 20, 64, 64, dtype=torch.bfloat16),
        _meta(1 << 16, 1, 64, 64, dtype=torch.bfloat16),
        _meta(1 << 16, 1, 64, 64, dtype=torch.bfloat16)), "ceil"),
    ("checksum shards", lambda: ck_ops.block_checksums(_meta(65536, 1, 4)), "shards a launch"),
    ("checksum dtype", lambda: ck_ops.block_checksums(_meta(4, 128, dtype=torch.float32)),
     "int32"),
    ("checksum L", lambda: ck_ops.block_checksums(_meta(4, 126)), "multiple of 4"),
    ("checksum alignment", lambda: ck_ops.block_checksums(_meta(4 * 128 + 2)[2:].view(4, 128)),
     "16-byte aligned"),
    ("parity shards", lambda: par_ops.stripe_parity(_meta(65536, 1, 4)), "shards a launch"),
    ("parity stripe", lambda: par_ops.stripe_parity(_meta(8, 128), 0), "stripe_width"),
    ("K3 stripe", lambda: fu_ops.fused_update_many(
        [(_meta(8, 128), _meta(8), _meta(1, 128), _meta(1))], 17), "stripe_width"),
    ("K3 parity shape", lambda: fu_ops.fused_update_many(
        [(_meta(8, 128), _meta(8), _meta(3, 128), _meta(1))], 4), "parity"),
    ("K3 words", lambda: fu_ops.fused_update_many(
        [(_meta(8, 128), _meta(8), _meta(2, 128), _meta(2))], 4), "dirty_words"),
    ("K3 parity alignment", lambda: fu_ops.fused_update_many(
        [(_meta(8, 128), _meta(8), _meta(2 * 128 + 1)[1:].view(2, 128), _meta(1))], 4),
     "16-byte aligned"),
], ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_meta_branches_raise_where_the_card_raises(case):
    _, call, match = case
    before = _launches()
    with C.count_costs() as costs, pytest.raises(ValueError, match=match):
        call()
    assert _launches() == before and costs.kernels == {}


def test_flash_counts_a_packed_copy_by_name():
    q = _meta(1, 64, 8, 128, dtype=torch.bfloat16)
    kv = _meta(1, 64, 2, 128, dtype=torch.bfloat16)
    strided = _meta(1, 64, 128, 2, dtype=torch.bfloat16).transpose(2, 3)  # hd not unit-stride
    with C.count_costs() as costs:
        fa_ops.flash_attention(q, kv, kv)
    assert costs.copies == {}
    with C.count_costs() as costs:
        fa_ops.flash_attention(q, strided, strided)
    assert costs.copies == {"flash_attn packed copy": 2 * (2 * strided.numel() * 2)}
    assert costs.kernels["flash_attn"].launches == 1


# ------------------------------------------------------------- collectives
def test_no_collective_in_the_sharded_redundancy_step():
    cfg = smoke("llama3.2-3b")
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="meta")
    st = dryrun.build_setup(cfg, SHAPE["train"], mesh, "vilamb", 1)
    C.assert_no_collectives(lambda: st.redundancy_fn(st.state_struct), "redundancy step")


def test_a_collective_is_counted_with_effective_bytes():
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with C.count_costs() as costs:
            dist.all_reduce(torch.ones(256))
        assert costs.collectives.per_op_count == {"all-reduce": 1}
        assert costs.collectives.total_bytes == C.effective_bytes("all-reduce", 1024, 1)
        with pytest.raises(AssertionError, match="all-reduce"):
            C.assert_no_collectives(lambda: dist.all_reduce(torch.ones(4)), "probe")
    finally:
        dist.destroy_process_group()


# ------------------------------------------ the bounds chip_smoke.py prints
# chip_smoke.py's arithmetic before it moved to cost_analysis (the oracle).
_HBM, _ALU, _BF16 = 3.35e12, 132 * 64 * 1.98e9, 989e12


def old_bound(bytes_moved, ops, ops_per_sec=_ALU):
    t_bytes, t_ops = bytes_moved / _HBM, ops / ops_per_sec
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def old_attention_flops(B, Sq, Sk, H, hd, causal):
    if not causal:
        return 4 * B * H * hd * Sq * Sk
    n = min(Sq, Sk)
    return 4 * B * H * hd * (n * (n + 1) // 2 + max(0, Sq - Sk) * Sk)


def old_train_flops(cfg, n_params, batch=1, seq=4096):
    attn = 3 * 4 * batch * cfg.n_heads * cfg.hd * seq * (seq + 1) // 2
    return 6 * n_params * batch * seq + attn * cfg.n_layers


def old_xlstm_flops(cfg, n_params, batch=1, seq=4096):
    tokens, d = batch * seq, cfg.d_model
    hd = d // cfg.n_heads
    chunk = min(256, seq)
    per_layer = 2 * 2 * tokens * chunk * d + 2 * 2 * tokens * d * hd
    n_mlstm = sum(cfg.layer_kind(i) == "mlstm" for i in range(cfg.n_layers))
    return 6 * n_params * tokens + 3 * per_layer * n_mlstm


@pytest.mark.parametrize("nb,L", [(2_097_152, 1024), (16_384, 1024), (131_072, 1024),
                                  (18_432, 16_384), (64, 1024), (8 * 16_384, 1024)])
def test_k1_k2_bounds_equal_the_old_arithmetic(nb, L):
    assert C.bound(*C.checksum_work(nb, L)) == old_bound(nb * L * 4 + nb * 4, nb * L * 12)
    ns = nb // 4
    assert C.bound(*C.parity_work(nb, ns, L)) == old_bound(nb * L * 4 + ns * L * 4, nb * L)
    assert C.bound(*C.checksum_work(2_097_152, 1024))[0] == pytest.approx(2.567, abs=5e-4)
    assert C.bound(*C.parity_work(2_097_152, 524_288, 1024))[0] == pytest.approx(3.205, abs=5e-4)


@pytest.mark.parametrize("ns,n_dirty,L,words", [(61_711, 65_000, 1024, 65_536),
                                                (560, 1500, 16_384, 4096), (1, 1, 128, 1)])
def test_k3_bound_equals_the_old_arithmetic(ns, n_dirty, L, words):
    old = old_bound(ns * 4 * L * 4 + ns * L * 4 + n_dirty * 4 + words * 4, ns * 4 * L * 13)
    assert C.bound(*C.fused_update_work(ns, 4, L, words, checksums=n_dirty)) == old
    old = old_bound(ns * 4 * L * 4 + ns * L * 4 + ns * 4 * 4 + words * 4, ns * 4 * L * 13)
    assert C.bound(*C.fused_update_work(ns, 4, L, words)) == old


@pytest.mark.parametrize("shape", [(8, 4096, 4096, 24, 128, True), (8, 4096, 4096, 64, 64, True),
                                   (8, 4096, 4096, 64, 128, True), (8, 4352, 4352, 14, 64, True),
                                   (8, 6144, 6144, 16, 64, False), (8, 4096, 6144, 16, 64, False),
                                   (1, 1000, 129, 7, 128, True)])
def test_flash_bound_equals_the_old_arithmetic(shape):
    B, Sq, Sk, H, hd, causal = shape
    KV = 8 if H % 8 == 0 else 2
    q, k = _meta(B, Sq, H, hd, dtype=torch.bfloat16), _meta(B, Sk, KV, hd, dtype=torch.bfloat16)
    flops, n_bytes = C.flash_work(q, k, k, causal)
    assert flops == old_attention_flops(*shape)
    old_bytes = sum(t.numel() * t.element_size() for t in (q, k, k, q))
    assert C.bound(n_bytes, flops, C.PEAK_BF16_FLOPS) == old_bound(old_bytes, flops, _BF16)
    if shape == (8, 4096, 4096, 24, 128, True):
        assert C.bound(n_bytes, flops, C.PEAK_BF16_FLOPS)[0] == pytest.approx(0.834, abs=5e-4)


def test_model_flops_equal_the_old_arithmetic():
    llama, xl = get_arch("llama3.2-3b"), get_arch("xlstm-1.3b")
    assert C.train_flops(llama, 3_212_749_824, 1, 4096) == old_train_flops(llama, 3_212_749_824)
    xl24 = dataclasses.replace(xl, n_layers=24)
    assert C.xlstm_flops(xl24, 713_527_392, 1, 4096) == old_xlstm_flops(xl24, 713_527_392)
    assert C.ALU_OPS_PER_SEC == _ALU and C.HBM_BW == _HBM and C.PEAK_BF16_FLOPS == _BF16


def test_due_tick_bound_counts_the_snapshots_stripes():
    store = ProtectedStore(RedundancyPolicy.single("vilamb", precompile=False),
                           device="cpu").attach({"w": torch.zeros(1024, 1024)})
    meta = store.metas["w"]
    dirty = np.zeros(meta.n_blocks, dtype=bool)
    dirty[[0, 1, 9, 33, 63]] = True
    from repro_torch.core import bits
    words = bits.pack_mask(torch.from_numpy(dirty))
    got = C.due_tick_bound(store, {"w": words})
    ns = len({b // meta.stripe_data_blocks for b in np.flatnonzero(dirty)})
    L = meta.lanes_per_block
    want = old_bound(ns * 4 * L * 4 + ns * L * 4 + ns * 4 * 4 + words.numel() * 4,
                     ns * 4 * L * 13)
    assert got["stripes"] == ns and (got["bound_ms"], got["bound_by"]) == want
