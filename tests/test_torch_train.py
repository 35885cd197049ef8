"""The port's training path against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; weights
are the reference's ``Model.init`` carried across with
``params_from_numpy`` (and its AdamW state with ``opt_from_numpy``).  The
reference's attention runs its differentiable jnp path
(``use_flash_kernel=False``).  Tolerances, each from what separates the
two: summation order in fp32 (XLA's reductions and products against
torch's), which moves losses by ~3e-7 and gradients by ~1e-6 of a leaf's
largest entry:

- losses: rtol 1e-5; gradients: 1e-4 of each leaf's max |g|;
- layer functions and their VJPs in fp32: rtol = atol = 1e-5;
  in bf16: 1e-2 (one bf16 rounding, at points where XLA and torch may
  round differently);
- the cross entropy's ``dlogits`` in bf16: one bf16 ulp (both round the
  same fp32 value, up to fp32 summation order);
- after four ``Trainer`` steps: losses rtol 1e-5, moments 1e-5 of each
  leaf's max, params atol 1e-4 (AdamW's first steps move an element by
  about lr whatever its gradient's size, so ~1e-6 gradient differences on
  near-zero gradients move such params by up to a few 1e-5 at lr 6e-4);
- dirty bitvectors, the batches and, within the port, the losses with and
  without a store: bitwise.
"""
import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_bits_equal
from repro.common import flatten_dict as jflatten
from repro.configs import get_smoke as jget_smoke
from repro.core import ProtectedStore as JStore, RedundancyPolicy as JPolicy
from repro.data import SyntheticPipeline as JPipeline
from repro.models import attention as jattn, build_model as jbuild, layers as jlayers
from repro.models import model as jmodel
from repro.models.config import ShapeConfig as JShape
from repro.optim import AdamW as JAdamW, warmup_cosine as jwarmup_cosine
from repro.train import Trainer as JTrainer, protected_structs as jstructs
from repro_torch.common import flatten_dict, tree_map
from repro_torch.configs import get_smoke
from repro_torch.core import ProtectedStore, RedundancyPolicy, bits
from repro_torch.core.convert import leaves_from_numpy, leaves_to_numpy
from repro_torch.data import SyntheticPipeline
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.launch import train as launcher
from repro_torch.models import (Model, ShapeConfig, attention as tattn, build_model,
                                cross_entropy, layers as tlayers, model as tmodel,
                                opt_from_numpy, params_from_numpy)
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import (TrainState, Trainer, make_train_step, protected_leaves,
                               protected_structs, replace_protected)
from repro_torch.train.train_loop import loss_and_grads

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["llama3.2-3b", "olmo-1b", "glm4-9b", "nemotron-4-15b",
         "qwen3-moe-235b-a22b", "arctic-480b"]
MOE_ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b"]
RTOL = ATOL = 1e-5
L = 512                                   # lanes per block of the smoke stores


def _close(got, want, tol=ATOL, msg=""):
    np.testing.assert_allclose(torch.as_tensor(got).detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _grads_close(tgrads, jgrads, msg=""):
    """Every leaf within 1e-4 of its largest |g|."""
    jg = jflatten(jgrads)
    assert set(tgrads) == set(jg), set(tgrads) ^ set(jg)
    for n, g in tgrads.items():
        want = np.asarray(jg[n], np.float32)
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.float().numpy(), want, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"{msg} {n}")


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jget_smoke(arch), param_dtype=dtype, **kw),
            dataclasses.replace(get_smoke(arch), param_dtype=dtype, **kw))


def _pair(arch, dtype="float32", **kw):
    """(JAX model, its params, port model, the same params)."""
    jcfg, tcfg = _cfgs(arch, dtype, **kw)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, build_model(tcfg, "cpu"), tp


def _batch(cfg, B=2, S=32, seed=0, ignore=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(-1 if ignore else 0, cfg.vocab_size, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})


def _x(shape, dtype, seed=0):
    import ml_dtypes
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
    return a, leaves_from_numpy({"x": a}, "cpu")["x"]


# ---------------------------------------------------------------- cross entropy
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(dtype):
    """Loss and dlogits against ``jax.grad`` of the reference's custom VJP,
    with a padded vocabulary (500 of 512) and ignored labels (< 0)."""
    V, vocab = 512, 500
    a, logits = _x((2, 16, V), dtype, 1)
    logits = logits * 4
    a = np.asarray(logits.float().numpy()).astype(a.dtype)
    labels = np.random.default_rng(2).integers(-1, vocab, (2, 16)).astype(np.int32)
    g = 0.7
    jl, jvjp = jax.vjp(lambda x: jmodel.cross_entropy(x, jnp.asarray(labels), vocab),
                       jnp.asarray(a))
    (jd,) = jvjp(jnp.float32(g))
    x = logits.clone().requires_grad_()
    tl = cross_entropy(x, torch.from_numpy(labels), vocab)
    (td,) = torch.autograd.grad(tl, x, torch.tensor(g))
    assert tl.dtype == torch.float32 and td.dtype == x.dtype
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    if dtype == "float32":
        _close(td, jd, 1e-7)
    else:
        from test_torch_optim import ulps
        assert ulps(leaves_to_numpy({"d": td})["d"], np.asarray(jd)) <= 1
    assert not bool(td[..., vocab:].any()), "the padded tail got a gradient"
    assert not bool(td[torch.from_numpy(labels) < 0].any()), "an ignored label got one"


def test_cross_entropy_row_slices_change_no_bit(monkeypatch):
    """Slicing the fp32 temporaries over rows changes no element's
    arithmetic: loss and dlogits are bitwise those of one whole slice."""
    _, logits = _x((3, 40, 300), "bfloat16", 3)
    labels = torch.from_numpy(np.random.default_rng(4).integers(-1, 256, (3, 40)))

    def run():
        x = logits.clone().requires_grad_()
        loss = cross_entropy(x, labels, 256)
        return loss, torch.autograd.grad(loss, x)[0]
    whole = run()
    monkeypatch.setattr(tmodel, "CE_SLICE_ELEMS", 7 * 300)
    assert len(tmodel._row_slices(120, 300)) == 18
    sliced = run()
    assert torch.equal(whole[0], sliced[0]) and torch.equal(whole[1], sliced[1])


# ---------------------------------------------------------------- norms, grad_cast
def _vjp_both(jfn, tfn, arrays, tensors, ct_seed=9):
    """Forward and VJP of both functions at the same inputs and cotangent."""
    jy, jvjp = jax.vjp(jfn, *[jnp.asarray(a) for a in arrays])
    ct_np, ct = _x(jy.shape, str(jy.dtype), ct_seed)
    jgrads = jvjp(jnp.asarray(ct_np))
    ts = [t.clone().requires_grad_() for t in tensors]
    ty = tfn(*ts)
    tgrads = torch.autograd.grad(ty, ts, ct)
    return (jy, jgrads), (ty, tgrads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "rms_noscale", "ln", "nonparam_ln"])
def test_custom_vjp_norms_match_reference(dtype, kind):
    tol = ATOL if dtype == "float32" else 1e-2
    xa, xt = _x((2, 8, 64), dtype, 0)
    sa, st = _x((64,), "float32", 1)
    ba, bt = _x((64,), "float32", 2)
    sa, st = sa * 0.1, st * 0.1
    cases = {
        "rms": (lambda x, s: jlayers.rmsnorm_cv(x, s), lambda x, s: tlayers.rmsnorm_cv(x, s),
                [xa, sa], [xt, st]),
        "rms_noscale": (lambda x: jlayers.rmsnorm_cv(x, None),
                        lambda x: tlayers.rmsnorm_cv(x, None), [xa], [xt]),
        "ln": (lambda x, s, b: jlayers.layernorm_cv(x, s, b),
               lambda x, s, b: tlayers.layernorm_cv(x, s, b), [xa, 1 + sa, ba],
               [xt, 1 + st, bt]),
        "nonparam_ln": (lambda x: jlayers.layernorm_cv(x, None, None),
                        lambda x: tlayers.layernorm_cv(x, None, None), [xa], [xt]),
    }
    jfn, tfn, arrays, tensors = cases[kind]
    (jy, jg), (ty, tg) = _vjp_both(jfn, tfn, arrays, tensors)
    assert ty.dtype == xt.dtype and tg[0].dtype == xt.dtype
    _close(ty, jy, tol, "forward")
    for i, (t, j) in enumerate(zip(tg, jg)):
        _close(t, j, tol * max(1.0, float(np.abs(np.asarray(j, np.float32)).max())),
               f"grad {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_cast_matches_reference(dtype):
    """Identity forward; the cotangent of an fp32 consumer comes back in the
    primal dtype."""
    xa, xt = _x((4, 8), dtype, 5)
    (jy, (jg,)), (ty, (tg,)) = _vjp_both(
        lambda x: jattn.grad_cast(x).astype(jnp.float32) * 3.0,
        lambda x: tattn.grad_cast(x).float() * 3.0, [xa], [xt])
    assert torch.equal(ty, xt.float() * 3.0) and tg.dtype == xt.dtype
    assert str(jg.dtype) == dtype
    _close(tg, jg)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("S,tile", [(32, 8), (48, 16), (16, 0)])
@pytest.mark.parametrize("grad_cast", [False, True])
def test_tiled_causal_attention_matches_reference(S, tile, grad_cast):
    """The training attention with S > tile (the lower-triangle schedule
    and the flash-style merges), forward and grads of x and every weight,
    against the reference's differentiable path."""
    jcfg, tcfg = _cfgs("llama3.2-3b", attn_tile=tile, bf16_grad_boundaries=grad_cast)
    assert not jcfg.use_flash_kernel
    jp = jattn.attn_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = leaves_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    xa, xt = _x((2, S, 64), "float32", 8)
    names = sorted(tp)

    def jfn(x, *ws):
        return jattn.causal_attention(dict(zip(names, ws)), x, jcfg, tile=tile)[0]

    def tfn(x, *ws):
        return tattn.causal_attention(dict(zip(names, ws)), x, tcfg, train=True)[0]
    (jy, jg), (ty, tg) = _vjp_both(jfn, tfn, [xa] + [np.asarray(jp[n]) for n in names],
                                   [xt] + [tp[n] for n in names])
    _close(ty, jy)
    for n, t, j in zip(["x"] + names, tg, jg):
        _close(t, j, ATOL * max(1.0, float(np.abs(np.asarray(j)).max())), n)


@pytest.mark.parametrize("B,H,S", [(1, 24, 4096), (8, 24, 4096), (2, 4, 32), (1, 4, 1536)])
def test_pick_tile_matches_reference(B, H, S):
    assert tattn.pick_tile(B, H, S) == jattn.pick_tile(B, H, S)
    assert tattn.pick_tile(1, 24, 4096) == 1024


def test_flash_path_raises_on_a_gradient():
    """The flash kernel is forward-only: asked for a gradient it raises, on
    the CPU too, and never falls back to the differentiable path."""
    q = torch.randn(1, 8, 4, 64, requires_grad=True)
    k, v = torch.randn(1, 8, 2, 64), torch.randn(1, 8, 2, 64)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_ops.flash_attention(q, k, v)
    with torch.no_grad():
        assert flash_ops.flash_attention(q, k, v).shape == (1, 8, 4, 64)
    jcfg, tcfg = _cfgs("llama3.2-3b")
    tp = {n: w.requires_grad_() for n, w in leaves_from_numpy(jax.tree_util.tree_map(
        np.asarray, jattn.attn_init(jax.random.PRNGKey(2), jcfg, jnp.float32)),
        "cpu").items()}
    with pytest.raises(RuntimeError, match="forward-only"):
        tattn.causal_attention(tp, torch.randn(1, 8, 64), tcfg)
    y, _ = tattn.causal_attention(tp, torch.randn(1, 8, 64), tcfg, train=True)
    assert y.requires_grad


def test_stack_modes_are_explicit():
    tm = build_model(get_smoke("llama3.2-3b"), "cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    x = torch.zeros(1, 4, tm.cfg.d_model, dtype=tm.dtype)
    with pytest.raises(ValueError, match="fills caches"):
        tfm.stack_apply_full(params["stack"], x, tm.cfg)
    with pytest.raises(ValueError, match="fills caches"):
        tfm.stack_apply_full(params["stack"], x, tm.cfg, tm.init_caches(1, 8), train=True)


# ---------------------------------------------------------------- Model.loss
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("norm_vjp", ["autodiff", "custom"])
def test_loss_and_grads_match_reference(arch, norm_vjp):
    """``Model.loss`` and every leaf's gradient against
    ``jax.value_and_grad(model.loss)``, fp32, four attention tiles."""
    jm, jp, tm, tp = _pair(arch, norm_vjp=norm_vjp, attn_tile=8)
    jb, tb = _batch(tm.cfg)
    (jl, jaux), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    tl, taux, tg = loss_and_grads(tm, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    for k in ("ce", "aux_loss", "logits_mean"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=RTOL, err_msg=k)
    assert taux["expert_counts"].dtype == torch.int32
    np.testing.assert_array_equal(taux["expert_counts"].numpy(),
                                  np.asarray(jaux["expert_counts"]))
    _grads_close(tg, jg, arch)
    assert all(not p.requires_grad for p in flatten_dict(tp).values())


def test_remat_changes_no_gradient():
    """Per-slot checkpointing recomputes the same forward: grads with
    ``remat="full"`` equal those with ``"none"`` bit for bit."""
    _, _, tm, tp = _pair("llama3.2-3b", attn_tile=8)
    _, tb = _batch(tm.cfg)
    assert tm.cfg.remat == "full"
    full = loss_and_grads(tm, tp, tb)
    none = loss_and_grads(Model(dataclasses.replace(tm.cfg, remat="none"), tm.device),
                          tp, tb)
    assert torch.equal(full[0], none[0])
    for n, g in full[2].items():
        assert torch.equal(g, none[2][n]), n


def test_training_embedding_equals_serving_lookup():
    tm = build_model(get_smoke("llama3.2-3b"), "cpu")
    table = tm.init(torch.Generator().manual_seed(0))["embed"]
    toks = torch.tensor([[3, 0, 511, 3]], dtype=torch.int32)
    assert torch.equal(tm._embed({"embed": table}, toks),
                       table.index_select(0, toks.reshape(-1).long()).view(1, 4, -1))


# ---------------------------------------------------------------- dirty events
def _stores(jm, tm, opt_j, opt_t, mode="vilamb", period=100, async_tick=False):
    p0 = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    js = JStore(JPolicy.single(mode, period_steps=period, async_tick=async_tick,
                               precompile=False, lanes_per_block=L)).attach(
        jstructs(p0, jax.eval_shape(opt_j.init, p0)))
    mp = Model(tm.cfg, torch.device("meta")).init()
    ts = ProtectedStore(RedundancyPolicy.single(mode, period_steps=period,
                                                async_tick=async_tick, lanes_per_block=L),
                        device="cpu").attach(protected_structs(mp, opt_t.init(mp)))
    return js, ts


def test_dirty_events_train_and_bitvectors_match_reference():
    """The presence mask over the padded vocab and the dirty bitvectors of
    every protected leaf after ``on_write`` (embed rows straddle blocks at
    L = 512 lanes), bit for bit."""
    jm, jp, tm, tp = _pair("llama3.2-3b")
    jb, tb = _batch(tm.cfg, S=64, ignore=False)
    jev = jm.dirty_events_train(jb, {"expert_counts": jnp.zeros((3, 1, 1), jnp.int32)})
    tev = tm.dirty_events_train(tb, {})
    assert set(jev) == set(tev) == {"embed"}
    np.testing.assert_array_equal(tev["embed"].numpy(), np.asarray(jev["embed"]))
    jopt, topt = JAdamW(lr=lambda s: 1e-3), AdamW(lr=lambda s: 1e-3)
    js, ts = _stores(jm, tm, jopt, topt)
    jo = jopt.init(jp)
    to = opt_from_numpy(jax.tree_util.tree_map(np.asarray, jo), tm.cfg, "cpu")
    from repro.train import protected_leaves as jleaves
    jred = js.on_write(js.init(jleaves(jp, jo)), events=js.expand_events(jev))
    tred = ts.on_write(ts.init(protected_leaves(tp, to)), events=ts.expand_events(tev))
    assert set(jred) == set(tred)
    for n in jred:
        assert_bits_equal(tred[n].dirty, jred[n].dirty, n)
    meta = ts.metas["params/embed"]
    marked = bits.unpack(tred["params/embed"].dirty, meta.n_blocks)
    assert 0 < int(marked.sum()) < meta.n_blocks


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dirty_events_and_bitvectors_match_reference(arch):
    """The expert-slab masks ``counts[:, s] > 0`` (G, E) beside the embedding
    rows, from each package's own loss, and every leaf's dirty bitvector
    after ``on_write``, bit for bit.  Four tokens choose 8 of 8 experts
    per layer, so some slabs stay clean."""
    jm, jp, tm, tp = _pair(arch)
    jb, tb = _batch(tm.cfg, B=1, S=4, ignore=False)
    (_, jaux), _ = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    _, taux, _ = loss_and_grads(tm, tp, tb)
    jev = jm.dirty_events_train(jb, jaux)
    tev = tm.dirty_events_train(tb, taux)
    assert set(jev) == set(tev) == {"embed", "stack/slot_0/moe/wi", "stack/slot_0/moe/wg",
                                    "stack/slot_0/moe/wo"}
    for n in jev:
        np.testing.assert_array_equal(tev[n].numpy(), np.asarray(jev[n]), err_msg=n)
    slabs = tev["stack/slot_0/moe/wi"]
    assert slabs.shape == (tm.cfg.n_groups, tm.cfg.n_experts) and not bool(slabs.all())
    jopt, topt = JAdamW(lr=lambda s: 1e-3), AdamW(lr=lambda s: 1e-3)
    js, ts = _stores(jm, tm, jopt, topt)
    jo = jopt.init(jp)
    to = opt_from_numpy(jax.tree_util.tree_map(np.asarray, jo), tm.cfg, "cpu")
    from repro.train import protected_leaves as jleaves
    jred = js.on_write(js.init(jleaves(jp, jo)), events=js.expand_events(jev))
    tred = ts.on_write(ts.init(protected_leaves(tp, to)), events=ts.expand_events(tev))
    for n in jred:
        assert_bits_equal(tred[n].dirty, jred[n].dirty, n)
    meta = ts.metas["m/stack/slot_0/moe/wo"]
    marked = bits.unpack(tred["m/stack/slot_0/moe/wo"].dirty, meta.n_blocks)
    assert 0 < int(marked.sum()) < meta.n_blocks


# ---------------------------------------------------------------- Trainer
def _trainer_pair(arch="llama3.2-3b", mode="vilamb", period=2, async_tick=False, **kw):
    jm, _, tm, _ = _pair(arch, **kw)
    jopt = JAdamW(lr=jwarmup_cosine(3e-3, 5, 100), moment_dtype=tm.cfg.moment_dtype)
    topt = AdamW(lr=warmup_cosine(3e-3, 5, 100), moment_dtype=tm.cfg.moment_dtype)
    js, ts = _stores(jm, tm, jopt, topt, mode, period, async_tick)
    jtr = JTrainer(model=jm, opt=jopt, store=js, scrub_period_steps=0)
    ttr = Trainer(model=tm, opt=topt, store=ts, scrub_period_steps=0)
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate.params), tm.cfg, "cpu")
    to = opt_from_numpy(jax.tree_util.tree_map(np.asarray, jstate.opt), tm.cfg, "cpu")
    tstate = TrainState.create(tp, to, ts.init(protected_leaves(tp, to)))
    shape = ("t", 64, 4, "train")
    return (jtr, jstate, JPipeline(jm.cfg, JShape(*shape), seed=0)), \
        (ttr, tstate, SyntheticPipeline(tm.cfg, ShapeConfig(*shape), seed=0, device="cpu"))


def test_four_trainer_steps_match_reference():
    """Four steps from the same numpy state: losses, params and both
    moments within the stated tolerances; the dirty bitvectors (due ticks
    at 2 and 4) bit for bit."""
    (jtr, js, jd), (ttr, ts, td) = _trainer_pair()
    jl, tl = [], []
    js = jtr.run(js, jd, 4, on_step=lambda s, m: jl.append(float(m["loss"])))
    ts = ttr.run(ts, td, 4, on_step=lambda s, m: tl.append(float(m["loss"])))
    assert ts.step == int(js.step) == 4 and ts.opt["count"] == int(js.opt["count"]) == 4
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    jf = jflatten({"params": js.params, "m": js.opt["m"], "v": js.opt["v"]})
    tf = flatten_dict({"params": ts.params, "m": ts.opt["m"], "v": ts.opt["v"]})
    assert set(jf) == set(tf)
    for n, t in tf.items():
        want = np.asarray(jf[n], np.float32)
        atol = 1e-4 if n.startswith("params/") else 1e-5 * float(np.abs(want).max())
        np.testing.assert_allclose(t.numpy(), want, rtol=0, atol=atol, err_msg=n)
    for n in js.red:
        assert_bits_equal(ts.red[n].dirty, js.red[n].dirty, n)
        assert_bits_equal(ts.red[n].shadow, js.red[n].shadow, n)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_four_moe_trainer_steps_match_reference(moment_dtype):
    """qwen3-moe smoke, four steps: losses and aux losses, params and both
    moments within the tolerances above (bf16 moments: one bf16 ulp of the
    element, at most 2^-7 of it, as both round nearly the same fp32 value,
    plus one of the leaf's largest, 2^-8 of it, where ``b1 * m + (1 - b1) *
    g`` cancels to near zero from operands rounded to bf16), and every
    dirty and shadow bitvector, the expert slabs' included, bit for bit."""
    (jtr, js, jd), (ttr, ts, td) = _trainer_pair(MOE_ARCHS[0], moment_dtype=moment_dtype)
    jl, tl = [], []
    js = jtr.run(js, jd, 4, on_step=lambda s, m: jl.append(
        (float(m["loss"]), float(m["aux_loss"]))))
    ts = ttr.run(ts, td, 4, on_step=lambda s, m: tl.append(
        (float(m["loss"]), float(m["aux_loss"]))))
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert ts.opt["m"]["stack"]["slot_0"]["moe"]["wi"].dtype == getattr(torch, moment_dtype)
    jf = jflatten({"params": js.params, "m": js.opt["m"], "v": js.opt["v"]})
    tf = flatten_dict({"params": ts.params, "m": ts.opt["m"], "v": ts.opt["v"]})
    for n, t in tf.items():
        want = np.asarray(jf[n], np.float32)
        bf16 = moment_dtype == "bfloat16" and not n.startswith("params/")
        atol = 1e-4 if n.startswith("params/") else \
            (2.0**-8 if bf16 else 1e-5) * float(np.abs(want).max())
        rtol = 2.0**-7 if bf16 else 0
        np.testing.assert_allclose(t.float().numpy(), want, rtol=rtol, atol=atol, err_msg=n)
    for n in js.red:
        assert_bits_equal(ts.red[n].dirty, js.red[n].dirty, n)
        assert_bits_equal(ts.red[n].shadow, js.red[n].shadow, n)


def _port_trainer(mode, period=4, async_tick=False, arch="llama3.2-3b"):
    cfg = get_smoke(arch)
    m = build_model(cfg, "cpu")
    opt = AdamW(lr=warmup_cosine(3e-3, 5, 100))
    store = None
    if mode != "none":
        mp = Model(cfg, torch.device("meta")).init()
        store = ProtectedStore(RedundancyPolicy.single(
            mode, period_steps=period, async_tick=async_tick, lanes_per_block=L),
            device="cpu").attach(protected_structs(mp, opt.init(mp)))
    tr = Trainer(model=m, opt=opt, store=store, scrub_period_steps=5)
    data = SyntheticPipeline(cfg, ShapeConfig("t", 64, 4, "train"), seed=0, device="cpu")
    return cfg, tr, data


@pytest.mark.parametrize("mode", ["none", "vilamb", "sync"])
def test_modes_train_identically(mode):
    """Redundancy is observational: training goes down with every mode,
    raises no alarm, and a flushed state scrubs clean."""
    cfg, tr, data = _port_trainer(mode)
    st = tr.init_state(torch.Generator().manual_seed(0))
    losses = []
    st = tr.run(st, data, 8, on_step=lambda s, m: losses.append(float(m["loss"])))
    assert losses[-1] < losses[0]
    assert tr.corruption_alarms == 0
    if mode != "none":
        st = tr.flush(st)
        assert sum(int(v.sum()) for v in tr.scrub_fn(st).values()) == 0
        assert tr.scrub_check(st) == 0


def test_mode_losses_equal():
    """Losses bitwise equal with no store, vilamb on the overlapped and on
    the blocking tick, and sync; and so are the final params."""
    results, params = {}, {}
    for key, mode, async_tick in (("none", "none", False), ("vilamb", "vilamb", True),
                                  ("vilamb_blocking", "vilamb", False),
                                  ("sync", "sync", False)):
        _, tr, data = _port_trainer(mode, async_tick=async_tick)
        st = tr.init_state(torch.Generator().manual_seed(0))
        losses = []
        st = tr.run(st, data, 5, on_step=lambda s, m: losses.append(float(m["loss"])))
        results[key], params[key] = losses, flatten_dict(st.params)
    for key in results:
        assert results[key] == results["none"], key
        for n, p in params[key].items():
            assert torch.equal(p, params["none"][n]), (key, n)


def test_grad_accumulation_equivalent():
    cfg = dataclasses.replace(get_smoke("olmo-1b"), param_dtype="float32")
    m = build_model(cfg, "cpu")
    opt = AdamW(lr=lambda s: 1e-3)
    batch = SyntheticPipeline(cfg, ShapeConfig("t", 32, 8, "train"), seed=1,
                              device="cpu").get(0)
    params = m.init(torch.Generator().manual_seed(0))
    out = {}
    for k in (1, 4):
        p = tree_map(torch.clone, params)
        st = TrainState.create(p, opt.init(p))
        out[k] = make_train_step(m, opt, None, accum_steps=k)(st, batch)
    (st1, m1), (st4, m4) = out[1], out[4]
    # Same data, same total gradient: loss and grad norm agree; params agree
    # to Adam's first-step scale (lr): near-zero grads flip sign freely
    # between accumulation orders, so atol is in units of lr.
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m4["grad_norm"]), rtol=1e-3)
    for n, a in flatten_dict(st1.params).items():
        np.testing.assert_allclose(a.numpy(), flatten_dict(st4.params)[n].numpy(),
                                   atol=2.1e-3)


def test_vilamb_amortization_counter():
    """Dirty bits accumulate across steps and clear at the flush."""
    _, tr, data = _port_trainer("vilamb", period=100)
    st = tr.run(tr.init_state(torch.Generator().manual_seed(0)), data, 3)
    assert sum(int(bits.popcount(r.dirty)) for r in st.red.values()) > 0
    st = tr.flush(st)
    assert sum(int(bits.popcount(r.dirty)) for r in st.red.values()) == 0


def test_trainer_refuses_a_store_on_another_device():
    cfg = get_smoke("llama3.2-3b")
    opt = AdamW(lr=lambda s: 1e-3)
    mp = Model(cfg, torch.device("meta"))
    store = ProtectedStore(RedundancyPolicy.single("vilamb", lanes_per_block=L),
                           device="cpu").attach(protected_structs(mp.init(), opt.init(mp.init())))
    with pytest.raises(ValueError, match="the store is on cpu"):
        Trainer(model=mp, opt=opt, store=store)


def test_replace_protected_keeps_structure():
    p = {"a": torch.zeros(2), "norm": {}}
    o = {"m": {"a": torch.zeros(2), "norm": {}}, "v": {"a": torch.zeros(2), "norm": {}},
         "count": 3}
    st = TrainState.create(p, o)
    new = torch.ones(2)
    st2 = replace_protected(st, {"params/a": new, "v/a": new})
    assert st2.params["a"] is new and st2.opt["v"]["a"] is new
    assert st2.opt["m"]["a"] is o["m"]["a"] and st2.params["norm"] == {}
    assert st2.opt["count"] == 3


def test_opt_from_numpy_names_every_misfit():
    jm, jp, tm, _ = _pair("llama3.2-3b")
    jo = jax.tree_util.tree_map(np.asarray, JAdamW(lr=lambda s: 1e-3).init(jp))
    to = opt_from_numpy(jo, tm.cfg, "cpu")
    assert to["count"] == 0 and to["m"]["embed"].dtype == torch.float32
    bad = dict(jo, v=dict(jo["v"], embed=jo["v"]["embed"].astype(np.float16)))
    with pytest.raises(ValueError, match="'v'.*embed: float16"):
        opt_from_numpy(bad, tm.cfg, "cpu")


# ---------------------------------------------------------------- launcher
def test_launcher_trains_on_the_cpu(capsys):
    state = launcher.main(["--arch", "llama3.2-3b", "--smoke", "--steps", "4",
                           "--seq", "32", "--batch", "2", "--log-every", "2",
                           "--device", "cpu"])
    out = capsys.readouterr().out
    assert state.step == 4 and "[train] step 4 loss" in out and "alarms=0" in out


LAUNCH = ["--arch", "llama3.2-3b", "--smoke", "--seq", "32", "--batch", "2",
          "--device", "cpu"]


def test_launcher_injects_and_repairs_corruption(capsys):
    """Flush, a flipped lane in block 0 of the first protected leaf, scrub,
    parity repair in place, a clean rescrub; training goes on.  The
    preemption handler is released on return."""
    before = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGUSR1)
    state = launcher.main(LAUNCH + ["--steps", "4", "--inject-corruption", "2"])
    out = capsys.readouterr().out
    assert "[vilamb] injected corruption: detected=1 repaired=1 unrecoverable=0 " \
           "residual=0" in out
    assert state.step == 4 and "alarms=0" in out
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGUSR1)) == before


def test_launcher_writes_checkpoints_every_k_steps(tmp_path, capsys):
    from repro_torch.ckpt import CheckpointManager
    launcher.main(LAUNCH + ["--steps", "6", "--ckpt-dir", str(tmp_path),
                            "--ckpt-every", "2"])
    mgr = CheckpointManager(tmp_path, device="cpu")
    assert mgr.steps() == [2, 4, 6]
    man = json.loads((tmp_path / "step_4" / "manifest.json").read_text())
    assert man["step"] == 4 and "red/params/embed/checksums" in man["leaves"]


def test_launcher_resumes_bitwise(tmp_path, capsys):
    """Four steps, a checkpoint, then ``--resume`` for four more: the same
    losses and final params as eight uninterrupted steps (the schedule's
    warm-up runs ten steps, so ``--steps`` does not change it here)."""
    def losses(out):
        return [ln for ln in out.splitlines() if ln.startswith("[train] step")]
    whole = launcher.main(LAUNCH + ["--steps", "8", "--log-every", "1"])
    want = losses(capsys.readouterr().out)
    launcher.main(LAUNCH + ["--steps", "4", "--log-every", "1", "--ckpt-dir",
                            str(tmp_path), "--ckpt-every", "4"])
    first = losses(capsys.readouterr().out)
    resumed = launcher.main(LAUNCH + ["--steps", "4", "--log-every", "1", "--ckpt-dir",
                                      str(tmp_path), "--resume"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out
    assert first + losses(out) == want
    assert resumed.step == whole.step == 8
    for n, p in flatten_dict(whole.params).items():
        assert torch.equal(p, flatten_dict(resumed.params)[n]), n


def test_launcher_resume_without_a_checkpoint_starts_fresh(tmp_path, capsys):
    state = launcher.main(LAUNCH + ["--steps", "1", "--ckpt-dir", str(tmp_path),
                                    "--resume"])
    assert state.step == 1 and "resumed" not in capsys.readouterr().out


def test_launcher_drains_on_sigusr1_with_exit_code_42(tmp_path):
    """SIGUSR1 (the preemption test hook) after the handler is installed:
    the launcher flushes, checkpoints and exits 42; the checkpoint restores
    verified."""
    code = (
        "import os, signal\n"
        "from repro_torch.ckpt import failure\n"
        "install = failure.PreemptionHandler.install\n"
        "def preempted(self):\n"
        "    install(self)\n"
        "    os.kill(os.getpid(), signal.SIGUSR1)\n"
        "    return self\n"
        "failure.PreemptionHandler.install = preempted\n"
        "from repro_torch.launch import train\n"
        f"train.main({LAUNCH + ['--steps', '6', '--ckpt-dir', str(tmp_path)]!r})\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 42, out.stderr
    assert "[train] preempted: flushed in" in out.stdout
    assert "checkpointed at step 6" in out.stdout
    from repro_torch.ckpt import CheckpointManager
    mgr = CheckpointManager(tmp_path, device="cpu")
    assert mgr.steps() == [6]
    cfg = get_smoke("llama3.2-3b")
    opt = AdamW(lr=lambda s: 1e-3)
    mp = Model(cfg, torch.device("meta")).init()
    store = ProtectedStore(RedundancyPolicy.single("vilamb"), device="cpu").attach(
        protected_structs(mp, opt.init(mp)))          # the launcher's geometry
    tr = Trainer(model=build_model(cfg, "cpu"), opt=opt, store=store)
    st = mgr.restore_verified(tr.state_struct(), tr.store)
    assert st.step == 6 and mgr.last_restore_report.tried == [(6, "ok")]
