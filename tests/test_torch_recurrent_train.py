"""Training through the port's recurrent mixers against the JAX package's, on the CPU.

The Mamba, mLSTM and sLSTM mixers alone (B 2, S 32, chunk 8, d 64, fp32:
four chunks, each checkpointed), the jamba smoke cut to one group at S 256
(two Mamba chunks of 128) and the xLSTM smoke at S 512 (two chunks of
256), four ``Trainer`` steps of the xLSTM smoke, and the training
launcher on the xLSTM smoke (jamba's smoke trains through ``Trainer.run``
on the card, in ``chip_smoke.py``).  Inputs and cotangents are made with numpy from a seed; weights
are drawn by one package's init from a seed and handed to both as numpy
copies.  Tolerances are
``tests/test_torch_train.py``'s: a mixer's value and VJP rtol = atol =
1e-5 (gradients scaled by their leaf's largest entry where it exceeds 1);
a stack's loss rtol 1e-5 and every gradient within 1e-4 of its leaf's max
|g|; after each of four ``Trainer`` steps, each from the reference's
state, the loss rtol 1e-5, params atol 1e-4, moments within 1e-4 (``m``)
and 2e-4 (``v``) of each leaf's max.  Within the port the per-chunk checkpoints,
alone and nested in the per-slot ones, change no gradient bit.

The normaliser ``max(|n|, 1)`` splits its gradient at an exact tie as
``jnp.maximum`` does (held directly below); no mixer input here reaches a
tie (``test_mixer_inputs_reach_no_normaliser_tie``).  Where the mLSTM's
masked ``exp(b_q - b_k)`` overflows, the reference's gradients are NaN and
the port's finite (a documented difference).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as ttrain
from repro.common import flatten_dict as jflatten
from repro.configs import get_smoke as jget_smoke
from repro.data import SyntheticPipeline as JPipeline
from repro.models import build_model as jbuild, mamba as jmamba, xlstm as jxlstm
from repro.models.config import ShapeConfig as JShape
from repro.optim import AdamW as JAdamW, warmup_cosine as jwarmup_cosine
from repro_torch.common import flatten_dict
from repro_torch.configs import get_smoke
from repro_torch.core.convert import leaves_from_numpy, leaves_to_numpy
from repro_torch.data import SyntheticPipeline
from repro_torch.launch import train as launcher
from repro_torch.models import (Model, ShapeConfig, build_model, layers as tlayers,
                                opt_from_numpy, params_from_numpy, params_to_numpy)
from repro_torch.models import mamba as tmamba, transformer as tfm, xlstm as txlstm
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import Trainer, TrainState
from repro_torch.train.train_loop import loss_and_grads

RTOL = ATOL = 1e-5
B, S, CHUNK = 2, 32, 8
JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-1.3b"
# (arch, reference module, the port's init, the port's apply) of each mixer
MIXERS = {
    "mamba": (JAMBA, jmamba, tmamba.mamba_init, tmamba.mamba_apply),
    "mlstm": (XLSTM, jxlstm, txlstm.mlstm_init, txlstm.mlstm_apply),
    "slstm": (XLSTM, jxlstm, txlstm.slstm_init, txlstm.slstm_apply),
}
# The stacks: the jamba smoke cut to one group (Mamba at slots 0-3 and
# 5-7, attention at 4, MoE FFNs at the odd slots), the xLSTM smoke whole.
STACKS = {JAMBA: dict(n_layers=8, S=256), XLSTM: dict(n_layers=8, S=512)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its ops are small and
    sequential (a scan's chunks, a cell a position), and the tier-1 run
    puts six test processes on the machine's cores, where idle worker
    threads that spin between small ops slow every process down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return a, torch.from_numpy(a.copy())


@functools.lru_cache(maxsize=None)
def _mixer_params(kind):
    """The mixer's parameters at the smoke widths from a seed, as numpy
    (the fp32 gate leaves as the reference makes them)."""
    arch, _, init, _ = MIXERS[kind]
    return leaves_to_numpy(init(torch.Generator().manual_seed(7), get_smoke(arch)))


def _mixer_grads(kind, remat="full", x_seed=40, ct_seed=41, over=None):
    """The port's mixer at (B, S, 64) chunk 8: ``(y, grads of x and every
    param)`` under ``cfg.remat``; zeros for a leaf it does not read (the
    sLSTM's ``wk`` and ``wv``), as under ``jax.vjp``."""
    arch, _, _, apply = MIXERS[kind]
    cfg = dataclasses.replace(get_smoke(arch), remat=remat)
    jp = dict(_mixer_params(kind), **(over or {}))
    names = sorted(jp)
    ws = [leaves_from_numpy({"w": jp[n]}, "cpu")["w"].requires_grad_() for n in names]
    x = _x((B, S, 64), x_seed)[1].requires_grad_()
    y, _ = apply(dict(zip(names, ws)), x, cfg, chunk=CHUNK)
    ct = _x(tuple(y.shape), ct_seed)[1]
    grads = torch.autograd.grad(y, [x] + ws, ct, materialize_grads=True)
    return y.detach(), dict(zip(["x"] + names, grads))


def _mixer_reference(kind, x_seed=40, ct_seed=41, over=None, chunk=CHUNK):
    arch, mod, _, _ = MIXERS[kind]
    jcfg = jget_smoke(arch)
    jp = dict(_mixer_params(kind), **(over or {}))
    names = sorted(jp)
    apply = getattr(mod, f"{kind}_apply")

    def fn(x, *ws):
        return apply(dict(zip(names, ws)), x, jcfg, chunk=chunk)[0]
    x = jnp.asarray(_x((B, S, 64), x_seed)[0])
    y, vjp = jax.vjp(jax.jit(fn), x, *[jnp.array(jp[n]) for n in names])
    grads = vjp(jnp.asarray(_x(tuple(y.shape), ct_seed)[0]))
    return y, dict(zip(["x"] + names, grads))


# ------------------------------------------------------------ mixers
@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_mixer_value_and_vjp_match_reference(kind):
    """Each mixer's output and the VJP of x and of every parameter (the
    fp32 gate leaves included) against ``jax.vjp`` of the reference."""
    ty, tg = _mixer_grads(kind)
    jy, jg = _mixer_reference(kind)
    ttrain._close(ty, jy, ATOL)
    assert set(tg) == set(jg)
    for n, g in tg.items():
        want = np.asarray(jg[n], np.float32)
        assert g.dtype == torch.float32, n
        ttrain._close(g, want, ATOL * max(1.0, float(np.abs(want).max())), n)


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_chunk_checkpoint_changes_no_gradient_bit(kind, monkeypatch):
    """Every chunk runs under a checkpoint where autograd records (four
    here), none with ``remat="none"`` and none outside grad mode (the
    prefill's path); the gradients are the same bits either way."""
    calls = []
    real = tlayers.checkpoint

    def counted(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(tlayers, "checkpoint", counted)
    y_full, full = _mixer_grads(kind, "full")
    assert len(calls) == S // CHUNK
    assert all(kw == {"use_reentrant": False, "preserve_rng_state": False} for kw in calls)
    y_none, none = _mixer_grads(kind, "none")
    assert len(calls) == S // CHUNK
    assert torch.equal(y_full, y_none)
    for n, g in full.items():
        assert torch.equal(g, none[n]), n
    arch, _, _, apply = MIXERS[kind]
    with torch.no_grad():
        apply(leaves_from_numpy(_mixer_params(kind), "cpu"), torch.zeros(B, S, 64),
              get_smoke(arch), chunk=CHUNK)
    assert len(calls) == S // CHUNK


def test_normaliser_splits_the_gradient_at_a_tie():
    """``max(|n|, 1)`` at an exact tie passes half the gradient, as
    ``jnp.maximum`` does (``clamp_min`` would pass all of it)."""
    v = np.array([0.5, 1.0, 2.0, -1.0], np.float32)
    t = torch.from_numpy(v).requires_grad_()
    (tg,) = torch.autograd.grad(txlstm._normaliser(t.abs()).sum(), t)
    jg = jax.grad(lambda a: jnp.maximum(jnp.abs(a), 1.0).sum())(jnp.asarray(v))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tg.numpy(), [0.0, 0.5, 1.0, -0.5])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_inputs_reach_no_normaliser_tie(kind, monkeypatch):
    """The normaliser's inputs in the VJP tests above: none is exactly 1,
    so the tie rule is not what they compare."""
    seen = []
    real = txlstm._normaliser

    def spy(nq):
        seen.append(nq.detach().clone())
        return real(nq)
    monkeypatch.setattr(txlstm, "_normaliser", spy)
    _mixer_grads(kind)
    assert seen and not any(bool((t == 1.0).any()) for t in seen)


def test_mlstm_masked_overflow_is_finite_where_the_reference_gives_nan():
    """A documented difference (ROADMAP.md Queue 3).  Forget gates near 0
    (``f_bias`` -100) make the masked half's ``exp(b_q - b_k)`` overflow at
    chunk 8.  The reference exponentiates it and masks after, so its
    backward multiplies a zero cotangent by inf: NaN in the gradients of x
    and the gate leaves.  The port zeroes that exponent before ``exp``: the
    same output, and finite gradients equal to the reference's at chunk 2,
    where nothing overflows (the chunkwise form is the same function at any
    chunk), within the tolerance above."""
    over = {"f_bias": np.full((4,), -100.0, np.float32)}
    ty, tg = _mixer_grads("mlstm", over=over)
    jy, jg = _mixer_reference("mlstm", over=over)
    ttrain._close(ty, jy, ATOL)
    nan = {n for n, g in jg.items() if bool(np.isnan(np.asarray(g)).any())}
    assert {"x", "wf", "f_bias", "wi"} <= nan
    _, jg2 = _mixer_reference("mlstm", over=over, chunk=2)
    for n, g in tg.items():
        want = np.asarray(jg2[n], np.float32)
        assert bool(torch.isfinite(g).all()) and np.isfinite(want).all(), n
        ttrain._close(g, want, ATOL * max(1.0, float(np.abs(want).max())), n)
        if n not in nan:
            ttrain._close(g, jg[n], ATOL * max(1.0, float(np.abs(want).max())), n)


# ------------------------------------------------------------ stacks
@functools.lru_cache(maxsize=None)
def _stack_pair(arch):
    """(JAX model, its params, its compiled ``value_and_grad`` of the loss,
    port model, the same params), fp32.  xLSTM's weights are the
    reference's ``init(PRNGKey(0))`` (the trainer test starts there);
    jamba's are drawn by the port's init from a seed (the reference's init
    takes ~9 s to compile at this size).  Either way both packages get
    numpy copies."""
    jcfg, tcfg = ttrain._cfgs(arch, n_layers=STACKS[arch]["n_layers"])
    jm, tm = jbuild(jcfg), build_model(tcfg, "cpu")
    if arch == XLSTM:
        weights = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    else:
        weights = params_to_numpy(tm.init(torch.Generator().manual_seed(0)))
    jp = jax.tree_util.tree_map(jnp.array, weights)
    return (jm, jp, jax.jit(jax.value_and_grad(jm.loss, has_aux=True)), tm,
            params_from_numpy(weights, tcfg, "cpu"))


@functools.lru_cache(maxsize=None)
def _stack_runs(arch):
    """The loss, aux and gradients of both packages at (1, S)."""
    jm, jp, jgrad, tm, tp = _stack_pair(arch)
    jb, tb = ttrain._batch(tm.cfg, B=1, S=STACKS[arch]["S"], seed=3)
    (jl, jaux), jg = jgrad(jp, jb)
    return (jb, jl, jaux, jg), (tb, loss_and_grads(tm, tp, tb))


@pytest.mark.parametrize("arch", sorted(STACKS))
def test_stack_loss_and_grads_match_reference(arch):
    """``Model.loss`` through every Mamba, attention and MoE slot of one
    jamba group, or through xLSTM's mLSTM and sLSTM slots, across chunk
    boundaries, and every leaf's gradient, against the reference's."""
    (_, jl, jaux, jg), (_, (tl, taux, tg)) = _stack_runs(arch)
    tm, tp = _stack_pair(arch)[3:]
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    for k in ("ce", "aux_loss", "logits_mean"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=RTOL, err_msg=k)
    np.testing.assert_array_equal(taux["expert_counts"].numpy(),
                                  np.asarray(jaux["expert_counts"]))
    ttrain._grads_close(tg, jg, arch)
    kinds = {m for m, _ in tfm.slot_kinds(tm.cfg)}
    assert kinds == ({"mamba", "attn"} if arch == JAMBA else {"mlstm", "slstm"})
    assert all(not p.requires_grad for p in flatten_dict(tp).values())


@pytest.mark.parametrize("arch", sorted(STACKS))
def test_nested_checkpoints_change_no_gradient_bit(arch):
    """The per-chunk checkpoints nested in the per-slot ones, against the
    whole stack without either (``remat="none"``): the same loss and
    gradients, bit for bit."""
    _, (tb, (tl, _, tg)) = _stack_runs(arch)
    tm, tp = _stack_pair(arch)[3:]
    assert tm.cfg.remat == "full"
    nl, _, ng = loss_and_grads(Model(dataclasses.replace(tm.cfg, remat="none"),
                                     tm.device), tp, tb)
    assert torch.equal(tl, nl)
    for n, g in tg.items():
        assert torch.equal(g, ng[n]), n


@pytest.mark.parametrize("arch", sorted(STACKS))
def test_dirty_events_train_match_reference(arch):
    """From each package's own loss: the embedding rows and, for jamba,
    the expert slabs its tokens reached; every Mamba, mLSTM and sLSTM leaf
    is left to the train loop's ALL, in both."""
    (jb, _, jaux, _), (tb, (_, taux, _)) = _stack_runs(arch)
    jm, tm = _stack_pair(arch)[0], _stack_pair(arch)[3]
    jev = jm.dirty_events_train(jb, jaux)
    tev = tm.dirty_events_train(tb, taux)
    assert set(jev) == set(tev)
    assert set(tev) == ({"embed"} if arch == XLSTM else
                        {"embed"} | {f"stack/slot_{s}/moe/{w}" for s in (1, 3, 5, 7)
                                     for w in ("wi", "wg", "wo")})
    for n in jev:
        np.testing.assert_array_equal(tev[n].numpy(), np.asarray(jev[n]), err_msg=n)


# ------------------------------------------------------------ Trainer
KINK_MARGIN = 1e-5


def test_four_xlstm_trainer_steps_match_reference(monkeypatch):
    """Four ``Trainer.run`` steps of the xLSTM smoke at (1, 512), two
    chunks, from the reference's own init (``PRNGKey(0)``), lr 1e-3 with
    warmup, against the reference's train step without a store (its
    ``value_and_grad`` of the loss, ``dirty_events_train``'s row masks and
    ``AdamW.update``, as its ``make_train_step`` composes them).

    Each port step starts from the reference's state before it (params,
    moments, count and step): two fp32 runs of this model part within a
    few steps, and ``max(|n q|, 1)`` decides its branch by rounding where
    ``|n q|`` lies within rounding of 1 (``tests/_recurrent_grad_precision.py``).
    So the test also holds every normaliser input of the port's steps
    farther than 1e-5 from that kink.  After each step: the loss rtol
    1e-5, params atol 1e-4, ``m`` within 1e-4 and ``v`` within 2e-4 of each
    leaf's max: the stack's gradient tolerance carried through the moments
    (either package's fp32 gradients lie up to ~5e-5 of their leaf's max
    from the float64 gradient here).  The fp32 gate leaves and the sLSTM's
    unread ``wk``/``wv`` (zero gradients: only the decay moves them)
    included."""
    jm, params, jgrad, tm, _ = _stack_pair(XLSTM)
    S = STACKS[XLSTM]["S"]
    margins = []
    real = txlstm._normaliser

    def spy(nq):
        margins.append(float((nq.detach().abs() - 1).abs().min()))
        return real(nq)
    monkeypatch.setattr(txlstm, "_normaliser", spy)
    jopt = JAdamW(lr=jwarmup_cosine(1e-3, 5, 100))
    update = jax.jit(jopt.update)
    jd = JPipeline(jm.cfg, JShape("t", S, 1, "train"), seed=0)
    td = SyntheticPipeline(tm.cfg, ShapeConfig("t", S, 1, "train"), seed=0, device="cpu")
    trainer = Trainer(model=tm, opt=AdamW(lr=warmup_cosine(1e-3, 5, 100)))
    opt = jopt.init(params)
    for step in range(4):
        state = TrainState(
            params=params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tm.cfg, "cpu"),
            opt=opt_from_numpy(jax.tree_util.tree_map(np.asarray, opt), tm.cfg, "cpu"),
            red={}, step=step)
        batch = jd.get(step)
        (loss, aux), grads = jgrad(params, batch)
        masks = {k: v for k, v in jm.dirty_events_train(batch, aux).items()
                 if not isinstance(v, str)}
        params, opt, _ = update(grads, opt, params, masks)
        tl = []
        state = trainer.run(state, td, 1, on_step=lambda s, m: tl.append(float(m["loss"])))
        assert state.step == step + 1 and state.opt["count"] == int(opt["count"]) == step + 1
        assert min(margins) > KINK_MARGIN, (step, min(margins))
        np.testing.assert_allclose(tl, [float(loss)], rtol=RTOL, err_msg=f"step {step}")
        jf = jflatten({"params": params, "m": opt["m"], "v": opt["v"]})
        tf = flatten_dict({"params": state.params, "m": state.opt["m"],
                           "v": state.opt["v"]})
        assert set(jf) == set(tf)
        for n, t in tf.items():
            want = np.asarray(jf[n], np.float32)
            atol = (1e-4 if n.startswith("params/") else
                    (1e-4 if n.startswith("m/") else 2e-4) * float(np.abs(want).max()))
            np.testing.assert_allclose(t.numpy(), want, rtol=0, atol=atol,
                                       err_msg=f"step {step} {n}")
    assert state.params["stack"]["slot_7"]["slstm"]["wi"].dtype == torch.float32
    assert not state.opt["m"]["stack"]["slot_7"]["slstm"]["wk"].any()


# ------------------------------------------------------------ launcher
def test_launcher_trains_on_the_cpu(capsys):
    state = launcher.main(["--arch", XLSTM, "--smoke", "--device", "cpu", "--steps", "2",
                           "--seq", "32", "--batch", "2", "--log-every", "1"])
    out = capsys.readouterr().out
    assert state.step == 2 and "[train] step 2 loss" in out and "alarms=0" in out
