"""seamless-m4t-medium's encoder-decoder stack in the port against the JAX
package, on the CPU.

The smoke config (2 encoder and 2 decoder layers, d 64, 4 heads of 16,
layernorm and gelu) in fp32 with the reference's own weights carried
across.  The encoder reads ENC_LEN = 24 frames beside a 16-token prompt,
so every cross attention has a key length other than its queries'; its
caches ``ck``/``cv`` are written once by the prefill and never marked
dirty.  The reference's full attention is one unmasked tile; the port's
prefill takes the flash kernel's plain version with ``causal=False``.
Tolerances: fp32 values at rtol = atol = 1e-5 (summation order only),
losses at rtol 1e-5, gradients at 1e-4 of each leaf's largest |g|; the
layer functions also in bf16 at 1e-2 (one rounding, at points where XLA
and torch may round differently); tokens, batches and every redundancy
field bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_multimodal as mm
import _torch_recurrent as rec_mod
import test_torch_models as tmod
from repro.configs import get_smoke as jget_smoke
from repro.models import attention as jattn
from repro_torch.common import flatten_dict
from repro_torch.configs import get_arch, get_smoke
from repro_torch.core.convert import leaves_from_numpy
from repro_torch.launch import serve as launcher, train as train_launcher
from repro_torch.models import attention as tattn

ARCH = "seamless-m4t-medium"


@pytest.fixture(scope="module")
def pair():
    return tmod._pair(ARCH)


@pytest.fixture(scope="module")
def generated(pair):
    jm, jp, tm, _ = pair
    batch = rec_mod.inputs(tm.cfg)
    return batch, rec_mod.reference_generate(jm, jp, batch)


@pytest.fixture(scope="module")
def runs(pair, generated):
    jm, _, tm, tp = pair
    return rec_mod.port_runs(ARCH, jm, tm, tp, *generated)


def test_full_config():
    c = get_arch(ARCH)
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.hd, c.d_ff) == \
        (12, 1024, 16, 16, 64, 4096)
    assert (c.vocab_size, c.padded_vocab, c.norm, c.activation, c.enc_dec,
            c.frontend) == (256206, 258048, "layernorm", "gelu", True, "audio")


# ------------------------------------------------------------ attention
def _attn(dtype, seed=2):
    jcfg, tcfg = jget_smoke(ARCH), get_smoke(ARCH)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = jattn.attn_init(jax.random.PRNGKey(seed), jcfg, jdt)
    return jcfg, tcfg, jp, leaves_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cross,rope", [(False, True), (False, False), (True, False),
                                        (True, True)])
def test_full_attention_matches_reference(dtype, cross, rope):
    """Self attention (``kv_x`` None) and cross attention over 24 memory
    rows, with and without RoPE: the training path and, in fp32, the
    prefill's kernel path equal the reference's one unmasked tile.  (In
    bf16 the reference's tile rounds the scores to bf16 before its fp32
    softmax and the kernel keeps them fp32, as the TPU kernel does.)"""
    jcfg, tcfg, jp, tp = _attn(dtype)
    a, t = tmod._x((2, 16, 64), dtype, 8)
    m, tm = tmod._x((2, 24, 64), dtype, 9)
    kv = dict(kv_x=jnp.asarray(m)) if cross else {}
    jy, (jk, jv) = jattn.full_attention(jp, jnp.asarray(a), jcfg, rope=rope, **kv)
    tol = tmod.LAYER_TOL[dtype]
    for train in (False, True) if dtype == "float32" else (True,):
        ty, (tk, tv) = tattn.full_attention(tp, t, tcfg, kv_x=tm if cross else None,
                                            rope=rope, train=train)
        assert tuple(tk.shape) == (2, 24 if cross else 16, tcfg.n_kv_heads, tcfg.hd)
        tmod._close(ty, jy, tol, msg=f"train={train}")
        tmod._close(tk, jk, tol)
        tmod._close(tv, jv, tol)


def test_cross_decode_attention_matches_reference_and_writes_nothing():
    jcfg, tcfg, jp, tp = _attn("float32", 3)
    a, t = tmod._x((2, 1, 64), "float32", 10)
    kc, tkc = tmod._x((24, 2, tcfg.n_kv_heads, tcfg.hd), "float32", 11)
    vc, tvc = tmod._x((24, 2, tcfg.n_kv_heads, tcfg.hd), "float32", 12)
    before = (tkc.clone(), tvc.clone())
    jy, _, _ = jattn.decode_attention(jp, jnp.asarray(a), jcfg, jnp.asarray(kc),
                                      jnp.asarray(vc), 5, rope=False, cross=True)
    ty = tattn.decode_attention(tp, t, tcfg, tkc, tvc, 5, rope=False, cross=True)
    tmod._close(ty, jy)
    assert torch.equal(tkc, before[0]) and torch.equal(tvc, before[1])


def test_encode_matches_reference(pair):
    jm, jp, tm, tp = pair
    frames = rec_mod.inputs(tm.cfg)["enc_input"]
    want = jax.jit(jm._encode)(jp, jnp.asarray(frames))
    with torch.inference_mode():
        got = tm._encode(tp, torch.from_numpy(frames))
    assert tuple(got.shape) == frames.shape
    tmod._close(got, want)
    assert set(tp) == set(jp) and {"enc_stack", "enc_final_norm"} <= set(tp)
    assert {"cross", "cross_norm"} <= set(tp["stack"]["slot_0"])


# ------------------------------------------------------------ serving
def test_prefill_matches_reference(runs):
    """Logits and every cache, the cross attention's ``ck``/``cv`` of 24
    encoder rows included."""
    tc = runs["prefill"][4]
    assert tuple(tc["slot_0"]["ck"].shape) == (2, rec_mod.ENC_LEN, rec_mod.B, 4, 16)
    tmod.test_prefill_matches_reference(runs)


def test_decode_matches_reference(runs):
    tmod.test_decode_matches_reference(runs)
    jl, jc, jpos, tl, tc, tpos = runs["prefill"]
    final = runs["final_caches"][1]
    for k in ("ck", "cv"):
        assert torch.equal(final["slot_0"][k], tc["slot_0"][k]), f"decode wrote {k}"


def test_dirty_events_decode_match_reference(runs):
    """The same events as the reference's: k and v a row each, ck and cv
    none."""
    tmod.test_dirty_events_decode_match_reference(runs)
    ev = runs["tm"].dirty_events_decode(runs["final_caches"][1], rec_mod.S + 2)
    assert set(ev) == {"slot_0/k", "slot_0/v"}


def test_decode_equals_prefill():
    rec_mod.check_decode_equals_prefill(get_smoke(ARCH))


@pytest.mark.parametrize("async_tick", [False, True], ids=["blocking", "overlapped"])
def test_generate_matches_reference(pair, generated, async_tick):
    _, _, tm, tp = pair
    rec_mod.check_generate(tm, tp, *generated, async_tick)


def test_generate_without_a_store_matches_reference(pair, generated):
    mm.check_generate_without_store(pair, generated)


@pytest.mark.parametrize("async_tick", [False, True], ids=["blocking", "overlapped"])
def test_store_matches_reference_tick_by_tick(pair, generated, async_tick):
    """Every field bitwise after every write and tick; the cross caches'
    dirty words stay zero throughout (no tick ever updates them)."""
    jm, _, tm, _ = pair
    rec_mod.replay_store(jm, tm, generated[1], async_tick)
    for step, leaves, written, ticked, _ in generated[1]["ticks"]:
        for n in ("slot_0/ck", "slot_0/cv"):
            assert not written[n].dirty.any() and not ticked[n].shadow.any(), (step, n)


# ------------------------------------------------------------ training
@pytest.mark.parametrize("norm_vjp", ["autodiff", "custom"])
def test_loss_and_grads_match_reference(norm_vjp):
    mm.check_loss_and_grads(ARCH, norm_vjp, seq=64)        # 32 frames, 32 tokens


def test_memory_gradient_reaches_the_encoder(pair):
    """With per-slot checkpointing the memory is an explicit input: every
    encoder leaf gets a gradient, equal to one without checkpointing."""
    from repro_torch.train.train_loop import loss_and_grads
    _, _, tm, tp = pair
    batch = mm.pipeline_pair(ARCH, 32)[1].get(0)
    _, _, g = loss_and_grads(tm, tp, batch)
    plain = dataclasses.replace(tm, cfg=dataclasses.replace(tm.cfg, remat="none"))
    _, _, g0 = loss_and_grads(plain, tp, batch)
    enc = [n for n in g if n.startswith("enc_stack/")]
    assert enc and all(float(g[n].abs().max()) > 0 for n in enc)
    for n in g:
        assert torch.equal(g[n], g0[n]), n


def test_batches_equal_the_reference_bitwise():
    mm.check_batches(ARCH, 64, ("enc_input", "tokens", "labels"))


# ------------------------------------------------------------ launchers
def test_launcher_runs_on_the_cpu(capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen", "6"]
    tokens, stats = launcher.main(argv + ["--scrub-every", "2", "--period", "2"])
    assert "scrub mismatches=0" in capsys.readouterr().out
    assert tuple(tokens.shape) == (2, 6) and stats["mismatches"] == 0
    assert tuple(flatten_dict(stats["caches"])["slot_0/ck"].shape)[:2] == (2, 8)
    bare, _ = launcher.main(argv + ["--redundancy", "none"])
    np.testing.assert_array_equal(tokens.numpy(), bare.numpy())


def test_train_launcher_runs_on_the_cpu(capsys):
    state = train_launcher.main(["--arch", ARCH, "--smoke", "--steps", "4", "--seq", "32",
                                 "--batch", "2", "--log-every", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert state.step == 4 and "[train] step 4 loss" in out and "alarms=0" in out
