"""The port's models against the JAX package's, on the CPU.

Weights are the reference's own ``Model.init`` carried across with
``params_from_numpy``; prompts and layer inputs are made with numpy from a
seed.  On the JAX side ``use_flash_kernel=True``, so the prefill runs the
Pallas flash kernel in interpret mode (``attention.py:155-161``); on the
port's side the flash wrapper runs its plain version.  Models run in fp32,
where the two agree to ~2e-6 (summation order only): the tolerance is
rtol = atol = 1e-5, and greedy tokens must be equal.  Layer functions are
also checked in bf16, at 1e-2 (one bf16 rounding, at points where XLA
and torch may round differently).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import flatten_dict as jflatten
from repro.configs import get_arch as jget_arch, get_smoke as jget_smoke
from repro.models import attention as jattn, build_model as jbuild, layers as jlayers
from repro_torch.common import flatten_dict
from repro_torch.configs import get_arch, get_smoke, list_archs
from repro_torch.core import ALL
from repro_torch.core.convert import leaves_from_numpy
from repro_torch.models import (attention as tattn, build_model, layers as tlayers,
                                params_from_numpy, params_to_numpy)
from repro_torch.train.train_loop import loss_and_grads

ARCHS = ["llama3.2-3b", "glm4-9b", "olmo-1b", "nemotron-4-15b",
         "qwen3-moe-235b-a22b", "arctic-480b"]
# Served and held against the reference in tests/test_torch_mamba.py and
# tests/test_torch_xlstm.py, which reuse this file's helpers.
RECURRENT_ARCHS = ["jamba-1.5-large-398b", "xlstm-1.3b"]
# Served and trained, and held against the reference, in
# tests/test_torch_encdec.py and tests/test_torch_vlm.py.
MULTIMODAL_ARCHS = ["seamless-m4t-medium", "internvl2-1b"]
RTOL = ATOL = 1e-5
B, S, STEPS = 2, 16, 8


def _close(got, want, tol=ATOL, msg=""):
    np.testing.assert_allclose(torch.as_tensor(got).float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _pair(arch, dtype="float32", **over):
    """(JAX model, its params, port model, the same params) for a smoke arch,
    with ``over`` replacing config fields on both sides."""
    jcfg = dataclasses.replace(jget_smoke(arch), param_dtype=dtype,
                               use_flash_kernel=True, **over)
    tcfg = dataclasses.replace(get_smoke(arch), param_dtype=dtype, **over)
    jm = jbuild(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))   # one compile, not one per op
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, build_model(tcfg, "cpu"), tp


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """Prefill then STEPS greedy decode steps through both packages."""
    arch = request.param
    jm, jp, tm, tp = _pair(arch)
    tokens = np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    max_len = S + STEPS + 1
    out = {"arch": arch, "jm": jm, "tm": tm}
    jl, jc, jpos = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(tokens)}, max_len)
    with torch.inference_mode():
        tl, tc, tpos = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, max_len)
    out["prefill"] = (jl, jc, jpos, tl.clone(), {s: {k: t.clone() for k, t in c.items()}
                                                for s, c in tc.items()}, tpos)
    dec = jax.jit(jm.decode_step)
    jt = jnp.argmax(jl, -1).astype(jnp.int32)
    tt = torch.argmax(tl, -1).to(torch.int32)
    steps = []
    for i in range(STEPS):
        jl, jc, jt, _ = dec(jp, jc, jt, jpos + i)
        with torch.inference_mode():
            tl, tc, tt = tm.decode_step(tp, tc, tt, tpos + i)
        steps.append((np.asarray(jl), np.asarray(jt), tl.clone(), tt.clone()))
    out["decode"] = steps
    out["final_caches"] = (jc, tc)
    return out


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS + MULTIMODAL_ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(arch, smoke):
    jc = (jget_smoke if smoke else jget_arch)(arch)
    tc = (get_smoke if smoke else get_arch)(arch)
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert (tc.hd, tc.padded_vocab, tc.group_size, tc.n_groups) == \
        (jc.hd, jc.padded_vocab, jc.group_size, jc.n_groups)
    assert [tc.layer_kind(i) for i in range(tc.n_layers)] == \
        [jc.layer_kind(i) for i in range(jc.n_layers)]
    assert [tc.ffn_kind(i) for i in range(tc.n_layers)] == \
        [jc.ffn_kind(i) for i in range(jc.n_layers)]


def test_llama_full_config():
    c = get_arch("llama3.2-3b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.hd, c.d_ff) == \
        (28, 3072, 24, 8, 128, 8192)
    assert (c.vocab_size, c.padded_vocab, c.rope_theta, c.tie_embeddings,
            c.param_dtype) == (128256, 129024, 5e5, True, "bfloat16")
    assert sorted(list_archs()) == sorted(ARCHS + RECURRENT_ARCHS + MULTIMODAL_ARCHS)


@pytest.mark.parametrize("arch", MULTIMODAL_ARCHS)
def test_multimodal_archs_resolve_to_the_reference_config(arch):
    """Both resolve in the port, to the reference's configs (full and
    smoke), and build; an unknown name still raises."""
    for get, jget in ((get_arch, jget_arch), (get_smoke, jget_smoke)):
        c, jc = get(arch), jget(arch)
        assert {f.name: getattr(c, f.name) for f in dataclasses.fields(c)} == \
            {f.name: getattr(jc, f.name) for f in dataclasses.fields(c)}
        assert build_model(c, "meta").cfg is c
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch(arch + "-x")


@pytest.mark.parametrize("arch", ARCHS + MULTIMODAL_ARCHS)
def test_param_tree_matches_reference(arch):
    """Names, shapes and dtypes of Model.init, at the full config."""
    jm = jbuild(jget_arch(arch))
    want = {n: (tuple(a.shape), str(a.dtype)) for n, a in
            jflatten(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))).items()}
    tm = build_model(get_arch(arch), "meta")
    got = {n: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for n, t in flatten_dict(tm.init()).items()}
    assert got == want


def test_params_carry_across_bitwise_in_bf16():
    jm = jbuild(jget_smoke("llama3.2-3b"))
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    cfg = get_smoke("llama3.2-3b")
    tp = params_from_numpy(jp, cfg, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    back = params_to_numpy(tp)
    for n, a in jflatten(jp).items():
        b = flatten_dict(back)[n]
        assert a.dtype == b.dtype, n
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=n)


def test_params_from_numpy_names_every_misfit():
    jm = jbuild(jget_smoke("llama3.2-3b"))
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jp["stack"]["slot_0"]["attn"]["wq"] = jp["stack"]["slot_0"]["attn"]["wq"][:, :-1]
    jp["extra"] = np.zeros(3, np.float32)
    del jp["final_norm"]
    with pytest.raises(ValueError) as e:
        params_from_numpy(jp, get_smoke("llama3.2-3b"), "cpu")
    msg = str(e.value)
    assert "missing final_norm/scale" in msg and "unexpected extra" in msg
    assert "stack/slot_0/attn/wq" in msg


# ------------------------------------------------------------ layers
def _x(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    if dtype == "bfloat16":
        import ml_dtypes
        a = a.astype(ml_dtypes.bfloat16)
    return a, leaves_from_numpy({"x": a}, "cpu")["x"]


LAYER_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    a, t = _x((3, 5, 64), dtype)
    sa, st = _x((64,), "float32", 1)
    sa, st = sa * 0.1, st * 0.1
    got = tlayers.rmsnorm(t, st)
    assert got.dtype == t.dtype
    _close(got, jlayers.rmsnorm(jnp.asarray(a), jnp.asarray(sa)), LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorms_match_reference(dtype):
    a, t = _x((3, 5, 64), dtype, 2)
    sa, st = _x((64,), "float32", 3)
    ba, bt = _x((64,), "float32", 4)
    _close(tlayers.layernorm(t, st, bt),
           jlayers.layernorm(jnp.asarray(a), jnp.asarray(sa), jnp.asarray(ba)),
           LAYER_TOL[dtype])
    _close(tlayers.nonparam_ln(t), jlayers.nonparam_ln(jnp.asarray(a)), LAYER_TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS + MULTIMODAL_ARCHS)
def test_make_norm_matches_reference(arch):
    jcfg, tcfg = jget_smoke(arch), get_smoke(arch)
    jinit, japply = jlayers.make_norm(jcfg)
    tinit, tapply = tlayers.make_norm(tcfg)
    jp = jinit(jax.random.PRNGKey(0), 64)
    tp = tinit(64, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()} == \
        {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tp.items()}
    a, t = _x((2, 7, 64), "float32", 5)
    _close(tapply(tp, t), japply(jp, jnp.asarray(a)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_matches_reference(dtype, theta):
    _close(tlayers.rope_freqs(128, theta), jlayers.rope_freqs(128, theta), 1e-7)
    a, t = _x((2, 9, 3, 32), dtype, 6)
    pos = np.arange(100, 109)[None, :]
    _close(tlayers.apply_rope(t, torch.from_numpy(pos), theta),
           jlayers.apply_rope(jnp.asarray(a), jnp.asarray(pos), theta),
           LAYER_TOL[dtype])


@pytest.mark.parametrize("activation", ["swiglu", "squared_relu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_matches_reference(activation, dtype):
    jcfg = dataclasses.replace(jget_smoke("llama3.2-3b"), activation=activation)
    tcfg = dataclasses.replace(get_smoke("llama3.2-3b"), activation=activation)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = jlayers.ffn_init(jax.random.PRNGKey(1), jcfg, dtype=jdt)
    tp = leaves_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tshapes = tlayers.ffn_init(None, tcfg, device="meta")
    assert {k: tuple(v.shape) for k, v in tshapes.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    a, t = _x((2, 5, 64), dtype, 7)
    _close(tlayers.ffn_apply(tp, t, tcfg), jlayers.ffn_apply(jp, jnp.asarray(a), jcfg),
           LAYER_TOL[dtype])


# ------------------------------------------------------------ attention
def test_causal_attention_matches_reference():
    jcfg = dataclasses.replace(jget_smoke("llama3.2-3b"), use_flash_kernel=True)
    tcfg = get_smoke("llama3.2-3b")
    jp = jattn.attn_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = leaves_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    a, t = _x((2, 32, 64), "float32", 8)
    jy, (jk, jv) = jattn.causal_attention(jp, jnp.asarray(a), jcfg)
    ty, (tk, tv) = tattn.causal_attention(tp, t, tcfg)
    _close(ty, jy)
    _close(tk, jk)
    _close(tv, jv)


def test_decode_attention_matches_reference():
    cfg = get_smoke("glm4-9b")
    jp = jattn.attn_init(jax.random.PRNGKey(3), jget_smoke("glm4-9b"), jnp.float32)
    tp = leaves_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    a, t = _x((2, 1, 64), "float32", 9)
    kc, tkc = _x((24, 2, cfg.n_kv_heads, cfg.hd), "float32", 10)
    vc, tvc = _x((24, 2, cfg.n_kv_heads, cfg.hd), "float32", 11)
    jy, jk, jv = jattn.decode_attention(jp, jnp.asarray(a), jget_smoke("glm4-9b"),
                                        jnp.asarray(kc), jnp.asarray(vc), 13)
    ty = tattn.decode_attention(tp, t, cfg, tkc, tvc, 13)
    _close(ty, jy)
    _close(tkc, jk, msg="the port writes row 13 of the caches in place")
    _close(tvc, jv)


# ------------------------------------------------------------ whole model
def test_prefill_matches_reference(runs):
    jl, jc, jpos, tl, tc, tpos = runs["prefill"]
    assert tpos == jpos == runs.get("pos", S)
    assert tl.shape == (B, runs["tm"].cfg.padded_vocab)
    _close(tl, jl, msg=f"{runs['arch']} prefill logits")
    assert set(tc) == set(jc)
    for slot in jc:
        assert set(tc[slot]) == set(jc[slot]), slot
        for k in jc[slot]:
            assert tuple(tc[slot][k].shape) == jc[slot][k].shape
            assert str(tc[slot][k].dtype).removeprefix("torch.") == str(jc[slot][k].dtype)
            _close(tc[slot][k], jc[slot][k], msg=f"{runs['arch']} {slot}/{k}")


def test_decode_matches_reference(runs):
    for i, (jl, jt, tl, tt) in enumerate(runs["decode"]):
        _close(tl, jl, msg=f"{runs['arch']} decode step {i} logits")
        np.testing.assert_array_equal(tt.numpy(), jt, err_msg=f"step {i} tokens")
    jc, tc = runs["final_caches"]
    for slot in jc:
        for k in jc[slot]:
            _close(tc[slot][k], jc[slot][k], msg=f"{runs['arch']} {slot}/{k} after decode")


def test_dirty_events_decode_match_reference(runs):
    jc, tc = runs["final_caches"]
    for pos in (0, S, S + STEPS):
        jev = runs["jm"].dirty_events_decode(jc, pos)
        tev = runs["tm"].dirty_events_decode(tc, pos)
        assert set(tev) == set(jev)
        for n in jev:
            if isinstance(jev[n], str):            # the reference's ALL
                assert tev[n] == ALL, n
                continue
            assert tev[n].dtype == torch.bool
            np.testing.assert_array_equal(tev[n].numpy(), np.asarray(jev[n]), err_msg=n)


def test_build_model_refuses_unported_kinds():
    """The port refuses no kind of model any more: the encoder-decoder
    stack and the vision front end build (a llama smoke config with either
    switched on, its tree the reference's), and a stack of mLSTM and sLSTM
    slots builds and trains (a finite loss and a finite gradient for every
    leaf; held against the reference in
    tests/test_torch_recurrent_train.py)."""
    for kind in (dict(enc_dec=True), dict(frontend="vision", frontend_len=4)):
        cfg = dataclasses.replace(get_smoke("llama3.2-3b"), **kind)
        want = jax.eval_shape(lambda: jbuild(dataclasses.replace(
            jget_smoke("llama3.2-3b"), **kind)).init(jax.random.PRNGKey(0)))
        got = build_model(cfg, "meta").init()
        assert set(flatten_dict(got)) == set(jflatten(want)), kind
    xlstm = dataclasses.replace(get_smoke("llama3.2-3b"), ssm_kind="xlstm",
                                slstm_every=2, n_layers=4, param_dtype="float32")
    model = build_model(xlstm, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "labels": torch.zeros((1, 4), dtype=torch.int32)}
    loss, _, grads = loss_and_grads(model, params, batch)
    assert bool(torch.isfinite(loss))
    assert set(grads) == set(flatten_dict(params))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


def test_build_model_defaults_to_the_card():
    if torch.cuda.is_available():
        assert build_model(get_smoke("llama3.2-3b")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(get_smoke("llama3.2-3b"))
