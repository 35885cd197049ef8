"""The port's Mamba mixer and jamba serving against the JAX package's, on the CPU.

Layer functions take numpy inputs from a seed on both sides; the model
tests take the reference's own weights (``params_from_numpy``).  jamba
runs at one group (8 layers: Mamba at slots 0-3 and 5-7, attention at 4,
MoE FFNs at the odd slots), fp32 at rtol = atol = 1e-5 and greedy tokens
equal; layer functions also in bf16 at 1e-2, as tests/test_torch_models.py
states.  The associative scan combines in the reference's tree order, so
its fp32 result is bitwise the reference's.  The store's state under
jamba's caches (the KV cache and every Mamba ``h`` and ``conv``, ALL-dirty
each step) equals the reference's bit for bit, tick by tick, on the
blocking and the overlapped tick (``_torch_recurrent``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_recurrent as rec_mod
import test_torch_models as tmod
from repro.configs import get_smoke as jget_smoke
from repro.models import mamba as jmamba
from repro_torch.configs import get_smoke
from repro_torch.core.convert import leaves_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.models import mamba as tmamba

ARCH = "jamba-1.5-large-398b"
GROUP = dict(n_layers=8)             # one group
_close, _x, LAYER_TOL = tmod._close, tmod._x, tmod.LAYER_TOL


def _cfgs(**over):
    return jget_smoke(ARCH), dataclasses.replace(get_smoke(ARCH), **over)


@functools.lru_cache(maxsize=None)
def _jparams(dtype):
    jcfg, _ = _cfgs()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jmamba.mamba_init(k, jcfg, jdt))(jax.random.PRNGKey(4)))


def _params(dtype):
    """The reference's mamba_init at the smoke widths, on both sides."""
    jp = _jparams(dtype)
    return jp, leaves_from_numpy(jp, "cpu")


def _japply(jcfg, chunk):
    """The reference's mamba_apply, compiled (one compile, not one per op)."""
    return jax.jit(lambda p, x: jmamba.mamba_apply(p, x, jcfg, chunk=chunk))


# ------------------------------------------------------------ layers
def test_mamba_init_matches_reference():
    """Names, shapes and dtypes, with the stack's group axis; the
    deterministic fp32 leaves equal the reference's."""
    jcfg, tcfg = _cfgs()
    jp = _jparams("bfloat16")
    tp = tmamba.mamba_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16,
                           lead=(3,))
    assert {k: ((3,) + tuple(v.shape), str(v.dtype)) for k, v in jp.items()} == \
        {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tp.items()}
    for k in ("dt_bias", "A_log", "D", "conv_b"):
        for g in range(3):
            _close(tp[k][g], jp[k], 1e-7, msg=k)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_associative_scan_is_the_reference_bitwise(n):
    """Against the reference run op by op (eager), so that each product
    and sum rounds on its own as the port's do: equal bits mean the same
    tree order.  (Compiled, XLA may contract a product and a sum into one
    rounding.)  Decay factors in (0.9, 1) as ``exp(dt * A)`` gives them, so
    products of 128 stay normal: XLA flushes subnormals to zero and torch
    does not."""
    a = np.random.default_rng(20).uniform(0.9, 1.0, (2, n, 3, 4)).astype(np.float32)
    ta = torch.from_numpy(a)
    b, tb = _x((2, n, 3, 4), "float32", 21)
    got = tmamba.associative_scan(tmamba._combine, (ta, tb), dim=1)
    want = jax.lax.associative_scan(lambda x, y: (x[0] * y[0], x[1] * y[0] + y[1]),
                                    (jnp.asarray(a), jnp.asarray(b)), axis=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_associative_scan_over_a_chunk_matches_reference():
    """A whole chunk (128), against the compiled reference."""
    a = np.random.default_rng(22).uniform(0.9, 1.0, (2, 128, 3, 4)).astype(np.float32)
    b, tb = _x((2, 128, 3, 4), "float32", 23)
    got = tmamba.associative_scan(tmamba._combine, (torch.from_numpy(a), tb), dim=1)
    want = jax.jit(lambda e: jax.lax.associative_scan(
        lambda x, y: (x[0] * y[0], x[1] * y[0] + y[1]), e, axis=1))(
            (jnp.asarray(a), jnp.asarray(b)))
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_chunk_matches_reference(dtype):
    jp, tp = _params(dtype)
    a, t = _x((2, 7, 128), dtype, 22)
    sa, st = _x((2, 3, 128), dtype, 23)
    got, gst = tmamba._causal_conv_chunk(t, st, tp["conv_w"], tp["conv_b"])
    want, wst = jax.jit(jmamba._causal_conv_chunk)(
        jnp.asarray(a), jnp.asarray(sa), jnp.asarray(jp["conv_w"]), jnp.asarray(jp["conv_b"]))
    _close(got, want, LAYER_TOL[dtype])
    np.testing.assert_array_equal(gst.float().numpy(), np.asarray(wst, np.float32))


@pytest.mark.parametrize("n", [1, 7, 128])
def test_ssm_chunk_matches_reference(n):
    rng = np.random.default_rng(n)
    xc, dt = rng.standard_normal((2, n, 128)), rng.uniform(1e-3, 0.2, (2, n, 128))
    Bc, Cc = rng.standard_normal((2, n, 16)), rng.standard_normal((2, n, 16))
    A = -np.tile(np.arange(1, 17), (128, 1)) * rng.uniform(0.5, 1.5, (128, 16))
    D, h0 = rng.standard_normal(128), rng.standard_normal((2, 128, 16))
    args = [np.asarray(v, np.float32) for v in (xc, dt, Bc, Cc, A, D, h0)]
    gy, gh = tmamba._ssm_chunk(*map(torch.from_numpy, args))
    wy, wh = jax.jit(jmamba._ssm_chunk)(*map(jnp.asarray, args))
    _close(gy, wy)
    _close(gh, wh)


@pytest.mark.parametrize("S,chunk", [(1, 128), (7, 128), (128, 128), (256, 128), (24, 8)])
def test_mamba_apply_matches_reference(S, chunk):
    jcfg, tcfg = _cfgs()
    jp, tp = _params("float32")
    a, t = _x((2, S, 64), "float32", 24)
    got, gst = tmamba.mamba_apply(tp, t, tcfg, chunk=chunk)
    want, wst = _japply(jcfg, chunk)(jp, jnp.asarray(a))
    _close(got, want)
    for k in ("h", "conv"):
        assert gst[k].dtype == torch.float32
        _close(gst[k], wst[k], msg=k)


def test_mamba_apply_matches_reference_bf16():
    jcfg, tcfg = _cfgs()
    jp, tp = _params("bfloat16")
    a, t = _x((2, 24, 64), "bfloat16", 25)
    got, gst = tmamba.mamba_apply(tp, t, tcfg, chunk=8)
    want, wst = _japply(jcfg, 8)(jp, jnp.asarray(a))
    assert got.dtype == gst["conv"].dtype == torch.bfloat16
    _close(got, want, LAYER_TOL["bfloat16"])
    _close(gst["h"], wst["h"], LAYER_TOL["bfloat16"])


def test_mamba_apply_keeps_the_reference_chunk_check():
    _, tcfg = _cfgs()
    _, tp = _params("float32")
    with pytest.raises(ValueError, match="not a whole number of chunks of 128"):
        tmamba.mamba_apply(tp, torch.zeros((1, 200, 64)), tcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_step_matches_reference_in_place(dtype):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(dtype)
    a, t = _x((2, 1, 64), dtype, 26)
    ha, ht = _x((2, 128, 16), "float32", 27)
    ca, ct = _x((2, 3, 128), dtype, 28)
    cache = {"h": ht, "conv": ct}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    got = tmamba.mamba_decode_step(tp, t, tcfg, cache)
    want, wst = jax.jit(lambda p, x, c: jmamba.mamba_decode_step(p, x, jcfg, c))(
        jp, jnp.asarray(a), {"h": jnp.asarray(ha), "conv": jnp.asarray(ca)})
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    _close(got, want, LAYER_TOL[dtype])
    for k in ("h", "conv"):
        _close(cache[k], wst[k], LAYER_TOL[dtype], msg=f"{k} written in place")


# ------------------------------------------------------------ jamba
@pytest.fixture(scope="module")
def pair():
    return tmod._pair(ARCH, **GROUP)


@pytest.fixture(scope="module")
def generated(pair):
    jm, jp, tm, _ = pair
    tokens = rec_mod.prompt(tm.cfg)
    return tokens, rec_mod.reference_generate(jm, jp, tokens)


@pytest.fixture(scope="module")
def runs(pair, generated):
    jm, _, tm, tp = pair
    return rec_mod.port_runs(ARCH, jm, tm, tp, *generated)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    tmod.test_config_matches_reference(ARCH, smoke)
    cfg = get_smoke(ARCH) if smoke else tmod.get_arch(ARCH)
    assert (cfg.group_size, cfg.d_inner, cfg.dt_rank) == \
        ((8, 128, 4) if smoke else (8, 16384, 512))


def test_param_tree_matches_reference():
    tmod.test_param_tree_matches_reference(ARCH)


def test_prefill_matches_reference(runs):
    tmod.test_prefill_matches_reference(runs)


def test_decode_matches_reference(runs):
    tmod.test_decode_matches_reference(runs)


def test_dirty_events_decode_mark_every_state_all(runs):
    tmod.test_dirty_events_decode_match_reference(runs)
    ev = runs["tm"].dirty_events_decode(runs["final_caches"][1], tmod.S + 2)
    assert {n for n, e in ev.items() if isinstance(e, str)} == \
        {f"slot_{s}/{k}" for s in (0, 1, 2, 3, 5, 6, 7) for k in ("h", "conv")}


def test_decode_equals_prefill():
    rec_mod.check_decode_equals_prefill(dataclasses.replace(get_smoke(ARCH), **GROUP))


@pytest.mark.parametrize("async_tick", [False, True], ids=["blocking", "overlapped"])
def test_generate_matches_reference(pair, generated, async_tick):
    _, _, tm, tp = pair
    tokens, rec = generated
    rec_mod.check_generate(tm, tp, tokens, rec, async_tick)


@pytest.mark.parametrize("async_tick", [False, True], ids=["blocking", "overlapped"])
def test_store_matches_reference_tick_by_tick(pair, generated, async_tick):
    jm, _, tm, _ = pair
    rec_mod.replay_store(jm, tm, generated[1], async_tick)


def test_launcher_runs_on_the_cpu(capsys):
    tokens, stats = launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                                   "--batch", "2", "--prompt-len", "8", "--gen", "6",
                                   "--scrub-every", "2", "--period", "2"])
    assert "scrub mismatches=0" in capsys.readouterr().out
    assert tuple(tokens.shape) == (2, 6) and stats["mismatches"] == 0
