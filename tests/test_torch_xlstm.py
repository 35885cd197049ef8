"""The port's mLSTM and sLSTM mixers and xlstm serving against the JAX
package's, on the CPU.

Layer functions take numpy inputs from a seed on both sides; the model
tests take the reference's own weights (``params_from_numpy``).  The
xlstm smoke model is one group of 8 layers (mLSTM at slots 0-6, sLSTM at
7, no FFN), fp32 at rtol = atol = 1e-5 and greedy tokens equal; layer
functions also in bf16 at 1e-2, as tests/test_torch_models.py states.
The store's state under xlstm's caches (every ``C``, ``n`` and ``c``,
ALL-dirty each step; sLSTM's ``n`` is smaller than a block, so its lane
view is a padded copy) equals the reference's bit for bit, tick by tick,
on the blocking and the overlapped tick (``_torch_recurrent``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_recurrent as rec_mod
import test_torch_models as tmod
from repro.configs import get_smoke as jget_smoke
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_smoke
from repro_torch.common import flatten_dict
from repro_torch.core import ALL, ProtectedStore, RedundancyPolicy
from repro_torch.core.convert import leaves_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.models import xlstm as txlstm
from repro_torch.serve import Server

ARCH = "xlstm-1.3b"
_close, _x, LAYER_TOL = tmod._close, tmod._x, tmod.LAYER_TOL
H, HD = 4, 16                        # the smoke's heads and head width (d 64)


def _cfgs():
    return jget_smoke(ARCH), get_smoke(ARCH)


@functools.lru_cache(maxsize=None)
def _jparams(dtype):
    jcfg, _ = _cfgs()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jxlstm.mlstm_init(k, jcfg, jdt))(jax.random.PRNGKey(6)))


def _params(dtype):
    """The reference's mlstm_init (slstm_init is the same family) at the
    smoke widths, on both sides."""
    jp = _jparams(dtype)
    return jp, leaves_from_numpy(jp, "cpu")


def _jit(fn, **kw):
    """A reference ``fn(params, x, cfg, [cache])`` compiled with its config
    bound."""
    jcfg, _ = _cfgs()
    return jax.jit(lambda p, x, *cache: fn(p, x, jcfg, *cache, **kw))


# ------------------------------------------------------------ layers
def test_init_matches_reference():
    jcfg, tcfg = _cfgs()
    jp = _jparams("bfloat16")
    assert txlstm.slstm_init is txlstm.mlstm_init
    tp = txlstm.mlstm_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16,
                           lead=(2,))
    assert {k: ((2,) + tuple(v.shape), str(v.dtype)) for k, v in jp.items()} == \
        {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tp.items()}
    np.testing.assert_array_equal(tp["f_bias"].numpy(), np.broadcast_to(jp["f_bias"], (2, H)))


@pytest.mark.parametrize("S,chunk", [(16, 256), (24, 8)], ids=["one_chunk", "three_chunks"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_apply_matches_reference(S, chunk, dtype):
    _, tcfg = _cfgs()
    jp, tp = _params(dtype)
    a, t = _x((2, S, 64), dtype, 30)
    got, gst = txlstm.mlstm_apply(tp, t, tcfg, chunk=chunk)
    want, wst = _jit(jxlstm.mlstm_apply, chunk=chunk)(jp, jnp.asarray(a))
    assert got.dtype == t.dtype
    _close(got, want, LAYER_TOL[dtype])
    for k in ("C", "n"):
        assert gst[k].dtype == torch.float32
        _close(gst[k], wst[k], LAYER_TOL[dtype], msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_decode_step_matches_reference_in_place(dtype):
    _, tcfg = _cfgs()
    jp, tp = _params(dtype)
    a, t = _x((2, 1, 64), dtype, 31)
    Ca, Ct = _x((2, H, HD, HD), "float32", 32)
    na, nt = _x((2, H, HD), "float32", 33)
    cache = {"C": Ct, "n": nt}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    got = txlstm.mlstm_decode_step(tp, t, tcfg, cache)
    want, wst = _jit(jxlstm.mlstm_decode_step)(
        jp, jnp.asarray(a), {"C": jnp.asarray(Ca), "n": jnp.asarray(na)})
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    _close(got, want, LAYER_TOL[dtype])
    for k in ("C", "n"):
        _close(cache[k], wst[k], LAYER_TOL[dtype], msg=f"{k} written in place")


@pytest.mark.parametrize("S,chunk", [(16, 256), (24, 8)], ids=["one_chunk", "three_chunks"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_apply_matches_reference(S, chunk, dtype):
    _, tcfg = _cfgs()
    jp, tp = _params(dtype)
    a, t = _x((2, S, 64), dtype, 34)
    got, gst = txlstm.slstm_apply(tp, t, tcfg, chunk=chunk)
    want, wst = _jit(jxlstm.slstm_apply, chunk=chunk)(jp, jnp.asarray(a))
    _close(got, want, LAYER_TOL[dtype])
    for k in ("c", "n"):
        assert gst[k].dtype == torch.float32
        _close(gst[k], wst[k], LAYER_TOL[dtype], msg=k)


@pytest.mark.parametrize("apply", [txlstm.mlstm_apply, txlstm.slstm_apply])
def test_apply_keeps_the_reference_chunk_check(apply):
    _, tcfg = _cfgs()
    _, tp = _params("float32")
    with pytest.raises(ValueError, match="not a whole number of chunks of 256"):
        apply(tp, torch.zeros((1, 300, 64)), tcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_decode_step_matches_reference_in_place(dtype):
    _, tcfg = _cfgs()
    jp, tp = _params(dtype)
    a, t = _x((2, 1, 64), dtype, 35)
    ca, ct = _x((2, H, HD), "float32", 36)
    na = np.random.default_rng(37).uniform(0.5, 3.0, (2, H)).astype(np.float32)
    cache = {"c": ct, "n": torch.from_numpy(na.copy())}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    got = txlstm.slstm_decode_step(tp, t, tcfg, cache)
    want, wst = _jit(jxlstm.slstm_decode_step)(
        jp, jnp.asarray(a), {"c": jnp.asarray(ca), "n": jnp.asarray(na)})
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    _close(got, want, LAYER_TOL[dtype])
    for k in ("c", "n"):
        _close(cache[k], wst[k], LAYER_TOL[dtype], msg=f"{k} written in place")


# ------------------------------------------------------------ xlstm
@pytest.fixture(scope="module")
def pair():
    return tmod._pair(ARCH)


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
    assert (cfg.group_size, cfg.n_groups) == ((8, 1) if smoke else (8, 6))


def test_param_tree_matches_reference():
    tmod.test_param_tree_matches_reference(ARCH)


def test_prefill_matches_reference(runs):
    tmod.test_prefill_matches_reference(runs)
    tc = runs["prefill"][4]
    assert set(tc["slot_7"]) == {"c", "n"} and tuple(tc["slot_7"]["n"].shape) == (1, 2, H)


def test_decode_matches_reference(runs):
    tmod.test_decode_matches_reference(runs)


def test_dirty_events_decode_mark_every_state_all(runs):
    tmod.test_dirty_events_decode_match_reference(runs)
    ev = runs["tm"].dirty_events_decode(runs["final_caches"][1], tmod.S + 2)
    assert ev == {**{f"slot_{s}/{k}": ALL for s in range(7) for k in ("C", "n")},
                  "slot_7/c": ALL, "slot_7/n": ALL}


def test_init_caches_start_slstm_n_at_1e_6(pair):
    _, _, tm, _ = pair
    caches = tm.init_caches(2, 8)
    assert torch.equal(caches["slot_7"]["n"], torch.full((1, 2, H), 1e-6))
    assert all(not bool(t.any()) for s, c in caches.items() for k, t in c.items()
               if (s, k) != ("slot_7", "n"))
    shapes = tm.cache_shapes(2, 8)
    assert {s: {k: (tuple(t.shape), t.dtype) for k, t in c.items()} for s, c in caches.items()} \
        == {s: {k: (tuple(v.shape), v.dtype) for k, v in c.items()} for s, c in shapes.items()}


def test_decode_equals_prefill():
    rec_mod.check_decode_equals_prefill(get_smoke(ARCH))


@pytest.mark.parametrize("async_tick", [False, True], ids=["blocking", "overlapped"])
def test_generate_matches_reference(pair, generated, async_tick):
    _, _, tm, tp = pair
    tokens, rec = generated
    rec_mod.check_generate(tm, tp, tokens, rec, async_tick)


@pytest.mark.parametrize("async_tick", [False, True], ids=["blocking", "overlapped"])
def test_store_matches_reference_tick_by_tick(pair, generated, async_tick):
    jm, _, tm, _ = pair
    rec_mod.replay_store(jm, tm, generated[1], async_tick)


def test_adopted_repair_of_a_padded_leaf_is_decoded_in_place(pair):
    """sLSTM's ``n`` is smaller than a block, so its lane view is a padded
    copy and ``recover_block`` rebuilds it into a new tensor: the caches
    ``Server._adopt`` hands back hold that tensor, and the next decode step
    writes it in place."""
    _, _, tm, tp = pair
    tokens = torch.from_numpy(rec_mod.prompt(tm.cfg))
    store = ProtectedStore(rec_mod.policy(RedundancyPolicy, False), device="cpu").attach(
        tm.cache_shapes(rec_mod.B, rec_mod.S + 2))
    name = "slot_7/n"
    with torch.inference_mode():
        logits, caches, pos = tm.prefill(tp, {"tokens": tokens}, rec_mod.S + 2)
        leaves = flatten_dict(caches)
        red = store.init(leaves)
        saved = leaves[name].clone()
        leaves[name].view(-1).view(torch.int32)[5] ^= 0xBAD
        assert {n: int(m.sum()) for n, m in store.scrub(leaves, red).items() if m.any()} \
            == {name: 1}
        fixed, ok = store.recover_block(leaves[name], red[name], name, 0)
        assert ok and fixed.data_ptr() != leaves[name].data_ptr()
        assert torch.equal(fixed, saved)
        caches = Server._adopt(caches, {name: fixed})
        assert caches["slot_7"]["n"] is fixed
        tm.decode_step(tp, caches, torch.argmax(logits, -1).to(torch.int32), pos)
    assert caches["slot_7"]["n"] is fixed and not torch.equal(fixed, saved)


def test_launcher_runs_on_the_cpu(capsys):
    tokens, stats = launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                                   "--batch", "2", "--prompt-len", "8", "--gen", "6",
                                   "--scrub-every", "2", "--period", "2"])
    assert "scrub mismatches=0" in capsys.readouterr().out
    assert tuple(tokens.shape) == (2, 6) and stats["mismatches"] == 0
