"""The port's MoE FFN against the JAX package's, on the CPU.

Weights are the reference's ``moe_init`` carried across with
``leaves_from_numpy``; tokens are made with numpy from a seed.  Routing
(the expert ids, the counts and the dirty masks ``counts > 0``) must match
bit for bit: one flipped expert moves a token's output by O(1).  The
reference's ids are its own arithmetic (``moe.py:63-65``: the router's
product in x's dtype, the fp32 softmax, ``lax.top_k``).  Tolerances: the
output at rtol = atol = 1e-5 in fp32 (summation order only, as the dense
models are held) and 1e-2 in bf16 (one bf16 rounding: XLA rounds
``x * sigmoid(x)`` twice where ``F.silu`` rounds once, as for the dense
FFN's bf16 case in ``test_torch_models.py``); ``aux_loss`` at rtol 1e-6;
gradients of x and every weight at 1e-5 of each one's largest entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke
from repro_torch.core.convert import leaves_from_numpy
from repro_torch.models import moe as tmoe

ARCH = "qwen3-moe-235b-a22b"
OUT_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _cfgs(**kw):
    return (dataclasses.replace(jget_smoke(ARCH), **kw),
            dataclasses.replace(get_smoke(ARCH), **kw))


def _params(jcfg, dtype, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    return jp, leaves_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _x(shape, dtype, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        import ml_dtypes
        a = a.astype(ml_dtypes.bfloat16)
    return a, leaves_from_numpy({"x": a}, "cpu")["x"]


def _ref_ids(jp, x, cfg):
    """The reference's routing (``moe.py:63-65``), written out."""
    x = jnp.asarray(x)
    logits = (x @ jp["router"].astype(x.dtype)).astype(jnp.float32)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)[1])


def _check_routing(jp, tp, a, t, jcfg, tcfg):
    """Both packages' ``moe_apply`` on the same tokens, routing bit for bit;
    returns their outputs."""
    _, _, ids = tmoe.route(tp, t, tcfg)
    np.testing.assert_array_equal(ids.numpy(), _ref_ids(jp, a, jcfg))
    jo, jc, ja = jmoe.moe_apply(jp, jnp.asarray(a), jcfg)
    to, tc, ta = tmoe.moe_apply(tp, t, tcfg)
    assert tc.dtype == torch.int32 and tc.shape == (tcfg.n_experts,)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal((tc > 0).numpy(), np.asarray(jc) > 0)
    assert int(tc.sum()) == t.shape[0] * tcfg.top_k
    return (jo, jc, ja), (to, tc, ta)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("T", [40, 3])
def test_moe_apply_matches_reference(dtype, activation, T):
    """T·K above E (cap 13) and below it (T·K = 6 < E = 8: cap 1, decode's
    case, where most choices are dropped)."""
    jcfg, tcfg = _cfgs(activation=activation)
    jp, tp = _params(jcfg, dtype)
    a, t = _x((T, tcfg.d_model), dtype, 1)
    assert tmoe.capacity(T, tcfg) == {40: 13, 3: 1}[T]
    (jo, _, ja), (to, _, ta) = _check_routing(jp, tp, a, t, jcfg, tcfg)
    assert to.dtype == t.dtype and to.shape == t.shape
    tol = OUT_TOL[dtype]
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32),
                               rtol=tol, atol=tol)
    assert ta.dtype == torch.float32
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


@pytest.mark.parametrize("T", [1, 3, 7, 8, 40, 257])
@pytest.mark.parametrize("factor", [1.0, 1.25, 8.0])
def test_capacity_matches_reference_formula(T, factor):
    cfg = dataclasses.replace(get_smoke(ARCH), capacity_factor=factor)
    tk = T * cfg.top_k
    want = max(1, min(tk, int(np.ceil(tk / cfg.n_experts * factor))))
    assert tmoe.capacity(T, cfg) == want


def _steered(jcfg, dtype, choices, seed=0):
    """Router weights that send token t (x = 8 e_t) to the experts
    ``choices[t]``, each at logit 8, every other expert at a lower one."""
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    d, E = jcfg.d_model, jcfg.n_experts
    router = np.full((d, E), -1.0, np.float32)
    for t, es in enumerate(choices):
        router[t, list(es)] = 1.0
    jp = dict(jp, router=jnp.asarray(router))
    x = np.zeros((len(choices), d), np.float32)
    x[np.arange(len(choices)), np.arange(len(choices))] = 8.0
    return jp, leaves_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu"), x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_router_probabilities_pick_the_lower_index(dtype):
    """Three experts tie at the top of every token's probabilities (equal
    logits, so equal probabilities): ``lax.top_k`` and the port both take
    the two lower indices, in ascending order."""
    jcfg, tcfg = _cfgs()
    ties = [(1, 3, 5), (0, 6, 7), (2, 4, 6), (5, 6, 7)] * 3
    jp, tp, x = _steered(jcfg, dtype, ties)
    a, t = x, torch.from_numpy(x)
    if dtype == "bfloat16":
        import ml_dtypes
        a, t = x.astype(ml_dtypes.bfloat16), t.to(torch.bfloat16)
    _, _, ids = tmoe.route(tp, t, tcfg)
    want = np.array([sorted(es)[:2] for es in ties])
    np.testing.assert_array_equal(_ref_ids(jp, a, jcfg), want)
    np.testing.assert_array_equal(ids.numpy(), want)
    (jo, _, _), (to, _, _) = _check_routing(jp, tp, a, t, jcfg, tcfg)
    tol = OUT_TOL[dtype]
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32),
                               rtol=tol, atol=tol)


def test_last_experts_window_is_clamped_as_the_reference_clamps_it():
    """16 tokens, top 2 of 8 experts: T·K = 32, cap 5.  Expert 7 gets two
    choices, so its segment starts at 30 > T·K - cap = 27, and its window
    slides back over expert 6's entries (masked); expert 6 gets seven, so
    two of them are dropped."""
    jcfg, tcfg = _cfgs()
    choices = [(e % 6, 6) for e in range(7)] + [(e % 6, (e + 1) % 6) for e in range(7)] \
        + [(0, 7), (1, 7)]
    jp, tp, x = _steered(jcfg, "float32", choices)
    t = torch.from_numpy(x)
    cap = tmoe.capacity(16, tcfg)
    (jo, jc, _), (to, tc, _) = _check_routing(jp, tp, x, t, jcfg, tcfg)
    assert cap == 5 and tc[7] == 2 and tc[6] == 7
    assert int(tc[:7].sum()) > 16 * tcfg.top_k - cap          # the clamp bites
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    # Expert 6 kept its first five tokens (0-4): tokens 5 and 6 get expert 0/5 alone.
    tp6 = dict(tp, wo=tp["wo"].clone())
    tp6["wo"][6] = 0
    without6, _, _ = tmoe.moe_apply(tp6, t, tcfg)
    assert all(not torch.equal(without6[i], to[i]) for i in range(5))
    assert torch.equal(without6[5:7], to[5:7])


def test_dropped_choice_adds_exact_zero_whatever_its_gathered_row(monkeypatch):
    """Decode's capacity 1: 3 tokens, top 2 of 8.  Expert 1 gets all three
    tokens and keeps token 0's; expert 0 keeps token 2's in row 0 of the
    experts' outputs.  With that row made NaN (as a bf16 overflow would),
    only token 2 is NaN: a dropped choice adds an exact 0, as the
    reference's zeroed window row does, and token 1 keeps its bits."""
    jcfg, tcfg = _cfgs()
    jp, tp, x = _steered(jcfg, "float32", [(1, 2), (1, 3), (0, 1)])
    t = torch.from_numpy(x)
    (jo, _, _), (clean, tc, _) = _check_routing(jp, tp, x, t, jcfg, tcfg)
    assert tmoe.capacity(3, tcfg) == 1 and tc[1] == 3 and tc[0] == 1
    ffn = tmoe._expert_ffn

    def poisoned(xe, *a):
        y = ffn(xe, *a)
        if y.shape[0] == tcfg.n_experts:                   # the chunk of expert 0
            y[0, 0] = float("nan")
        return y

    monkeypatch.setattr(tmoe, "_expert_ffn", poisoned)
    out, _, _ = tmoe.moe_apply(tp, t, tcfg)
    assert bool(out[2].isnan().all())
    assert torch.equal(out[:2], clean[:2])
    np.testing.assert_allclose(clean.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)


def test_moe_grads_match_reference():
    """The VJP of x and every weight, fp32, T·K above E."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, "float32")
    a, t = _x((24, tcfg.d_model), "float32", 2)
    ct = np.random.default_rng(3).standard_normal(a.shape).astype(np.float32)
    names = sorted(tp)

    def jfn(x, *ws):
        out, _, aux = jmoe.moe_apply(dict(zip(names, ws)), x, jcfg)
        return jnp.sum(out * ct) + aux

    jg = jax.grad(jfn, argnums=tuple(range(len(names) + 1)))(
        jnp.asarray(a), *[jp[n] for n in names])
    ts = [t.clone().requires_grad_()] + [tp[n].clone().requires_grad_() for n in names]
    out, _, aux = tmoe.moe_apply(dict(zip(names, ts[1:])), ts[0], tcfg)
    tg = torch.autograd.grad((out * torch.from_numpy(ct)).sum() + aux, ts)
    for n, g, w in zip(["x"] + names, tg, jg):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=n)


def test_moe_init_matches_reference_tree():
    for arch in ("qwen3-moe-235b-a22b", "arctic-480b"):
        jcfg, tcfg = jget_smoke(arch), get_smoke(arch)
        jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
        tp = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16,
                           lead=(3,))
        assert {k: (3,) + tuple(v.shape) for k, v in jp.items()} == \
            {k: tuple(v.shape) for k, v in tp.items()}
        assert tp["router"].dtype == torch.float32 and tp["wi"].dtype == torch.bfloat16


def test_slab_init_draws_in_chunks(monkeypatch):
    """A stack of slabs drawn a few slabs at a time has the fan-in scale and
    cut of ``dense_init``, and no draw is repeated."""
    monkeypatch.setattr(tmoe, "CHUNK_ELEMS", 3 * 64 * 96)
    w = tmoe._slabs_init(torch.Generator().manual_seed(0), (2, 8, 64, 96),
                         torch.float32, "cpu")
    flat = w.reshape(16, -1)
    assert float(w.abs().max()) <= 2.0 / 8.0 + 1e-6
    assert 0.08 < float(w.std()) < 0.13             # trunc. normal's 0.88 / sqrt(64)
    assert all(not torch.equal(flat[i], flat[j]) for i in range(16) for j in range(i))
    assert tmoe._slabs_init(None, (2, 8, 64, 96), torch.bfloat16, "meta").is_meta
