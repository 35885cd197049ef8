"""The port's AdamW and learning-rate schedule against the JAX package's.

Tolerances: at most one unit in the last place (ulp) of the leaf's dtype.
Both packages do the same float32 operations in the same order; what may
differ is the last bit of a transcendental (``cos``, ``pow``, ``sqrt`` of
the norm).  The grads are small dyadic numbers, so the grad norm's sum of
squares is exact in any order: the two packages sum in different orders,
and an ulp of the clipping scale would otherwise grow to many where
``b1 * m + (1 - b1) * g`` cancels.  Lazy rows must be bit-identical to
their inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.optim.adamw as adamw_mod
from repro.optim import AdamW as JAdamW, warmup_cosine as jwarmup_cosine
from repro_torch.common import flatten_dict, tree_map
from repro_torch.core.convert import leaves_from_numpy, leaves_to_numpy
from repro_torch.optim import AdamW, warmup_cosine


def ulps(a, b) -> int:
    """Largest distance in units in the last place between two float arrays
    of one dtype (float32 or bfloat16), through their ordered bit patterns."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    width = a.dtype.itemsize * 8
    ints = {32: np.int32, 16: np.int16}[width]

    def ordered(x):
        i = np.ascontiguousarray(x).view(ints).astype(np.int64)
        return np.where(i < 0, -(i & ((1 << (width - 1)) - 1)), i)
    return int(np.abs(ordered(a) - ordered(b)).max()) if a.size else 0


@pytest.mark.parametrize("sched", [(1e-3, 10, 50, 0.1), (3e-3, 5, 100, 0.1),
                                   (1e-2, 2, 10, 0.0), (1e-3, 0, 20, 0.25)])
def test_warmup_cosine_within_one_ulp(sched):
    jlr, tlr = jwarmup_cosine(*sched), warmup_cosine(*sched)
    for step in range(sched[2] + 5):
        want = np.asarray(jlr(jnp.int32(step)), np.float32)
        got = np.float32(tlr(step))
        assert ulps(got, want) <= 1, (step, got, want)


def _tree(rng, dtype, n_rows=10):
    """A params tree with a lazy-row table, 1-d, 2-d and stacked 3-d leaves
    and an empty subtree (a non-parametric norm)."""
    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32).astype(dtype)
    return {"embed": r(n_rows, 8), "norm": {}, "w": r(8, 8), "b": r(8),
            "stack": {"wi": r(3, 8, 4)}}


def _both(jtree):
    return jtree, leaves_from_numpy(jtree, "cpu")


def _run(param_dtype, moment_dtype, grad_scale, clip_norm, count, masks=True):
    """One update from the same numpy state in both packages."""
    import ml_dtypes
    pdt = np.float32 if param_dtype == "float32" else ml_dtypes.bfloat16
    mdt = np.float32 if moment_dtype == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(count)
    params = _tree(rng, pdt)
    grads = jax.tree_util.tree_map(
        lambda p: (rng.integers(-16, 17, p.shape) * grad_scale).astype(np.float32)
        .astype(pdt), params)
    m = jax.tree_util.tree_map(lambda p: (rng.standard_normal(p.shape) * 0.01)
                               .astype(np.float32).astype(mdt), params)
    v = jax.tree_util.tree_map(lambda p: (rng.random(p.shape) * 1e-3)
                               .astype(np.float32).astype(mdt), params)
    mask = np.zeros(10, bool)
    mask[[2, 5, 9]] = True
    kw = dict(lr=warmup_cosine(1e-2, 3, 20), clip_norm=clip_norm,
              moment_dtype=moment_dtype)
    jopt = JAdamW(**{**kw, "lr": jwarmup_cosine(1e-2, 3, 20)})
    jstate = {"m": m, "v": v, "count": jnp.int32(count)}
    jp, jst, jgn = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                               jax.tree_util.tree_map(jnp.asarray, jstate),
                               jax.tree_util.tree_map(jnp.asarray, params),
                               {"embed": jnp.asarray(mask)} if masks else None)
    tparams = leaves_from_numpy(params, "cpu")
    tstate = {"m": leaves_from_numpy(m, "cpu"), "v": leaves_from_numpy(v, "cpu"),
              "count": count}
    tgn = AdamW(**kw).update(leaves_from_numpy(grads, "cpu"), tstate, tparams,
                             {"embed": torch.from_numpy(mask)} if masks else None)
    return (params, m, v, mask), (jp, jst, jgn), (tparams, tstate, tgn)


@pytest.mark.parametrize("dtypes", [("float32", "float32"), ("bfloat16", "float32"),
                                    ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("count", [0, 7])
def test_adamw_update_within_one_ulp(dtypes, clip, count):
    grad_scale, clip_norm = (1.0, 1.0) if clip == "active" else (2.0**-10, 100.0)
    (params, m, v, mask), (jp, jst, jgn), (tp, tst, tgn) = _run(
        *dtypes, grad_scale, clip_norm, count)
    assert (float(jgn) > clip_norm) == (clip == "active")
    assert ulps(np.float32(tgn), np.asarray(jgn, np.float32)) <= 1
    assert tst["count"] == int(jst["count"]) == count + 1
    for name, want in (("params", jp), ("m", jst["m"]), ("v", jst["v"])):
        got = leaves_to_numpy(tp if name == "params" else tst[name])
        for leaf, w in flatten_dict(jax.tree_util.tree_map(np.asarray, want)).items():
            g = flatten_dict(got)[leaf]
            assert ulps(g, w) <= 1, (name, leaf)
    # Lazy rows: untouched rows bit-identical to their inputs, touched ones moved.
    for name, before, after in (("params", params, tp), ("m", m, tst["m"]),
                                ("v", v, tst["v"])):
        a = leaves_to_numpy(after)["embed"]
        np.testing.assert_array_equal(a[~mask].view(np.uint8),
                                      before["embed"][~mask].view(np.uint8), err_msg=name)
        assert not np.array_equal(a[mask], before["embed"][mask]), name
    # Dense leaves: every element moved.
    assert not np.array_equal(leaves_to_numpy(tp)["w"], params["w"])


def test_slicing_changes_no_bit(monkeypatch):
    """The update walks leaves in leading-axis slices: slices of a few
    elements give the whole-leaf update's params and moments bit for bit
    (clipping off, so the grad norm's summation order cannot move them)."""
    _, _, (p1, s1, g1) = _run("float32", "float32", 2.0**-10, 100.0, 3)
    monkeypatch.setattr(adamw_mod, "SLICE_ELEMS", 16)
    _, _, (p2, s2, g2) = _run("float32", "float32", 2.0**-10, 100.0, 3)
    for a, b in ((p1, p2), (s1["m"], s2["m"]), (s1["v"], s2["v"])):
        for n, t in flatten_dict(a).items():
            assert torch.equal(t, flatten_dict(b)[n]), n
    np.testing.assert_allclose(float(g1), float(g2), rtol=1e-6)


def test_update_is_in_place_and_keeps_empty_subtrees():
    opt = AdamW(lr=lambda s: 1e-3)
    params = {"norm": {}, "w": torch.ones(2, 2)}
    state = opt.init(params)
    assert state["m"]["norm"] == {} and state["v"]["norm"] == {} and state["count"] == 0
    w, m = params["w"], state["m"]["w"]
    opt.update({"norm": {}, "w": torch.ones(2, 2)}, state, params)
    assert params["norm"] == {} and params["w"] is w and state["m"]["w"] is m
    assert not torch.equal(w, torch.ones(2, 2)) and state["count"] == 1


def test_init_follows_the_params_device_and_moment_dtype():
    params = {"w": torch.empty((3, 4), dtype=torch.bfloat16, device="meta")}
    st = AdamW(lr=lambda s: 1e-3, moment_dtype="bfloat16").init(params)
    assert st["m"]["w"].device.type == "meta" and st["v"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slice_elems", [60, 10])
def test_expert_slabs_sliced_with_their_mask_change_no_bit(monkeypatch, moment_dtype,
                                                           slice_elems):
    """A ``(G, E, d, ff)`` expert leaf with a ``(G, E)`` slab mask, walked in
    slices over two leading axes (60 elements: ``[g, e:e + 2]``) or three
    (10: ``[g, e, i]``): params, moments and the grad norm bitwise those of
    one whole slice (dyadic grads: the sum of squares is exact in any
    order), and untouched slabs bit-identical to their inputs."""
    G, E, d, ff = 2, 5, 4, 6
    rng = np.random.default_rng(11)
    mask = torch.from_numpy(rng.random((G, E)) < 0.5)
    mask[0, 0], mask[1, 4] = True, False
    mdt = getattr(torch, moment_dtype)

    def state():
        def r(*shape, scale=1.0):
            return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
        params = {"moe": {"wi": r(G, E, d, ff).to(torch.bfloat16)},
                  "w": r(7, 9).to(torch.bfloat16)}
        grads = {k: torch.from_numpy(rng.integers(-16, 17, p.shape).astype(np.float32)
                                     * 2.0**-4).to(torch.bfloat16)
                 for k, p in flatten_dict(params).items()}
        opt = {"m": {"moe": {"wi": r(G, E, d, ff, scale=0.01).to(mdt)},
                     "w": r(7, 9, scale=0.01).to(mdt)},
               "v": {"moe": {"wi": r(G, E, d, ff, scale=1e-3).abs().to(mdt)},
                     "w": r(7, 9, scale=1e-3).abs().to(mdt)}, "count": 4}
        return params, {"moe": {"wi": grads["moe/wi"]}, "w": grads["w"]}, opt

    base = state()
    runs = []
    for elems in (1 << 28, slice_elems):
        monkeypatch.setattr(adamw_mod, "SLICE_ELEMS", elems)
        params, grads, opt = (tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, t)
                              for t in base)
        gn = AdamW(lr=lambda s: 1e-2, clip_norm=1.0, moment_dtype=moment_dtype).update(
            grads, opt, params, {"moe/wi": mask})
        runs.append((params, opt, gn))
    assert len(adamw_mod._slices(base[0]["moe"]["wi"])) == {60: 6, 10: 40}[slice_elems]
    def bits(t):
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])

    (p1, o1, g1), (p2, o2, g2) = runs
    assert torch.equal(bits(g1), bits(g2))
    for a, b in ((p1, p2), (o1["m"], o2["m"]), (o1["v"], o2["v"])):
        for n, t in flatten_dict(a).items():
            assert torch.equal(bits(t), bits(flatten_dict(b)[n])), n
    for before, after in ((base[0]["moe"]["wi"], p2["moe"]["wi"]),
                          (base[2]["m"]["moe"]["wi"], o2["m"]["moe"]["wi"]),
                          (base[2]["v"]["moe"]["wi"], o2["v"]["moe"]["wi"])):
        assert torch.equal(bits(after[~mask]), bits(before[~mask]))
        assert all(not torch.equal(after[g, e], before[g, e])
                   for g, e in mask.nonzero().tolist())
