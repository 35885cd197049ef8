"""The port's sharding rules, parallel context, mesh and gradient
compression against the reference's, on the CPU.

``param_specs`` and ``cache_specs`` (the specs as tuples, and the fallback
logs) equal ``repro.dist.sharding``'s for every registered arch, over the
smoke configs' params and caches and the full configs' shapes, on a
(2, 2, 2) and a (16, 16) mesh.  The reference's ``ParallelCtx`` reads only
``mesh.axis_names`` and ``mesh.shape``, so both packages get a plain
namespace for a mesh and no device is forced.  ``ef_compress`` equals the
reference bit for bit on random fp32 and bf16 input (all-zero blocks
included) and keeps the error-feedback contract.  Mirrors
tests/test_compression.py.
"""
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, get_smoke as jget_smoke, list_archs
from repro.dist import compression as jcomp
from repro.dist import sharding as jsharding
from repro.models import build_model as jbuild_model
from repro.models.parallel import NO_PARALLEL as J_NO_PARALLEL
from repro.models.parallel import ParallelCtx as JCtx
from repro_torch.common import flatten_dict
from repro_torch.configs import get_arch, get_smoke
from repro_torch.dist import P, PartitionSpec, cache_specs, compression, param_specs
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.parallel import NO_PARALLEL, ParallelCtx

MESHES = {"2x2x2": (("pod", "data", "model"), (2, 2, 2)),
          "16x16": (("data", "model"), (16, 16))}
BATCH, SMOKE_LEN, FULL_LEN, ENC_LEN = 16, 64, 4096, 256


def _ns_mesh(which):
    axes, sizes = MESHES[which]
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes)))


def _ctxs(which, fsdp):
    mesh = _ns_mesh(which)
    return JCtx(mesh, fsdp_axis=fsdp), ParallelCtx(mesh, fsdp_axis=fsdp)


def _structs(arch, full):
    """Flat param and cache shapes of ``arch`` in both packages."""
    jcfg = (jget_arch if full else jget_smoke)(arch)
    tcfg = (get_arch if full else get_smoke)(arch)
    S = FULL_LEN if full else SMOKE_LEN
    enc = ENC_LEN if jcfg.enc_dec else 0
    jm = jbuild_model(jcfg)
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jc = jax.eval_shape(lambda: jm.init_caches(BATCH, S, enc))
    tm = build_model(tcfg, device="meta")
    return (jcfg, flatten_dict_j(jp), flatten_dict_j(jc), tcfg,
            flatten_dict(tm.init()), flatten_dict(tm.cache_shapes(BATCH, S, enc)))


def flatten_dict_j(tree):
    from repro.common import flatten_dict as jflatten
    return jflatten(tree)


def _as_tuples(specs):
    return {k: tuple(v) for k, v in specs.items()}


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", list_archs())
def test_specs_equal_reference(arch, full):
    jcfg, jp, jc, tcfg, tp, tc = _structs(arch, full)
    assert sorted(jp) == sorted(tp) and sorted(jc) == sorted(tc)
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape), k
    for which in MESHES:
        for fsdp in ("data", ("pod", "data")):
            jctx, tctx = _ctxs(which, fsdp)
            js, jlog = jsharding.param_specs(jp, jctx)
            ts, tlog = param_specs(tp, tctx)
            assert _as_tuples(js) == _as_tuples(ts) and jlog == tlog, (which, fsdp)
            assert all(isinstance(v, PartitionSpec) for v in ts.values())
            js, jlog = jsharding.cache_specs(jcfg, jc, jctx, BATCH)
            ts, tlog = cache_specs(tcfg, tc, tctx, BATCH)
            assert _as_tuples(js) == _as_tuples(ts) and jlog == tlog, (which, fsdp)
    # No mesh: every leaf replicated, nothing logged.
    js, jlog = jsharding.param_specs(jp, JCtx(None))
    ts, tlog = param_specs(tp, ParallelCtx(None))
    assert _as_tuples(js) == _as_tuples(ts) and jlog == tlog == []


@pytest.mark.parametrize("which", list(MESHES))
@pytest.mark.parametrize("kw", [{}, {"fsdp_axis": ("pod", "data")},
                                {"fsdp_axis": ("data",)}, {"tp_axis": "none"},
                                {"pod_axis": None, "fsdp_axis": "model"}])
def test_parallel_ctx_axis_resolution_equals_reference(which, kw):
    mesh = _ns_mesh(which)
    j, t = JCtx(mesh, **kw), ParallelCtx(mesh, **kw)
    assert (j.tp_axis, j.fsdp_axis, j.pod_axis) == (t.tp_axis, t.fsdp_axis, t.pod_axis)
    assert j.dp_axes == t.dp_axes and j.batch_spec == t.batch_spec
    for ax in (None, "data", "model", ("pod", "data"), j.fsdp_axis, j.tp_axis):
        if ax is None or all(a in mesh.shape for a in (ax if isinstance(ax, tuple) else (ax,))):
            assert j.axis_size(ax) == t.axis_size(ax), ax
            for dim in (1, 2, 6, 16, 48, 4096):
                assert j.divides(dim, ax) == t.divides(dim, ax), (dim, ax)
    for seq in (1, 2, 3, 16, 17, 4096):
        assert j.seq_spec(seq) == t.seq_spec(seq), seq
    x = torch.ones(3)
    assert t.constrain(x, "data") is x


def test_no_parallel_equals_reference():
    for attr in ("mesh", "tp_axis", "fsdp_axis", "pod_axis", "dp_axes", "batch_spec"):
        assert getattr(J_NO_PARALLEL, attr) == getattr(NO_PARALLEL, attr), attr
    assert NO_PARALLEL.axis_size("model") == 1 and NO_PARALLEL.seq_spec(64) is None


def test_mesh_and_partition_spec():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2} and mesh.size == 8
    assert mesh.axis_names == ("pod", "data", "model") and mesh.device.type == "cpu"
    prod = make_production_mesh(multi_pod=True, device="cpu")
    assert prod.shape == {"pod": 2, "data": 16, "model": 16} and prod.size == 512
    assert make_production_mesh(device="cpu").axis_names == ("data", "model")
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data", "data"), device="cpu")
    from jax.sharding import PartitionSpec as JP
    for entries in [(("pod", "data"), None), (None, "model"), (), ("data",),
                    (("data",), None)]:
        assert tuple(P(*entries)) == tuple(JP(*entries))
        assert P(*entries) == P(*entries) and len(P(*entries)) == len(JP(*entries))
    spec = P(None, None, ("pod", "data"), "model", None)
    assert spec[2] == ("pod", "data") and spec[3] == "model" and spec[0] is None


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ef_compress_equals_reference(dtype, seed):
    rng = np.random.default_rng(seed)
    n = jcomp.BLOCK * 6
    x = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 50.0], n)).astype(np.float32)
    err = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    x[jcomp.BLOCK:2 * jcomp.BLOCK] = 0.0          # an all-zero block
    err[jcomp.BLOCK:2 * jcomp.BLOCK] = 0.0
    x[2 * jcomp.BLOCK:2 * jcomp.BLOCK + 3] = [254.0, 1.0, 3.0]   # halves: ties to even
    if dtype == "bfloat16":
        xn = x.astype(ml_dtypes.bfloat16)
        en = err.astype(ml_dtypes.bfloat16)
        jx, je = jnp.asarray(xn), jnp.asarray(en)
        tx = torch.from_numpy(xn.astype(np.float32)).to(torch.bfloat16)
        te = torch.from_numpy(en.astype(np.float32)).to(torch.bfloat16)
    else:
        jx, je = jnp.asarray(x), jnp.asarray(err)
        tx, te = torch.from_numpy(x.copy()), torch.from_numpy(err.copy())
    jq, js, jerr = jcomp.ef_compress(jx, je)
    tq, ts, terr = compression.ef_compress(tx, te)
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js).view(np.uint32), ts.numpy().view(np.uint32))
    assert terr.dtype == torch.float32 and np.asarray(jerr).dtype == np.float32
    np.testing.assert_array_equal(np.asarray(jerr).view(np.uint32),
                                  terr.numpy().view(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(jcomp._dequantize(jq, js)).view(np.uint32),
        compression._dequantize(tq, ts).numpy().view(np.uint32))
    assert int(np.count_nonzero(tq.numpy()[jcomp.BLOCK:2 * jcomp.BLOCK])) == 0
    assert float(ts[1]) == 0.0


def test_ef_contract_holds_over_steps():
    """sum_t sent_t + err_T == sum_t grad_t (to fp32 rounding), as the
    reference's tests/test_compression.py holds it."""
    g = torch.Generator().manual_seed(0)
    err = torch.zeros(jcomp.BLOCK * 4)
    sent_sum = torch.zeros_like(err)
    grad_sum = torch.zeros_like(err)
    for _ in range(10):
        grad = torch.randn(err.shape, generator=g)
        q, s, err = compression.ef_compress(grad, err)
        sent_sum += compression._dequantize(q, s)
        grad_sum += grad
        assert float((err.abs().reshape(-1, jcomp.BLOCK).amax(1) - s / 2).max()) <= 1e-6
    torch.testing.assert_close(sent_sum + err, grad_sum, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", list(MESHES))
def test_pipeline_takes_a_mesh(which):
    """``SyntheticPipeline(mesh=)``: the reference's batch specs, and on one
    card the batch is the same tensors as without a mesh."""
    from repro.configs import get_smoke as jsmoke
    from repro.data import SyntheticPipeline as JPipeline
    from repro.models.config import ShapeConfig as JShape
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models import ShapeConfig
    jp = JPipeline(jsmoke("llama3.2-3b"), JShape("t", 64, 8, "train"), seed=3,
                   mesh=_ns_mesh(which))
    axes, sizes = MESHES[which]
    tp = SyntheticPipeline(get_smoke("llama3.2-3b"), ShapeConfig("t", 64, 8, "train"),
                           seed=3, mesh=make_mesh(sizes, axes, device="cpu"))
    assert tp.device.type == "cpu"
    assert _as_tuples(jp.batch_spec()) == _as_tuples(tp.batch_spec())
    plain = SyntheticPipeline(get_smoke("llama3.2-3b"), ShapeConfig("t", 64, 8, "train"),
                              seed=3, device="cpu")
    a, b = tp.get(2), plain.get(2)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert {k: tuple(v) for k, v in plain.batch_spec().items()} == {
        k: (None,) for k in a}


@pytest.mark.parametrize("spec", [None, P("model", None), P(("pod", "data"), None),
                                  P(("pod", "data", "model"), None),
                                  P(None, None, ("pod", "data"), "model", None)],
                         ids=["none", "model", "pod-data", "all", "kv"])
def test_red_spec_equals_reference(spec):
    """``RedundancyEngine.red_spec``: every redundancy array (``meta_ck``
    too) split along dim 0 over the axes the leaf's spec uses, as the
    reference's.  Neither engine reads its mesh for it."""
    from jax.sharding import PartitionSpec as JP
    from repro.core.engine import RedundancyEngine as JEngine
    from repro_torch.core import RedundancyEngine
    from repro_torch.core.blocks import ShapeDtype
    shape = (4, 16, 8, 8, 64)
    jspec = None if spec is None else JP(*spec)
    je = JEngine({"x": jax.ShapeDtypeStruct(shape, jnp.bfloat16)},
                 specs={} if spec is None else {"x": jspec})
    te = RedundancyEngine({"x": ShapeDtype(shape, torch.bfloat16)}, device="cpu",
                          specs={} if spec is None else {"x": spec})
    jr, tr = je.red_spec("x"), te.red_spec("x")
    for f in ("checksums", "parity", "dirty", "shadow", "meta_ck"):
        assert tuple(getattr(jr, f)) == tuple(getattr(tr, f)), f
