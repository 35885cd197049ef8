"""The port's planning tools (``repro_torch.launch``: specs, memory_model,
dryrun, hillclimb) against the reference's ``repro.launch``, on the CPU.

The reference runs once, in one subprocess with 512 forced host devices
(``repro.launch.dryrun`` sets that flag when imported, so it is never
imported here), and prints what this file compares as one JSON line:

* for every arch x ``SHAPES`` entry x {no mesh, (16, 16), (2, 16, 16)}:
  ``make_ctx``'s FSDP axis, ``default_accum``, ``cell_applicability`` and
  ``model_flops``;
* for each smoke arch (head dim 64, the least the flash kernel takes; one
  group of layers) x {train, decode, prefill} on a (2, 2, 2) mesh: the
  setup's structs
  (shape and dtype of every leaf) and PartitionSpecs, and every term of
  ``analytic_hbm``;
* ``analytic_hbm`` of llama3.2-3b and arctic-480b at full size, at
  train_4k and decode_32k on the (16, 16) mesh (the setups only: no
  full-size trace runs here).

The port's setups hold the same structs as meta tensors; each smoke
setup's step also runs on the meta device.  Exact equality throughout
(integers and the reference's floats).  Documented differences: the
redundancy arrays' uint32 words are int32 in the port, and the batch's
vision patches and encoder frames are fp32 in the port where the
reference's ``batch_structs`` says bf16 (ROADMAP Queue 3, difference 4).
"""
import dataclasses
import json
import re

import pytest
import torch

import _torch_helpers  # noqa: F401  (torch's threads: each worker's share)
from subproc import run_py
from repro_torch.common import flatten_dict
from repro_torch.configs import get_arch, get_smoke, list_archs
from repro_torch.core.state import FIELDS
from repro_torch.launch import dryrun, hillclimb, memory_model, specs
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.config import SHAPES, ShapeConfig

ARCHS = list_archs()
MESHES = ("none", "single", "multi")
KINDS = ("train", "decode", "prefill")
SMALL = {"train": ShapeConfig("train_s", 32, 8, "train"),
         "decode": ShapeConfig("decode_s", 64, 8, "decode"),
         "prefill": ShapeConfig("prefill_s", 32, 8, "prefill")}
FULL_HBM = [(a, s) for a in ("llama3.2-3b", "arctic-480b") for s in ("train_4k", "decode_32k")]
# Fields the port carries as int32 bit patterns where the reference has uint32.
_DT = {"uint32": "int32"}

REFERENCE = r"""
import dataclasses
import json
import jax
import numpy as np
from repro.configs import get_arch, get_smoke, list_archs
from repro.launch import dryrun as D, memory_model as M, specs as S
from repro.launch.mesh import make_mesh, make_production_mesh
from repro.models.config import SHAPES, ShapeConfig
from repro.common import flatten_dict

SMALL = {"train": ShapeConfig("train_s", 32, 8, "train"),
         "decode": ShapeConfig("decode_s", 64, 8, "decode"),
         "prefill": ShapeConfig("prefill_s", 32, 8, "prefill")}
OUT = {"ctx": {}, "setups": {}, "hbm_full": {}}

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(s)]

def sd(x):
    return [list(x.shape), str(x.dtype)]

def flat(tree, fn):
    return {k: fn(v) for k, v in flatten_dict(tree).items()}

def red(r, fn):
    return {n: {f: fn(getattr(v, f)) for f in %(fields)r} for n, v in r.items()}

def hbm(rec):
    return {k: (v if isinstance(v, bool) else int(v)) for k, v in rec.items()}

meshes = {"none": None, "single": make_production_mesh(),
          "multi": make_production_mesh(multi_pod=True)}
for a in list_archs():
    cfg = get_arch(a)
    for sn, sh in SHAPES.items():
        for mn, mesh in meshes.items():
            fs = S.make_ctx(cfg, mesh).fsdp_axis
            OUT["ctx"][f"{a}|{sn}|{mn}"] = {
                "fsdp": list(fs) if isinstance(fs, tuple) else fs,
                "accum": S.default_accum(cfg, sh, mesh),
                "skip": D.cell_applicability(cfg, sh),
                "model_flops": D.model_flops(cfg, sh)}

mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
for a in list_archs():
    cfg = dataclasses.replace(get_smoke(a), head_dim=64)
    cfg = dataclasses.replace(cfg, n_layers=cfg.group_size)
    for kind, sh in SMALL.items():
        rec = {}
        accum = S.default_accum(cfg, sh, mesh)
        if kind == "train":
            st = S.build_train_setup(cfg, sh, mesh, mode="vilamb", accum_steps=accum)
            rec["params"] = flat(st.state_struct.params, sd)
            rec["m"] = flat(st.state_struct.opt["m"], sd)
            rec["v"] = flat(st.state_struct.opt["v"], sd)
            rec["red"] = red(st.state_struct.red, sd)
            rec["params_specs"] = flat(st.state_sharding.params, lambda s: spec(s.spec))
            rec["red_specs"] = red(st.state_sharding.red, lambda s: spec(s.spec))
            rec["batch"] = {k: sd(v) for k, v in st.batch_struct.items()}
            rec["batch_specs"] = {k: spec(v.spec) for k, v in st.batch_sharding.items()}
        elif kind == "decode":
            st = S.build_decode_setup(cfg, sh, mesh, mode="vilamb")
            p, c, r, tok, pos = st.args_struct
            rec["params"] = flat(p, sd)
            rec["caches"] = flat(c, sd)
            rec["red"] = red(r, sd)
            rec["token"] = sd(tok)
            ps, cs, rs, ts, _ = st.args_sharding
            rec["params_specs"] = flat(ps, lambda s: spec(s.spec))
            rec["caches_specs"] = flat(cs, lambda s: spec(s.spec))
            rec["red_specs"] = red(rs, lambda s: spec(s.spec))
            rec["token_spec"] = spec(ts.spec)
        else:
            st = S.build_prefill_setup(cfg, sh, mesh)
            p, b = st.args_struct
            rec["params"] = flat(p, sd)
            rec["batch"] = {k: sd(v) for k, v in b.items()}
            ps, bs = st.args_sharding
            rec["params_specs"] = flat(ps, lambda s: spec(s.spec))
            rec["batch_specs"] = {k: spec(v.spec) for k, v in bs.items()}
            rec["caches_specs"] = flat(st.out_sharding[1], lambda s: spec(s.spec))
        rec["log"] = list(st.fallback_log)
        rec["hbm"] = hbm(M.analytic_hbm(cfg, sh, mesh, st, "vilamb", accum))
        OUT["setups"][f"{a}|{kind}"] = rec

single = make_production_mesh()
for a, sn in %(full)r:
    cfg, sh = get_arch(a), SHAPES[sn]
    accum = S.default_accum(cfg, sh, single)
    if sh.kind == "train":
        st = S.build_train_setup(cfg, sh, single, mode="vilamb", accum_steps=accum)
    else:
        st = S.build_decode_setup(cfg, sh, single, mode="vilamb")
    OUT["hbm_full"][f"{a}|{sn}"] = hbm(M.analytic_hbm(cfg, sh, single, st, "vilamb", accum))

print("REF" + json.dumps(OUT))
""" % {"fields": FIELDS, "full": FULL_HBM}


@pytest.fixture(scope="module")
def ref():
    r = run_py(REFERENCE, devices=512, timeout=600)
    line = next((ln for ln in r.stdout.splitlines() if ln.startswith("REF")), None)
    assert line is not None, (f"reference subprocess failed (exit {r.returncode})\n"
                              f"{r.stdout[-2000:]}\n{r.stderr[-6000:]}")
    return json.loads(line[3:])


def smoke(arch):
    """The smoke config with head dim 64 (the least the flash kernel
    takes), cut to one group of layers (every layer kind once)."""
    cfg = dataclasses.replace(get_smoke(arch), head_dim=64)
    return dataclasses.replace(cfg, n_layers=cfg.group_size)


def port_mesh(name):
    if name == "none":
        return None
    return make_production_mesh(multi_pod=name == "multi", device="meta")


def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(s)]


def sd(t):
    return [list(t.shape), str(t.dtype).replace("torch.", "")]


def flat(tree, fn):
    return {k: fn(v) for k, v in flatten_dict(tree).items()}


def red(r, fn):
    return {n: {f: fn(getattr(v, f)) for f in FIELDS} for n, v in r.items()}


def ref_red(r):
    return {n: {f: [s, _DT.get(d, d)] for f, (s, d) in v.items()} for n, v in r.items()}


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_ctx_accum_applicability_and_model_flops_equal_reference(ref, arch, shape_name,
                                                                 mesh_name):
    cfg, sh, mesh = get_arch(arch), SHAPES[shape_name], port_mesh(mesh_name)
    fs = specs.make_ctx(cfg, mesh).fsdp_axis
    got = {"fsdp": list(fs) if isinstance(fs, tuple) else fs,
           "accum": specs.default_accum(cfg, sh, mesh),
           "skip": dryrun.cell_applicability(cfg, sh),
           "model_flops": dryrun.model_flops(cfg, sh)}
    assert got == ref["ctx"][f"{arch}|{shape_name}|{mesh_name}"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_setup_structs_specs_and_hbm_equal_reference(ref, arch, kind):
    """The port's twin of tests/test_sharded.py::test_tiny_mesh_dryrun_all_kinds:
    a (2, 2, 2) mesh, every kind of step; the step runs on meta."""
    want = ref["setups"][f"{arch}|{kind}"]
    cfg, sh = smoke(arch), SMALL[kind]
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="meta")
    accum = specs.default_accum(cfg, sh, mesh)
    st = dryrun.build_setup(cfg, sh, mesh, "vilamb", accum)
    got = {}
    if kind == "train":
        s, ss = st.state_struct, st.state_specs
        got.update(params=flat(s.params, sd), m=flat(s.opt["m"], sd), v=flat(s.opt["v"], sd),
                   red=red(s.red, sd), params_specs=flat(ss.params, spec),
                   red_specs=red(ss.red, spec),
                   batch={k: sd(v) for k, v in st.batch_struct.items()},
                   batch_specs={k: spec(v) for k, v in st.batch_specs.items()})
    elif kind == "decode":
        p, c, r, tok, _ = st.args_struct
        ps, cs, rs, ts, _ = st.args_specs
        got.update(params=flat(p, sd), caches=flat(c, sd), red=red(r, sd), token=sd(tok),
                   params_specs=flat(ps, spec), caches_specs=flat(cs, spec),
                   red_specs=red(rs, spec), token_spec=spec(ts))
    else:
        p, b = st.args_struct
        ps, bs = st.args_specs
        got.update(params=flat(p, sd), batch={k: sd(v) for k, v in b.items()},
                   params_specs=flat(ps, spec), batch_specs={k: spec(v) for k, v in bs.items()},
                   caches_specs={k: spec(v) for k, v in st.out_specs.items()})
    got["log"] = st.fallback_log
    got["hbm"] = memory_model.analytic_hbm(cfg, sh, mesh, st, "vilamb", accum)
    want = dict(want)
    if "red" in want:
        want["red"] = ref_red(want["red"])
    want_hbm = dict(want.pop("hbm"))
    want_hbm["fits_hbm_analytic"] = want_hbm.pop("fits_16g_analytic")
    got_hbm = got.pop("hbm")
    got_hbm["fits_hbm_analytic"] = want_hbm["fits_hbm_analytic"]   # another budget
    assert got_hbm == want_hbm
    if "batch" in want:       # fp32 patches and frames (Queue 3, difference 4)
        for k in ("frontend", "enc_input"):
            if k in want["batch"]:
                assert want["batch"][k][1] == "bfloat16" and got["batch"][k][1] == "float32"
                got["batch"][k][1] = "bfloat16"
    assert got == want
    # The setup's step runs on the meta device (every kernel's meta branch).
    parts = dryrun.run_parts(kind, st.step_fn, getattr(st, "store", None),
                             dryrun.setup_args(st, kind), getattr(st, "redundancy_fn", None))
    assert parts["step"].n_ops > 0
    if kind == "prefill" and cfg.layer_kind(0) != "mlstm":
        assert parts["step"].launches().get("flash_attn", 0) > 0
    if kind != "prefill":
        assert parts["init"].launches() == {"checksum": len(st.store.protected_metas),
                                            "parity": len(st.store.protected_metas)}
        assert parts["redundancy"].launches()["fused_update"] >= 1


@pytest.mark.parametrize("arch,shape_name", FULL_HBM)
def test_full_size_hbm_terms_equal_reference(ref, arch, shape_name):
    cfg, sh = get_arch(arch), SHAPES[shape_name]
    mesh = port_mesh("single")
    accum = specs.default_accum(cfg, sh, mesh)
    st = dryrun.build_setup(cfg, sh, mesh, "vilamb", accum)
    got = memory_model.analytic_hbm(cfg, sh, mesh, st, "vilamb", accum)
    want = dict(ref["hbm_full"][f"{arch}|{shape_name}"])
    want.pop("fits_16g_analytic")
    assert {k: v for k, v in got.items() if k != "fits_hbm_analytic"} == want
    assert got["fits_hbm_analytic"] == (
        got["total"] <= memory_model.HBM_BUDGET * memory_model.HEADROOM)


# The reference's hillclimb printout (src/repro/launch/hillclimb.py:69-81).
HEADER = "=== {arch} {shape} single [{tag}] variant={variant} ==="
LINE = re.compile(r"compute \d+\.\d{3}s  memory \d+\.\d{3}s  collective \d+\.\d{3}s  "
                  r"bottleneck=(compute|memory|collective)  frac=\d+\.\d{4}  "
                  r"fits=(True|False)")
TERM = re.compile(r"  (compute_s|memory_s|collective_s) +\d+\.\d{3} -> +\d+\.\d{3}  "
                  r"\([+-]\d+\.\d%\)")
FRAC = re.compile(r"  frac          \d+\.\d{4} -> \d+\.\d{4}")


def test_hillclimb_prints_the_reference_lines(monkeypatch, tmp_path, capsys):
    arch = "llama3.2-3b"
    monkeypatch.setattr(hillclimb, "get_arch", smoke)
    monkeypatch.setitem(dryrun.SHAPES, "train_4k", ShapeConfig("train_4k", 32, 16, "train"))
    dryrun.run_cell(arch, "train_4k", False, out_dir=tmp_path / "base", cfg_override=smoke(arch))
    hillclimb.main(["--arch", arch, "--shape", "train_4k", "--variant", "remat=none",
                    "--tag", "noremat", "--out", str(tmp_path / "perf"),
                    "--base", str(tmp_path / "base")])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ""
    assert lines[1] == HEADER.format(arch=arch, shape="train_4k", tag="noremat",
                                     variant=["remat=none"])
    assert LINE.fullmatch(lines[2]), lines[2]
    assert all(TERM.fullmatch(ln) for ln in lines[3:6]), lines[3:6]
    assert FRAC.fullmatch(lines[6]) and len(lines) == 7, lines[6:]
    assert (tmp_path / "perf" / f"{arch}__train_4k__single__noremat.json").exists()


@pytest.mark.parametrize("knob", hillclimb.MESH_ONLY_KNOBS)
def test_hillclimb_refuses_mesh_only_knobs(knob):
    with pytest.raises(NotImplementedError, match="Queue 1 item 11.7"):
        hillclimb.parse_variant([f"{knob}=true"])


def test_redundancy_cell_counts_a_full_pass(tmp_path):
    rec = dryrun.run_redundancy_cell("llama3.2-3b", multi_pod=None, out_dir=tmp_path,
                                     cfg_override=smoke("llama3.2-3b"))
    k3 = rec["costs"]["kernels"]["fused_update"]
    assert rec["status"] == "ok" and k3["launches"] == 1
    assert rec["collectives"]["total_bytes"] == 0 and rec["bound_by"] == "bytes"
    assert rec["memory_efficiency"] > 0 and rec["useful_bytes_per_chip"] > 0
