"""The port's checkpoints and preemption drain against the reference's, on
the CPU.

Checkpoints are a shared on-disk format: a checkpoint written by ``repro``
restores bit for bit in ``repro_torch`` and the reverse, and the two
packages write equal manifests (key paths, order, shapes, dtypes, file
checksums) and equal arrays for the same state, a save taken while an
overlapped update is in flight included.  ``restore_verified`` gives the
same ``RestoreReport`` for the same faults.  The on-device file checksum's
CPU twin equals the reference's ``_np_checksum``.  Every comparison is
exact: these are bit patterns.  Mirrors tests/test_ckpt.py and
tests/test_recovery.py.
"""
import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_helpers import assert_red_equal
from repro.ckpt import CheckpointManager as JCkpt
from repro.ckpt import checkpoint as jck
from repro.configs import get_smoke as jget_smoke
from repro.core import ProtectedStore as JStore
from repro.core import RedundancyPolicy as JPolicy
from repro.models import build_model as jbuild
from repro.optim import AdamW as JAdamW
from repro.train import TrainState as JTrainState
from repro.train import Trainer as JTrainer
from repro.train import protected_structs as jstructs
from repro_torch.ckpt import CheckpointManager, PreemptionHandler, RestoreReport
from repro_torch.ckpt import checkpoint as tck
from repro_torch.configs import get_smoke
from repro_torch.core import ProtectedStore, RedundancyPolicy, convert
from repro_torch.data import SyntheticPipeline
from repro_torch.models import Model, ShapeConfig, build_model
from repro_torch.optim import AdamW
from repro_torch.train import TrainState, Trainer, protected_leaves, protected_structs

ROOT = pathlib.Path(__file__).resolve().parents[1]
L = 128                  # lanes per block of the synthetic stores
SMOKE_L = 512            # and of the smoke model's


# ------------------------------------------------------------ file checksum
def _arrays():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "bf16_odd_words": rng.standard_normal((5, 3)).astype(ml_dtypes.bfloat16),
        "int32_0d": np.asarray(7, np.int32),
        "uint8_tail": rng.integers(0, 256, (7,), dtype=np.uint8),
        "uint8_one": np.asarray([200], np.uint8),
        "empty": np.zeros((0,), np.float32),
        "uint32_bits": rng.integers(0, 2**32, (1000,), dtype=np.uint64).astype(np.uint32),
        "specials": np.array([0x7FC00000, 0x7F800000, 0xFF800000, 0, 0xFFFFFFFF],
                             np.uint32).view(np.float32),
    }


@pytest.mark.parametrize("name", sorted(_arrays()))
@pytest.mark.parametrize("chunk_words", [tck.CHUNK_WORDS, 7, 1])
def test_file_checksum_equals_reference(name, chunk_words):
    """The on-device file checksum (here its CPU twin: the same int32 torch
    ops on a CPU tensor), chunked or not, equals ``_np_checksum``, for
    leaves that are and are not a whole number of words."""
    a = _arrays()[name]
    want = jck._np_checksum(a)
    assert tck._np_checksum(a) == want
    t = convert.leaves_from_numpy({"x": a}, "cpu")["x"]
    assert tck.file_checksum(t, chunk_words) == want


def test_file_checksum_of_a_view_with_an_odd_offset():
    a = np.arange(11, dtype=np.uint16)
    t = torch.from_numpy(a)[1:8]
    assert tck.file_checksum(t) == jck._np_checksum(a[1:8])


# --------------------------------------------------------- synthetic states
def _np_trees(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((32, 256)).astype(np.float32),
              "blk": {"e": rng.standard_normal((16, 64)).astype(ml_dtypes.bfloat16)},
              "norm": {}}
    m = {"w": rng.standard_normal((32, 256)).astype(np.float32),
         "blk": {"e": rng.standard_normal((16, 64)).astype(np.float32)}, "norm": {}}
    v = {"w": np.abs(rng.standard_normal((32, 256))).astype(np.float32),
         "blk": {"e": np.abs(rng.standard_normal((16, 64))).astype(np.float32)},
         "norm": {}}
    return params, {"m": m, "v": v}


def _jtree(t):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), t)


def _ttree(t):
    return {k: _ttree(v) if isinstance(v, dict) else
            convert.leaves_from_numpy({"x": v}, "cpu")["x"] for k, v in t.items()}


def _pair_states(async_tick=False, period=3, count=5, step=6, dirty_rows=(),
                 due=False):
    """The same numpy state as a reference and a port ``TrainState``, with
    stores over params, m and v (redundancy equal bit for bit), after
    marking ``dirty_rows`` of ``w`` and, with ``due``, a due tick."""
    params, opt = _np_trees()
    kw = dict(lanes_per_block=L, async_tick=async_tick, period_steps=period)
    from repro.train import protected_leaves as jleaves
    jp, jo = _jtree(params), dict(_jtree(opt), count=jnp.int32(count))
    tp, to = _ttree(params), dict(_ttree(opt), count=count)
    js = JStore(JPolicy.single("vilamb", precompile=False, dispatcher_thread=False,
                               **kw)).attach(jleaves(jp, jo))
    ts = ProtectedStore(RedundancyPolicy.single("vilamb", **kw),
                        device="cpu").attach(protected_leaves(tp, to))
    jred, tred = js.init(jleaves(jp, jo)), ts.init(protected_leaves(tp, to))
    if dirty_rows:
        ev = np.zeros(32, bool)
        ev[list(dirty_rows)] = True
        jred = js.on_write(jred, events={"params/w": jnp.asarray(ev.copy())})
        tred = ts.on_write(tred, events={"params/w": torch.from_numpy(ev)})
    if due:
        jred, _ = js.tick(jleaves(jp, jo), jred, period)
        tred, _ = ts.tick(protected_leaves(tp, to), tred, period)
    assert_red_equal(jred, tred, "pair state")
    jstate = JTrainState(params=jp, opt=jo, red=jred, step=jnp.int32(step))
    tstate = TrainState(params=tp, opt=to, red=tred, step=step)
    return (js, jstate), (ts, tstate)


def _jkeys(jstate):
    return [jck._path_str(kp) for kp, _ in
            jax.tree_util.tree_flatten_with_path(jstate)[0]]


def _assert_states_equal(jstate, tstate):
    """Every leaf bit for bit (through the reference's key paths)."""
    jflat = {jck._path_str(kp): np.asarray(v) for kp, v in
             jax.tree_util.tree_flatten_with_path(jstate)[0]}
    tflat = tck.state_leaves(tstate)
    assert list(jflat) == list(tflat)
    for k, jv in jflat.items():
        tv = tflat[k]
        if isinstance(tv, int):
            assert jv.shape == () and int(jv) == tv, k
            continue
        got = convert.leaves_to_numpy({"x": tv})["x"]
        assert got.shape == jv.shape, k
        np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                      jv.reshape(-1).view(np.uint8), err_msg=k)


def _assert_same_files(jdir, tdir, step):
    jm = json.loads((pathlib.Path(jdir) / f"step_{step}" / "manifest.json").read_text())
    tm = json.loads((pathlib.Path(tdir) / f"step_{step}" / "manifest.json").read_text())
    assert jm == tm
    assert list(jm["leaves"]) == list(tm["leaves"])
    with np.load(pathlib.Path(jdir) / f"step_{step}" / "state.npz") as jz, \
            np.load(pathlib.Path(tdir) / f"step_{step}" / "state.npz") as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for k in jz.files:
            assert jz[k].dtype == tz[k].dtype and jz[k].shape == tz[k].shape, k
            np.testing.assert_array_equal(jz[k], tz[k], err_msg=k)
    return tm


def test_key_paths_follow_the_references_flatten_order():
    (_, jstate), (_, tstate) = _pair_states()
    assert list(tck.state_leaves(tstate)) == _jkeys(jstate)


@pytest.mark.parametrize("mid_flight", [False, True])
def test_same_state_saves_to_equal_files(tmp_path, mid_flight):
    """Both packages save the same state to equal manifests and arrays;
    ``mid_flight``: right after a due tick on the overlapped tick, with the
    update in flight (the port passes its store, which orders the copies
    after the update; on the CPU the live view keeps the old epoch, as the
    reference's does)."""
    (js, jstate), (ts, tstate) = _pair_states(
        async_tick=mid_flight, dirty_rows=(3, 17), due=mid_flight)
    if mid_flight:
        assert all(g.pending is not None for g in ts.groups.values())
    JCkpt(tmp_path / "j").save(6, jstate, blocking=True)
    CheckpointManager(tmp_path / "t", device="cpu").save(6, tstate, store=ts)
    man = _assert_same_files(tmp_path / "j", tmp_path / "t", 6)
    assert man["bf16"] == ["params/blk/e"]
    assert man["leaves"]["red/params/w/checksums"]["dtype"] == "uint32"
    assert man["leaves"]["step"] == {"shape": [], "dtype": "int32",
                                     "checksum": jck._np_checksum(np.int32(6)),
                                     "file_key": f"a{len(man['leaves']) - 1}"}
    js._stop_dispatcher()


def test_reference_checkpoint_restores_bitwise_in_the_port(tmp_path):
    (_, jstate), (_, tstate) = _pair_states(dirty_rows=(5,))
    JCkpt(tmp_path).save(6, jstate, blocking=True)
    template = dataclasses.replace(tstate, step=0, opt=dict(tstate.opt, count=0))
    got = CheckpointManager(tmp_path, device="cpu").restore_into(template)
    assert got.step == 6 and got.opt["count"] == 5
    _assert_states_equal(jstate, got)


def test_port_checkpoint_restores_bitwise_in_the_reference(tmp_path):
    (_, jstate), (_, tstate) = _pair_states(dirty_rows=(5,))
    CheckpointManager(tmp_path, device="cpu").save(6, tstate)
    got = JCkpt(tmp_path).restore_into(jax.eval_shape(lambda: jstate))
    assert int(got.step) == 6
    _assert_states_equal(got, tstate)


def test_smoke_model_checkpoints_cross_restore(tmp_path):
    """A trained smoke llama3.2-3b state: the port's checkpoint restores in
    the reference, whose re-save equals the port's files (key sets,
    shapes, dtypes, checksums), and restores back in the port bit for
    bit."""
    cfg = get_smoke("llama3.2-3b")
    opt = AdamW(lr=lambda s: 1e-3)
    meta = Model(cfg, torch.device("meta")).init()
    store = ProtectedStore(RedundancyPolicy.single("vilamb", period_steps=2,
                                                   lanes_per_block=SMOKE_L),
                           device="cpu").attach(protected_structs(meta, opt.init(meta)))
    tr = Trainer(model=build_model(cfg, "cpu"), opt=opt, store=store, scrub_period_steps=0)
    data = SyntheticPipeline(cfg, ShapeConfig("t", 16, 2, "train"), seed=0, device="cpu")
    state = tr.run(tr.init_state(torch.Generator().manual_seed(0)), data, 3)
    CheckpointManager(tmp_path / "t", device="cpu").save(3, state, store=store)

    jm = jbuild(jget_smoke("llama3.2-3b"))
    jopt = JAdamW(lr=lambda s: 1e-3)
    p0 = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    js = JStore(JPolicy.single("vilamb", period_steps=2, lanes_per_block=SMOKE_L,
                               precompile=False)).attach(
        jstructs(p0, jax.eval_shape(jopt.init, p0)))
    jtr = JTrainer(model=jm, opt=jopt, store=js, scrub_period_steps=0)
    struct = jax.eval_shape(lambda: jtr.init_state(jax.random.PRNGKey(0)))
    jstate = JCkpt(tmp_path / "t").restore_into(struct)
    assert list(tck.state_leaves(state)) == _jkeys(jstate)
    _assert_states_equal(jstate, state)
    JCkpt(tmp_path / "j").save(3, jstate, blocking=True)
    _assert_same_files(tmp_path / "j", tmp_path / "t", 3)
    back = CheckpointManager(tmp_path / "j", device="cpu").restore_into(tr.state_struct())
    _assert_states_equal(jstate, back)
    js._stop_dispatcher()


# --------------------------------------------------------- restore_verified
def _fault(case, jstate, tstate, tmp_path):
    """Apply ``case`` to copies of both states (or to the saved files) and
    save them as step 7 beside a good step 6; returns the two dirs."""
    dirs = {}
    for pkg, state, mgr in (("j", jstate, JCkpt(tmp_path / "j", keep=5)),
                            ("t", tstate, CheckpointManager(tmp_path / "t", keep=5,
                                                            device="cpu"))):
        mgr.save(6, state, blocking=True)
        np_w = np.array(np.asarray(tstate.params["w"]) if pkg == "t"
                        else np.asarray(jstate.params["w"]))
        words = np_w.reshape(-1).view(np.uint32)
        red = state.red
        if case == "single":
            words[5 * L + 3] ^= 0xBAD
        elif case == "multi":
            words[4 * L + 3] ^= 0xBAD
            words[6 * L + 9] ^= 0x1
        elif case == "vulnerable":          # rows 5 dirty: blocks 10-11
            words[8 * L] ^= 0x40
        elif case == "meta":
            ck = np.array(np.asarray(convert.red_to_numpy({"x": red["m/w"]})["x"]["checksums"]
                                     if pkg == "t" else red["m/w"].checksums), np.uint32)
            ck[2] ^= 0x10000
            if pkg == "t":
                red = dict(red, **{"m/w": dataclasses.replace(
                    red["m/w"], checksums=torch.from_numpy(ck.view(np.int32)))})
            else:
                red = dict(red, **{"m/w": dataclasses.replace(
                    red["m/w"], checksums=jnp.asarray(ck))})
        w = (torch.from_numpy(np_w) if pkg == "t" else jnp.asarray(np_w))
        params = dict(state.params, w=w)
        if case == "missing":
            params = {k: v for k, v in params.items() if k != "blk"}
        mgr.save(7, dataclasses.replace(state, params=params, red=red), blocking=True)
        if case == "npz_byte":
            f = tmp_path / pkg / "step_7" / "state.npz"
            with open(f, "r+b") as fh:
                fh.seek(f.stat().st_size // 2)
                b = fh.read(1)
                fh.seek(-1, 1)
                fh.write(bytes([b[0] ^ 0xFF]))
        dirs[pkg] = mgr
    return dirs["j"], dirs["t"]


def _report(r):
    return (r.tried, r.step, r.repaired_blocks, r.lost_blocks,
            [(u.leaf, u.stripe, tuple(u.blocks), u.reason) for u in r.unrecoverable])


@pytest.mark.parametrize("case,tried", [
    ("clean", [(7, "ok")]),
    ("single", [(7, "ok_repaired")]),
    ("multi", [(7, "unrecoverable"), (6, "ok")]),
    ("vulnerable", [(7, "unrecoverable"), (6, "ok")]),
    ("meta", [(7, "meta_checksum"), (6, "ok")]),
    ("npz_byte", [(7, "file_checksum"), (6, "ok")]),
    ("missing", [(7, "load_failed"), (6, "ok")]),
])
def test_restore_verified_classifies_like_the_reference(tmp_path, case, tried):
    """The same faults give the same RestoreReport in both packages (tried,
    step, repaired and lost blocks, the UnrecoverableBlock records), and
    the restored states are equal bit for bit."""
    (js, jstate), (ts, tstate) = _pair_states(
        dirty_rows=(5,) if case == "vulnerable" else ())
    jmgr, tmgr = _fault(case, jstate, tstate, tmp_path)
    template = dataclasses.replace(tstate, step=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jgot = jmgr.restore_verified(jax.eval_shape(lambda: jstate), js)
        tgot = tmgr.restore_verified(template, ts)
    assert _report(jmgr.last_restore_report) == _report(tmgr.last_restore_report)
    assert tmgr.last_restore_report.tried == tried
    _assert_states_equal(jgot, tgot)
    if case == "single":
        assert tmgr.last_restore_report.repaired_blocks == 1
        _assert_states_equal(jstate, tgot)     # repaired to the saved bits


# ----------------------------------------------------------- port lifecycle
def _port_trainer(period=2):
    cfg = get_smoke("llama3.2-3b")
    opt = AdamW(lr=lambda s: 1e-3)
    meta = Model(cfg, torch.device("meta")).init()
    store = ProtectedStore(RedundancyPolicy.single("vilamb", period_steps=period,
                                                   lanes_per_block=SMOKE_L),
                           device="cpu").attach(protected_structs(meta, opt.init(meta)))
    tr = Trainer(model=build_model(cfg, "cpu"), opt=opt, store=store, scrub_period_steps=0)
    return tr, SyntheticPipeline(cfg, ShapeConfig("t", 16, 2, "train"), seed=0, device="cpu")


def test_restart_resumes_identically(tmp_path):
    """A checkpoint taken mid-run (an update in flight) and restored into a
    fresh trainer continues bit for bit: losses, params and moments."""
    tr, data = _port_trainer()
    st = tr.run(tr.init_state(torch.Generator().manual_seed(0)), data, 2)
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save(st.step, st, store=tr.store)
    cont, rest = [], []
    st_cont = tr.run(st, data, 2, on_step=lambda s, m: cont.append(float(m["loss"])))
    tr2, data2 = _port_trainer()
    st_re = mgr.restore_verified(tr2.state_struct(), tr2.store)
    assert mgr.last_restore_report.tried == [(2, "ok")] and st_re.step == 2
    st_re = tr2.run(st_re, data2, 2, on_step=lambda s, m: rest.append(float(m["loss"])))
    assert cont == rest
    for k, v in protected_leaves(st_cont.params, st_cont.opt).items():
        assert torch.equal(v.view(torch.uint8) if v.dtype == torch.bfloat16 else v,
                           protected_leaves(st_re.params, st_re.opt)[k].view(torch.uint8)
                           if v.dtype == torch.bfloat16
                           else protected_leaves(st_re.params, st_re.opt)[k]), k
    assert st_re.opt["count"] == st_cont.opt["count"] == 4


def test_corrupt_checkpoint_falls_back(tmp_path):
    (_, _), (_, state) = _pair_states()
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save(1, state)
    mgr.save(2, state)
    npz = tmp_path / "step_2" / "state.npz"
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    npz.write_bytes(bytes(raw))
    got = mgr.restore_flat()
    assert got is not None and got["__step__"] == 1


def test_corrupt_array_header_is_rejected(tmp_path):
    """A flipped dtype in an array's npy header (its bytes, and so the file
    checksum, unchanged) is held to the manifest and rejected."""
    (_, _), (_, state) = _pair_states()
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save(1, state)
    mgr.save(2, state)
    npz = tmp_path / "step_2" / "state.npz"
    raw = bytearray(npz.read_bytes())
    at = raw.index(b"'descr': '<f4'")
    raw[at + len("'descr': '<")] = ord("i")
    npz.write_bytes(bytes(raw))
    assert mgr.restore_flat()["__step__"] == 1


def test_async_save(tmp_path):
    (_, _), (_, state) = _pair_states()
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save(1, state, blocking=False)
    mgr.wait()
    assert mgr.steps() == [1]
    assert set(mgr.last_save) == {"step", "checksum_s", "copy_s", "write_s", "bytes"}


def test_async_save_failure_is_raised_by_wait(tmp_path, monkeypatch):
    (_, _), (_, state) = _pair_states()
    mgr = CheckpointManager(tmp_path, device="cpu")

    def full(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", full)
    mgr.save(1, state, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                      # raised once
    assert mgr.steps() == []


def test_gc_keeps_last_k(tmp_path):
    (_, _), (_, state) = _pair_states()
    mgr = CheckpointManager(tmp_path, keep=2, device="cpu")
    for s in (1, 2, 3, 4):
        mgr.save(s, state, blocking=True)
    assert mgr.steps() == [3, 4]


def test_no_checkpoint_restores_nothing(tmp_path):
    tr, _ = _port_trainer()
    mgr = CheckpointManager(tmp_path, device="cpu")
    assert mgr.restore_verified(tr.state_struct(), tr.store) is None
    assert mgr.last_restore_report == RestoreReport()


def test_save_and_restore_need_no_ml_dtypes(tmp_path):
    """bf16 leaves travel as uint16 bits; nothing imports ml_dtypes (the
    card machine has none)."""
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.ckpt import CheckpointManager\n"
        "from repro_torch.train import TrainState\n"
        "p = {'e': torch.arange(12, dtype=torch.float32).to(torch.bfloat16)}\n"
        "st = TrainState(params=p, opt={'m': {}, 'v': {}, 'count': 1}, red={}, step=3)\n"
        f"mgr = CheckpointManager({str(tmp_path)!r}, device='cpu')\n"
        "mgr.save(3, st)\n"
        "tmpl = TrainState(params={'e': torch.empty(12, dtype=torch.bfloat16)},\n"
        "                  opt={'m': {}, 'v': {}, 'count': 0}, red={}, step=0)\n"
        "got = mgr.restore_into(tmpl)\n"
        "assert torch.equal(got.params['e'], p['e']) and got.step == 3\n"
        "assert got.opt['count'] == 1\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_preemption_drain(tmp_path):
    """drain flushes (the battery), stops the clock, checkpoints; the
    drained state scrubs clean."""
    tr, data = _port_trainer()
    st = tr.run(tr.init_state(torch.Generator().manual_seed(0)), data, 3)
    h = PreemptionHandler()
    ckpt = CheckpointManager(tmp_path, device="cpu")
    st = h.drain(tr, st, ckpt)
    assert h.flush_seconds is not None and h.flush_seconds < 30
    assert ckpt.steps() == [st.step]
    assert sum(int(v.sum()) for v in tr.scrub_fn(st).values()) == 0


def test_preemption_handler_uninstall_restores_the_handlers():
    before = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGUSR1)
    h = PreemptionHandler().install()
    assert signal.getsignal(signal.SIGTERM) == h._on_signal
    os.kill(os.getpid(), signal.SIGUSR1)
    assert h.requested
    h.uninstall()
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGUSR1)) == before


def test_preemption_handler_exits_42_in_a_subprocess(tmp_path):
    """SIGUSR1 sets ``requested``; the drain writes a checkpoint that
    restores verified, and the process exits with the handler's code."""
    code = (
        "import os, signal, sys, torch\n"
        "sys.path.insert(0, 'tests')\n"
        "from test_torch_ckpt import _port_trainer\n"
        "from repro_torch.ckpt import CheckpointManager, PreemptionHandler\n"
        "tr, data = _port_trainer()\n"
        "h = PreemptionHandler().install()\n"
        "st = tr.run(tr.init_state(torch.Generator().manual_seed(0)), data, 2)\n"
        "os.kill(os.getpid(), signal.SIGUSR1)\n"
        "assert h.requested\n"
        f"st = h.drain(tr, st, CheckpointManager({str(tmp_path)!r}, device='cpu'))\n"
        "print('flushed', h.flush_seconds)\n"
        "sys.exit(h.exit_code)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep + str(ROOT / "tests"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 42, out.stderr
    assert out.stdout.startswith("flushed")
    tr, _ = _port_trainer()
    mgr = CheckpointManager(tmp_path, device="cpu")
    st = mgr.restore_verified(tr.state_struct(), tr.store)
    assert mgr.last_restore_report.tried == [(2, "ok")] and st.step == 2
