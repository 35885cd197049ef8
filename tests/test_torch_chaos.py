"""The port's chaos soak against the reference's, on the CPU.

(a) The machine-local smoke soak at seed 0 from the reference's own leaf,
beside the reference's run in this process (as tests/test_health.py runs
it).  The reference's tick is asynchronous on the CPU: its probes and
updates land when the runtime gets to them, and five runs of its soak on a
loaded host gave 77-95 ticks.  So only the fields that came out the same in
all five are held equal (``STABLE``).  ``ticks`` is not among them, and the
spot reads draw from the same stream as the writes, so the two runs write
different rows after the first tick that differs: the port's final leaf is
held to its own mirror, and its redundancy after the final flush to a
recompute by the reference's store from that leaf, bit for bit.

(b) The schedule, phase for phase, against the reference's.  (c) The
sharded smoke soak on a simulated mesh, held to the soak's invariants (the
reference's sharded soak takes minutes in its 8-device process).  (d) The
machine-local and sharded soaks at 4x the reference's rows, with the
budgets scaled: every repair, coverage and drain loop within the reference
size's tick bounds.  (e) The CLI's ``--chaos`` pass.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_red_equal
from repro.core import ProtectedStore as JStore
from repro.core import RedundancyPolicy as JPolicy
from repro.faults import ChaosSchedule as JSchedule
from repro.faults import StormPhase as JPhase
from repro.faults.chaos import _ChaosRunner as JRunner
from repro_torch.faults import ChaosResult, ChaosSchedule, StormPhase, run_chaos_soak
from repro_torch.faults.chaos import _ChaosRunner

ROOT = Path(__file__).resolve().parents[1]

# The ChaosResult fields equal in five runs of the reference's
# machine-local smoke soak on a loaded 8-core host (the others, ticks,
# ladder_actions, reads_checked, deadline_fired, detect_latency_stats and
# mttdl_live_s, varied with the reference's asynchronous tick).
STABLE = ("seed", "steps", "phases_run", "silent_violations",
          "violations_reported", "backpressure_events", "reads_typed_errors",
          "reads_stale", "bitflips_injected", "bitflips_repaired",
          "crash_restores", "named_lost_blocks", "named_lost_rows_restored",
          "rebuild_done", "remesh_done", "final_clean", "final_bitwise",
          "recovery_ticks", "failures")

SHARDED_KINDS = ("traffic", "bitflips", "traffic", "straggler", "crash",
                 "traffic", "quiesce", "shard_loss", "remesh", "traffic",
                 "drain")

# The schedule's tick bounds (repro.faults.chaos): a repair or a coverage
# wait, the remesh phase beyond its nominal steps, the drain.
QUIET_BOUND, REMESH_EXTRA, DRAIN_BOUND = 96, 192, 256


def _phases(s):
    return [(p.kind, p.steps, p.n, p.step_time) for p in s.phases]


def test_machine_local_soak_matches_reference():
    w0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (64, 2048), jnp.float32))
    jr = JRunner(JSchedule.default(0, sharded=False, smoke=True), sharded=False)
    jres = jr.run()
    tr = _ChaosRunner(ChaosSchedule.default(0, sharded=False, smoke=True),
                      sharded=False, device="cpu", initial=w0)
    res = tr.run()
    assert jres.ok(), jres.summary()
    assert res.ok(), res.summary()
    for f in STABLE:
        assert getattr(res, f) == getattr(jres, f), (f, getattr(res, f), getattr(jres, f))
    assert res.bitflips_injected == 2 and res.crash_restores == 1
    # Invariant (c) at the port's own mirror, bitwise.
    leaf = tr.leaves["w"].numpy()
    np.testing.assert_array_equal(leaf.view(np.uint32), tr.mirror.view(np.uint32))
    # The redundancy after the final flush: the reference's store recomputes
    # it from the port's final leaf (dirty and shadow empty in both).
    pol = JPolicy.single("vilamb", period_steps=2, lanes_per_block=128,
                         precompile=False)
    jleaves = {"w": jnp.asarray(np.array(leaf))}
    want = JStore(pol).attach(jleaves).init(jleaves)
    assert_red_equal(want, tr.red, "final flush vs recompute")
    assert not np.asarray(jr.red["w"].dirty).any()
    assert not np.asarray(jr.red["w"].shadow).any()


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("sharded", [True, False])
def test_schedule_matches_reference(sharded, smoke):
    """The port's twin of test_chaos_schedule_is_seeded_and_composable:
    the default schedule is the reference's, entry for entry."""
    a = ChaosSchedule.default(3, sharded=sharded, smoke=smoke)
    b = ChaosSchedule.default(3, sharded=sharded, smoke=smoke)
    want = JSchedule.default(3, sharded=sharded, smoke=smoke)
    assert _phases(a) == _phases(b) == _phases(want)
    assert a.seed == want.seed == 3
    kinds = {p.kind for p in a.phases}
    assert {"bitflips", "straggler", "crash", "drain"} <= kinds
    assert sharded == ({"quiesce", "shard_loss", "remesh"} <= kinds)
    custom = ChaosSchedule([StormPhase("traffic", steps=2), StormPhase("drain")], seed=9)
    jcustom = JSchedule([JPhase("traffic", steps=2), JPhase("drain")], seed=9)
    assert custom.phases[0].steps == 2 and custom.seed == 9
    assert _phases(custom) == _phases(jcustom)


def test_result_summary_matches_reference():
    """ChaosResult's verdict and summary line are the reference's."""
    from repro.faults import ChaosResult as JResult
    kw = dict(seed=4, ticks=58, phases_run=("traffic",), violations_reported=2,
              ladder_actions=3, reads_checked=22, reads_typed_errors=2,
              deadline_fired=1, named_lost_blocks=48, final_clean=True,
              final_bitwise=True, mttdl_live_s=1.39e14)
    for extra in ({}, {"failures": ("drain: breakers never recovered",)},
                  {"reads_stale": 1}, {"remesh_done": False}):
        a, b = ChaosResult(**kw, **extra), JResult(**kw, **extra)
        assert a.ok() == b.ok() and a.summary() == b.summary(), (a.summary(), b.summary())


def _sweep_ticks(runner):
    pat = runner.store.patroller
    return -(-runner.store.metas["w"].n_blocks // pat.window["w"])


@pytest.mark.parametrize("rows", [64, 256], ids=["reference_rows", "4x_rows"])
def test_sharded_soak_keeps_invariants(rows):
    """The whole sharded schedule on a simulated (1, 2, 2) mesh grown to
    (2, 2, 2): the soak's invariants, the rebuild and the migration done,
    every loop within the reference size's bounds (the budgets scale with
    the leaf)."""
    tr = _ChaosRunner(ChaosSchedule.default(0, sharded=True, smoke=True),
                      sharded=True, device="cpu", n_rows=rows)
    assert tr.store.shard_factor("w") == 4 and tr.store.geometry_version == 0
    sweep = _sweep_ticks(tr)
    res = tr.run()
    assert res.ok(), res.summary()
    assert res.phases_run == SHARDED_KINDS
    assert res.rebuild_done and res.remesh_done and res.final_bitwise and res.final_clean
    assert res.bitflips_repaired == res.bitflips_injected == 2
    assert res.crash_restores == 1 and res.reads_checked > 0
    assert res.reads_stale == 0 and res.silent_violations == 0
    assert tr.store.shard_factor("w") == 8 and tr.store.geometry_version == 1
    assert tr.store.policy.patrol_bytes_per_tick == 16384 * rows // 64
    assert sweep == 8, sweep
    ticks = {p["kind"]: len(p["ticks"]) for p in tr.timings["phases"]}
    assert ticks["bitflips"] <= QUIET_BOUND and ticks["quiesce"] <= QUIET_BOUND
    assert ticks["remesh"] <= 6 * 4 + REMESH_EXTRA and ticks["drain"] <= DRAIN_BOUND
    np.testing.assert_array_equal(tr.leaves["w"].numpy().view(np.uint32),
                                  tr.mirror.view(np.uint32))


def test_machine_local_soak_at_4x_rows_keeps_bounds():
    """The machine-local soak at 4x the reference's rows: the patrol budget
    4x the reference's, so a sweep takes the reference's ticks, and the
    bitflips' repair and the drain finish within its bounds."""
    small = _ChaosRunner(ChaosSchedule.default(0, sharded=False, smoke=True),
                         sharded=False, device="cpu")
    big = _ChaosRunner(ChaosSchedule.default(0, sharded=False, smoke=True),
                       sharded=False, device="cpu", n_rows=256)
    assert big.store.policy.patrol_bytes_per_tick == 4 * small.store.policy.patrol_bytes_per_tick
    assert _sweep_ticks(big) == _sweep_ticks(small)
    res = big.run()
    assert res.ok(), res.summary()
    assert res.bitflips_repaired == res.bitflips_injected == 2 and res.crash_restores == 1
    ticks = {p["kind"]: len(p["ticks"]) for p in big.timings["phases"]}
    assert ticks["bitflips"] <= QUIET_BOUND and ticks["drain"] <= DRAIN_BOUND


def test_initial_leaf_and_sizes_are_checked():
    """A leaf of another shape is refused; a given leaf becomes the mirror
    without a copy; the default leaf is drawn from numpy seeded with the
    schedule's seed, apart from the runner's stream."""
    with pytest.raises(ValueError, match="initial leaf"):
        _ChaosRunner(ChaosSchedule.default(0, sharded=False), sharded=False,
                     device="cpu", initial=np.zeros((8, 2048), np.float32))
    w = np.zeros((64, 2048), np.float32)
    assert _ChaosRunner(ChaosSchedule.default(0, sharded=False), sharded=False,
                        device="cpu", initial=w).mirror is w
    tr = _ChaosRunner(ChaosSchedule.default(5, sharded=False), sharded=False, device="cpu")
    want = np.random.default_rng(5).standard_normal((64, 2048), dtype=np.float32)
    np.testing.assert_array_equal(tr.mirror, want)
    assert torch.equal(tr.leaves["w"], torch.from_numpy(want))
    assert tr.rng.random() == np.random.default_rng(5).random()


def test_chaos_cli_runs_the_sharded_soak():
    """``python -m repro_torch.faults --chaos --smoke --device cpu`` in a
    process of its own: exit 0 and the reference's two line forms."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.faults", "--chaos",
                          "--smoke", "--device", "cpu"],
                         capture_output=True, text=True, env=env, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("== chaos soak (") and lines[0].endswith(") ==")
    soak = [ln for ln in lines if ln.startswith("  chaos soak: ")]
    assert len(soak) == 1 and soak[0].startswith("  chaos soak: seed=0 ")
    assert soak[0].endswith(" OK") and "phases=11 " in soak[0]
    assert lines[-1].startswith("== chaos soak OK in ") and lines[-1].endswith("s ==")


def test_run_chaos_soak_is_the_runner():
    """run_chaos_soak gives the runner's result for the default schedule."""
    a = run_chaos_soak(1, sharded=False, smoke=True, device="cpu")
    b = _ChaosRunner(ChaosSchedule.default(1, sharded=False, smoke=True),
                     sharded=False, device="cpu").run()
    assert a.ok() and a.summary() == b.summary()
