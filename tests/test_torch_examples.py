"""The port's examples (``examples/*_torch.py``) on the CPU against the
JAX examples: the quickstart's checked-in rows are the reference's
``jax.random.randint`` draws, and where the printed numbers are counts
(blocks, stripes, dirty and vulnerable counts, detected, repaired and lost
blocks, restored steps, parameter counts, the MTTDL uplift) the lines
equal the JAX run's.  Each example defaults to the card."""
import contextlib
import importlib.util
import io
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "serve_decode", "recovery_demo", "train_with_vilamb")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, *argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _example(name).main(list(argv) + ["--device", "cpu"])
    return buf.getvalue().splitlines()


def test_quickstart_rows_are_the_references_draws():
    rows = [jax.random.randint(jax.random.PRNGKey(step), (16,), 0, 1024).tolist()
            for step in range(1, 9)]
    assert _example("quickstart").ROWS == rows


def test_quickstart_prints_the_references_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "examples/quickstart.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr
    assert _run("quickstart") == ref.stdout.splitlines()


def test_recovery_demo_prints_the_references_counts():
    """The lines of ``python examples/recovery_demo.py`` (JAX, CPU)."""
    assert _run("recovery_demo") == [
        "trained 4 steps, flushed, checkpointed.",
        "",
        "[1] injected a bit flip into params/embed block 2",
        "    scrub detected: 1 block(s)",
        "    parity repair: fixed=1 unrecoverable=0",
        "    training continued; loss finite: True",
        "",
        "[2] corruption on a DIRTY page: scrub detected=0 (silent — inside the "
        "paper's vulnerability window)",
        "    safety net: checkpoint restore at step 4 - the deterministic pipeline "
        "replays the exact stream from there.",
    ]


def test_train_with_vilamb_prints_the_references_counts():
    """The parameter count and the measured uplift of
    ``python examples/train_with_vilamb.py --steps 10`` (JAX, CPU)."""
    out = _run("train_with_vilamb", "--steps", "10")
    assert out[0] == "model: olmo-smoke (0.2M params)"
    assert out[-1] == ("done. scrub alarms: 0; measured MTTDL uplift over "
                       "No-Redundancy: 0.5x")


def test_serve_decode_prints_shapes_and_clean_scrubs():
    out = _run("serve_decode")
    waves = [ln for ln in out if ln.startswith("request wave")]
    assert len(waves) == 3
    assert all("(4, 40)" in ln and ln.endswith("KV scrub mismatches=0") for ln in waves)


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is exercised on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(name).main([])
