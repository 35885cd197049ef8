"""repro_torch stands alone: it imports no JAX and nothing of ``repro``."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        parts = ("repro_torch",) + p.relative_to(PKG).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def test_import_pulls_in_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


IMPORT_RE = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|from\s+repro(\.|\s)|"
                       r"import\s+repro(\.|\s|$))", re.M)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_or_repro(path):
    assert not IMPORT_RE.findall(path.read_text()), path


def test_store_defaults_to_the_card():
    from repro_torch.core import ProtectedStore
    if torch.cuda.is_available():
        assert ProtectedStore().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ProtectedStore()


ENTRY_POINTS = {
    "RedundancyEngine": lambda core: core.RedundancyEngine(
        {"x": torch.zeros(8, 128)}, core.RedundancyConfig(lanes_per_block=128)),
    "leaves_from_numpy": lambda core: core.convert.leaves_from_numpy(
        {"x": np.zeros(4, np.float32)}),
    "red_from_numpy": lambda core: core.convert.red_from_numpy(
        {"x": {f: np.zeros(1, np.uint32) for f in
               ("checksums", "parity", "dirty", "shadow", "meta_ck")}}),
}




def _smoke():
    from repro_torch.configs import get_smoke
    return get_smoke("llama3.2-3b")


def _trainer(core):
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train import Trainer
    return Trainer(model=build_model(_smoke()), opt=AdamW(lr=lambda s: 1e-3))


def _adamw_init(core):
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    return AdamW(lr=lambda s: 1e-3).init(build_model(_smoke()).init())


def _pipeline(core):
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models import ShapeConfig
    return SyntheticPipeline(_smoke(), ShapeConfig("t", 8, 1, "train"))


def _launch_train(core):
    from repro_torch.launch import train
    return train.main(["--arch", "llama3.2-3b", "--smoke", "--steps", "1"])


def _checkpoint_manager(core):
    import tempfile
    from repro_torch.ckpt import CheckpointManager
    with tempfile.TemporaryDirectory() as d:
        return CheckpointManager(d)


def _launch_train_resume(core):
    import tempfile
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as d:
        return train.main(["--arch", "llama3.2-3b", "--smoke", "--steps", "1",
                           "--ckpt-dir", d, "--resume"])


def _launch_serve_moe(core):
    from repro_torch.launch import serve
    return serve.main(["--arch", "qwen3-moe-235b-a22b", "--smoke"])


def _launch_train_moe(core):
    from repro_torch.launch import train
    return train.main(["--arch", "arctic-480b", "--smoke", "--steps", "1"])


def _faults_smoke(core):
    from repro_torch.faults import __main__ as faults_cli
    return faults_cli.main(["--smoke"])


ENTRY_POINTS.update({"faults --smoke": _faults_smoke})
ENTRY_POINTS.update({"launch.serve qwen3-moe": _launch_serve_moe,
                     "launch.train arctic": _launch_train_moe})
ENTRY_POINTS.update({"Trainer": _trainer, "AdamW.init": _adamw_init,
                     "SyntheticPipeline": _pipeline, "launch.train": _launch_train,
                     "CheckpointManager": _checkpoint_manager,
                     "launch.train --resume": _launch_train_resume})


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry):
    """Without ``device=`` every entry point targets the card, never the CPU."""
    from repro_torch import core
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is exercised on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[entry](core)


def test_engine_refuses_a_leaf_on_another_device():
    from repro_torch.core import RedundancyConfig, RedundancyEngine
    leaf = torch.zeros(8, 128)
    eng = RedundancyEngine({"x": leaf}, RedundancyConfig(lanes_per_block=128),
                           device="cpu")
    red = eng.init({"x": leaf})
    off = {"x": torch.empty(8, 128, device="meta")}
    for call in (lambda: eng.init(off), lambda: eng.redundancy_step(off, red),
                 lambda: eng.scrub(off, red)):
        with pytest.raises(ValueError, match="lies on meta"):
            call()
