"""Shared check of the dry-run cell files: ``run_cell`` at smoke size
(the smoke configs of ``tests/test_torch_dryrun.py``: head dim 64, one
group of layers; the shapes cut) returns ``ok`` with its record written,
or the reference's skip string (``src/repro/launch/dryrun.py:36-40``).
Each cell traces the store's init, the step and the redundancy step on
the meta device over every shard of the mesh.  The (16, 16) and the
(2, 16, 16) mesh have a file each, so that each stays near half a minute
alone."""
import dataclasses
import json

from repro_torch.configs import get_smoke, list_archs
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES

ARCHS = list_archs()
SKIP = "SKIP(full-attention arch; 500k decode requires sub-quadratic mixer)"


def smoke(arch):
    cfg = dataclasses.replace(get_smoke(arch), head_dim=64)
    return dataclasses.replace(cfg, n_layers=cfg.group_size)


def check_cell(monkeypatch, tmp_path, arch: str, shape_name: str, multi: bool) -> None:
    sh = SHAPES[shape_name]
    small = {"train": (32, 16), "prefill": (32, 16), "decode": (64, 16)}[sh.kind]
    monkeypatch.setitem(dryrun.SHAPES, shape_name,
                        dataclasses.replace(sh, seq_len=small[0], global_batch=small[1]))
    rec = dryrun.run_cell(arch, shape_name, multi, out_dir=tmp_path, cfg_override=smoke(arch))
    if shape_name == "long_500k" and not smoke(arch).sub_quadratic:
        assert rec["status"] == SKIP
        return
    assert rec["status"] == "ok"
    assert rec["unrolled_exact"] and rec["collectives"]["total_bytes"] == 0
    mesh = "multi" if multi else "single"
    saved = json.loads((tmp_path / f"{arch}__{shape_name}__{mesh}.json").read_text())
    assert saved["roofline"] == rec["roofline"] and saved["hbm_model"] == rec["hbm_model"]
