"""Every dry-run cell at smoke size on the (2, 16, 16) production mesh,
on the CPU (``tests/_torch_dryrun_cells.py``: ``ok`` with its record, or
the reference's skip string)."""
import pytest

import _torch_helpers  # noqa: F401  (torch's threads: each worker's share)
from _torch_dryrun_cells import ARCHS, check_cell
from repro_torch.models.config import SHAPES


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_at_smoke_size_multi_pod(monkeypatch, tmp_path, arch, shape_name):
    check_cell(monkeypatch, tmp_path, arch, shape_name, multi=True)
