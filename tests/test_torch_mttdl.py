"""The port's reliability model (``repro_torch.core.mttdl``) against the
reference's, on the CPU: every function returns the same float for the
same inputs (exact equality), and the uplift measured from the port's own
dirty statistics falls with the update period, as paper §4.8 says."""
import numpy as np
import pytest
import torch

from repro.core import mttdl as jm
from repro_torch.configs import get_smoke
from repro_torch.core import ProtectedStore, RedundancyPolicy
from repro_torch.core import mttdl as tm
from repro_torch.data import SyntheticPipeline
from repro_torch.models import Model, ShapeConfig, build_model
from repro_torch.optim import AdamW
from repro_torch.train import Trainer, protected_structs

VALUES = [(1e6, 1000, 10, 5), (3.7e9, 491_520, 0, 4), (1.0, 1, 0.25, 4),
          (8.64e4, 2_097_152, 1234.5, 4), (5e12, 7, 1e-15, 1)]


def _same(a, b):
    assert type(a) is type(b) and (a == b or (np.isnan(a) and np.isnan(b))), (a, b)


def test_paper_formulas():
    # paper: MTTDL_NoRed = MTTF/P ; MTTDL_Vilamb = MTTF/(V*N); uplift = P/(V*N)
    assert tm.mttdl_no_red(1e6, 1000) == 1e3
    assert tm.mttdl_vilamb(1e6, 10, 5) == 2e4
    assert tm.mttdl_uplift(1000, 10, 5) == 20.0
    assert tm.mttdl_uplift(1000, 0, 5) == float("inf")


@pytest.mark.parametrize("mttf,total,vuln,n", VALUES)
def test_closed_forms_equal_reference(mttf, total, vuln, n):
    _same(tm.mttdl_no_red(mttf, total), jm.mttdl_no_red(mttf, total))
    _same(tm.mttdl_no_red(mttf, 0), jm.mttdl_no_red(mttf, 0))
    _same(tm.mttdl_vilamb(mttf, vuln, n), jm.mttdl_vilamb(mttf, vuln, n))
    _same(tm.mttdl_uplift(total, vuln, n), jm.mttdl_uplift(total, vuln, n))


@pytest.mark.parametrize("mttf,total,vuln,n", VALUES)
@pytest.mark.parametrize("latency", [0.0, 1.5, 240.0, -3.0])
def test_measured_forms_equal_reference(mttf, total, vuln, n, latency):
    stripes = max(total // n, 1)
    _same(tm.mttdl_measured(mttf, vuln, n, stripes, latency),
          jm.mttdl_measured(mttf, vuln, n, stripes, latency))
    for measured in (None, {"n": 0, "mean_s": 9.0}, {"n": 3, "mean_s": 0.125}):
        _same(tm.mttdl_measured_live(mttf, vuln, n, stripes, latency, measured),
              jm.mttdl_measured_live(mttf, vuln, n, stripes, latency, measured))


@pytest.mark.parametrize("lat", [[], [None, 3, 7.5], [240, 1, 1, 2]])
def test_latency_stats_equal_reference(lat):
    for step_s in (1.0, 0.0625):
        assert tm.detection_latency_stats(lat, step_s) == \
            jm.detection_latency_stats(lat, step_s)


def test_averages_and_aggregate_equal_reference():
    rng = np.random.default_rng(0)
    trace = [{n: {"vulnerable_stripes": int(rng.integers(0, 40)),
                  "dirty_blocks": int(rng.integers(0, 160)),
                  "total_blocks": 160, "total_stripes": 40}
              for n in ("params/embed", "m/embed", "v/w")} for _ in range(7)]
    ta, ja = tm.average_stats(trace), jm.average_stats(trace)
    assert ta == ja
    for n in (1, 4, 5):
        _same(tm.aggregate_uplift(ta, n), jm.aggregate_uplift(ja, n))
    assert tm.average_stats([]) == jm.average_stats([]) == {}


def test_uplift_decreases_with_period():
    """Longer update periods leave more vulnerable stripes and so a lower
    MTTDL uplift, measured from the port's dirty statistics over a smoke
    model's training (blocking tick), with the same floats from both
    packages' formulas."""
    cfg = get_smoke("llama3.2-3b")
    model = build_model(cfg, "cpu")
    opt = AdamW(lr=lambda s: 1e-3)
    meta = Model(cfg, torch.device("meta")).init()
    data = SyntheticPipeline(cfg, ShapeConfig("t", 16, 1, "train"), seed=0, device="cpu")
    uplifts = {}
    for period in (1, 4):
        store = ProtectedStore(RedundancyPolicy.single(
            "vilamb", period_steps=period, lanes_per_block=512, async_tick=False),
            device="cpu").attach(protected_structs(meta, opt.init(meta)))
        tr = Trainer(model=model, opt=opt, store=store, scrub_period_steps=0)
        trace = []
        tr.run(tr.init_state(torch.Generator().manual_seed(0)), data, 5,
               on_step=lambda s, _: trace.append(
                   {n: {k: int(v) for k, v in d.items()}
                    for n, d in store.dirty_stats(s.red).items()}))
        avg = tm.average_stats(trace)
        assert avg == jm.average_stats(trace)
        uplifts[period] = tm.aggregate_uplift(avg, 4)
        _same(uplifts[period], jm.aggregate_uplift(avg, 4))
    assert uplifts[1] >= uplifts[4]
    assert uplifts[1] > 1.0
