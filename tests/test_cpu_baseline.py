"""The measured-baseline runner (tools/cpu_baseline.py) stays healthy.

The bench's vs_baseline denominator is measured by this runner at bench
time; this pins that it runs the full per-block reference path (search +
TRF fit) and reports sane figures on a tiny sample.
"""
import numpy as np
import pytest

from npswf.tools.cpu_baseline import measure_cpu_baseline
from npswf.utils.synthetic import make_events

pytest.importorskip("scipy.optimize")


def test_cpu_baseline_small_sample(cfg, cal):
    truth = make_events(cfg, cal, 1, occupancy=1.0, max_pulses=2,
                        pileup_prob=0.25, seed=7)
    res = measure_cpu_baseline(
        cfg, cal, truth.signal, np.asarray(cal.timeref, dtype=np.float64),
        time_budget_s=0.5, min_blocks=4)
    assert res["n_blocks"] >= 4
    assert res["n_fitted"] >= 1           # dense batch: every block pulses
    assert res["blocks_per_sec_1thread"] > 0
    assert res["blocks_per_sec_4thread"] == pytest.approx(
        4.0 * res["blocks_per_sec_1thread"])
    assert np.isfinite(res["mean_chi2"]) and res["mean_chi2"] > 0
    assert res["search_ms_per_block"] > 0 and res["fit_ms_per_block"] > 0
