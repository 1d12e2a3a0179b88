"""SearchHighRes characterization fixtures.

The committed fixture file tests/data/searchhighres_fixtures.json was derived
by an INDEPENDENT 60-digit-Decimal re-derivation of the TSpectrum
SearchHighRes algorithm (golden/searchhighres_decimal.py — different
arithmetic, different code structure than the float oracle). Both the float
oracle AND the batched device op must reproduce every fixture's peak list
exactly; one test re-derives a fixture in-process to guard the committed
file's freshness.
"""
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest

from npswf.core.config import NPSConfig
from npswf.golden.reference import tspectrum_search_golden
from npswf.ops.peak_search import tspectrum_search

FIXTURE_PATH = os.path.join(os.path.dirname(__file__), "data",
                            "searchhighres_fixtures.json")

with open(FIXTURE_PATH) as f:
    _FIXTURES = json.load(f)["fixtures"]


@pytest.mark.parametrize("fx", _FIXTURES, ids=[f["name"] for f in _FIXTURES])
def test_oracle_reproduces_decimal_fixture(fx):
    pos_x, pos_y = tspectrum_search_golden(
        np.asarray(fx["source"]), sigma=fx["sigma"],
        threshold_frac=fx["threshold_frac"], max_peaks=fx["max_peaks"],
        decon_iterations=fx["decon_iterations"], aver_window=fx["aver_window"])
    assert list(pos_x) == fx["expected_pos_x"], fx["note"]
    assert list(pos_y) == fx["expected_pos_y"], fx["note"]


@pytest.mark.parametrize("fx", _FIXTURES, ids=[f["name"] for f in _FIXTURES])
def test_batched_op_reproduces_decimal_fixture(fx, cfg):
    c = cfg.replace(spec_sigma=fx["sigma"], specthres=fx["threshold_frac"],
                    maxwfpulses=fx["max_peaks"],
                    spec_decon_iterations=fx["decon_iterations"],
                    spec_aver_window=fx["aver_window"])
    src = jnp.asarray(np.asarray(fx["source"], np.float64))[None, :]
    px, py, valid = tspectrum_search(c, src)
    v = np.asarray(valid[0])
    assert list(np.asarray(px[0])[v]) == fx["expected_pos_x"], fx["note"]
    assert list(np.asarray(py[0])[v]) == fx["expected_pos_y"], fx["note"]


def test_fixture_file_is_fresh():
    """Re-derive one nontrivial fixture with the Decimal implementation and
    compare against the committed file (guards stale regeneration)."""
    from npswf.golden.searchhighres_decimal import search_high_res_decimal
    fx = next(f for f in _FIXTURES if f["name"] == "capped_ordering")
    res = search_high_res_decimal(
        fx["source"], sigma=fx["sigma"],
        threshold_pct=100.0 * fx["threshold_frac"],
        max_peaks=fx["max_peaks"],
        decon_iterations=fx["decon_iterations"],
        aver_window=fx["aver_window"])
    assert res["pos_x"] == fx["expected_pos_x"]
    assert res["pos_y"] == fx["expected_pos_y"]


def test_subthreshold_fixture_brackets_the_threshold():
    """The 'subthreshold_rejected' fixture sits between 1% and 2% of the
    decon max: the round-1 min(1,.)/100 clamp would have accepted it. This
    pins the acceptance constant itself, not just the pipeline around it."""
    fx = next(f for f in _FIXTURES if f["name"] == "subthreshold_rejected")
    src = np.asarray(fx["source"])
    px_2pct, _ = tspectrum_search_golden(src, sigma=2.0, threshold_frac=0.02)
    px_1pct, _ = tspectrum_search_golden(src, sigma=2.0, threshold_frac=0.01)
    assert len(px_2pct) == 1          # correct 2% threshold rejects the bump
    assert len(px_1pct) == 2          # the old effective 1% accepted it
