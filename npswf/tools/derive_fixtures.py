"""Derive SearchHighRes characterization fixtures (exact-arithmetic oracle).

Generates ``tests/data/searchhighres_fixtures.json`` from the independent
60-digit Decimal re-derivation of the TSpectrum::SearchHighRes algorithm
(golden/searchhighres_decimal.py). The committed file pins the float oracle
(golden/reference.py) and the batched device op (ops/peak_search.py): both must
reproduce every fixture's peak list exactly (tests/test_fixtures.py).

Every source spectrum is built from multiples of 1/8 so the values are exact
in float32, float64 AND Decimal — there is no representation slack anywhere
in the comparison chain.

Usage: python -m npswf.tools.derive_fixtures [--check]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

from npswf.golden.searchhighres_decimal import search_high_res_decimal

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "data",
    "searchhighres_fixtures.json")


def _eighths(values):
    """Round to multiples of 1/8 (exact in every representation used)."""
    return [round(v * 8.0) / 8.0 for v in values]


def _gauss(n, center, width, amp):
    return [amp * math.exp(-0.5 * ((i - center) / width) ** 2)
            for i in range(n)]


def _add(*vecs):
    return [sum(vs) for vs in zip(*vecs)]


def _mf_production_source():
    """A production-shape (T=110) spectrum: the fp64 oracle's matched filter
    on a synthetic 3-pulse fADC waveform, float32-quantized exactly the way
    the reference bins it into a TH1F before Search (ref TEST_2.C:173-179).

    float32 values are exact in float64 and enter the Decimal oracle via the
    exact binary conversion, so this fixture has the same zero-slack property
    as the hand-built 1/8-multiple cases while exercising the real input
    distribution: MF noise floor, window-min subtraction offset, pileup
    shoulders, and float32 quantization of near-threshold values.
    """
    from npswf.core.config import NPSConfig
    from npswf.core.calibration import (natural_cubic_spline_coeffs,
                                        spline_eval_np,
                                        synthetic_pulse_shape)
    from npswf.golden.reference import matched_filter_golden
    cfg = NPSConfig()
    T = cfg.ntime
    # narrow fADC template (fast scintillation component): pulses stay
    # resolvable so the fixture pins multi-peak behavior, including a late
    # near-threshold pulse (amp 18 is accepted; 10 would be rejected)
    shape = synthetic_pulse_shape(cfg, 40.0, 1.2, 3.0)
    x = np.arange(T, dtype=np.float64)
    rng = np.random.default_rng(101)
    sig = 2.0 + 0.4 * rng.standard_normal(T)
    coeffs = natural_cubic_spline_coeffs(x, shape)
    tr = float(np.argmax(shape))
    for t0, a0 in ((25.5, 140.0), (45.25, 70.0), (70.0, 35.0), (92.0, 18.0)):
        arg = x - (t0 - tr)
        g = (arg > cfg.spline_gate_lo) & (arg < T - 1)
        sig += np.where(g, a0 * spline_eval_np(coeffs, 0.0, arg), 0.0)
    # matched-filter kernel derived the way the calibration layer does
    imax = int(np.argmax(shape))
    idx = np.clip(np.arange(cfg.mfwidth) + imax - cfg.mfleft, 0, T - 1)
    kern_rev = shape[idx][::-1].copy()
    mfint = float(shape[idx].sum())
    mf = matched_filter_golden(cfg, sig, float(sig.min()), kern_rev, mfint)
    return [float(np.float32(v)) for v in mf]


def build_sources():
    n = 48
    nprod = 110     # production spectrum length (cfg.ntime)
    cases = []
    cases.append(dict(
        name="single_peak",
        note="one clean pulse mid-spectrum",
        source=_eighths(_gauss(n, 20.0, 2.5, 120.0)),
        max_peaks=12))
    cases.append(dict(
        name="two_overlapping",
        note="pileup: two pulses 6 bins apart, smoothing must not merge them "
             "into a wrong centroid",
        source=_eighths(_add(_gauss(n, 16.0, 2.2, 100.0),
                             _gauss(n, 27.0, 2.2, 70.0))),
        max_peaks=12))
    cases.append(dict(
        name="near_threshold_pair",
        note="one large pulse plus one small one chosen to sit just ABOVE the "
             "2% decon threshold; regression-sensitive to the round-1 "
             "min(1,.)/100 clamp bug",
        source=_eighths(_add(_gauss(n, 14.0, 2.0, 160.0),
                             _gauss(n, 36.0, 2.0, 7.0))),
        max_peaks=12))
    cases.append(dict(
        name="subthreshold_rejected",
        note="the small pulse sits between 1% and 2% of the decon max: the "
             "old clamp accepted it, the correct threshold must reject it",
        source=_eighths(_add(_gauss(n, 14.0, 2.0, 160.0),
                             _gauss(n, 36.0, 2.0, 2.5))),
        max_peaks=12))
    cases.append(dict(
        name="edge_peak_with_slope",
        note="peak near the left edge; the first int(2*sigma+.5) samples "
             "slope downward so the clamped straight-line extension is live",
        source=_eighths(_add(_gauss(n, 6.0, 2.0, 90.0),
                             [max(0.0, 12.0 - 1.5 * i) for i in range(n)])),
        max_peaks=12))
    cases.append(dict(
        name="flat_zero",
        note="all-zero spectrum: no peaks, no division blowups",
        source=[0.0] * n,
        max_peaks=12))
    cases.append(dict(
        name="capped_ordering",
        note="five resolvable peaks but max_peaks=3: exercises the "
             "amplitude-descending capped insertion (TSpectrum ordering)",
        source=_eighths(_add(_gauss(n, 8.0, 1.8, 60.0),
                             _gauss(n, 17.0, 1.8, 140.0),
                             _gauss(n, 26.0, 1.8, 90.0),
                             _gauss(n, 35.0, 1.8, 120.0),
                             _gauss(n, 43.0, 1.8, 75.0))),
        max_peaks=3))
    # ---- production-shape cases (T=110) ------------------------------------
    cases.append(dict(
        name="prod_mf_float32",
        note="T=110 matched-filter output of a 3-pulse synthetic waveform, "
             "float32-quantized the way the reference's TH1F path does "
             "(ref TEST_2.C:173-179): pins the search on the real input "
             "distribution, not just hand-built spectra",
        source=_mf_production_source(),
        max_peaks=12))
    cases.append(dict(
        name="prod_cap_14_peaks",
        note="14 resolvable peaks at production width with max_peaks=12: "
             "exercises the cap + amplitude-descending insertion at the "
             "reference's actual spectrum length",
        source=_eighths(_add(*[
            _gauss(nprod, 6.0 + 7.4 * k, 1.9, float(a)) for k, a in
            enumerate((60, 140, 90, 120, 75, 155, 45, 130, 85, 110,
                       70, 100, 50, 95))])),
        max_peaks=12))
    cases.append(dict(
        name="prod_sigma3_threshold5",
        note="sigma=3, threshold=5% at T=110: pins every sigma-parameterized "
             "constant (shift=int(7s+.5)=21, kfit=int(2s+.5)=6, the "
             "quantized response extent) and a non-default threshold — "
             "frozen at sigma=2/2% everywhere else",
        source=_eighths(_add(_gauss(nprod, 30.0, 3.2, 120.0),
                             _gauss(nprod, 52.0, 3.0, 55.0),
                             _gauss(nprod, 85.0, 3.5, 18.0))),
        sigma=3.0, threshold_frac=0.05,
        max_peaks=12))
    cases.append(dict(
        name="prod_sigma1p5",
        note="sigma=1.5 (shift=11, kfit=3): narrow-response quantization and "
             "an odd 7*sigma rounding",
        source=_eighths(_add(_gauss(nprod, 25.0, 1.6, 100.0),
                             _gauss(nprod, 33.0, 1.5, 65.0),
                             _gauss(nprod, 70.0, 1.7, 40.0))),
        sigma=1.5,
        max_peaks=12))
    cases.append(dict(
        name="negative_baseline",
        note="spectrum with negative entries (post matched-filter values can "
             "dip below zero before the window-min subtraction); extension "
             "clamps at zero",
        source=_eighths(_add(_gauss(n, 22.0, 2.5, 80.0),
                             [-3.0 + 0.125 * (i % 5) for i in range(n)])),
        max_peaks=12))
    return cases


def derive():
    fixtures = []
    for case in build_sources():
        sigma = case.get("sigma", 2.0)
        threshold_frac = case.get("threshold_frac", 0.02)
        res = search_high_res_decimal(
            case["source"], sigma=sigma, threshold_pct=100.0 * threshold_frac,
            max_peaks=case["max_peaks"], decon_iterations=3, aver_window=3)
        fixtures.append(dict(
            name=case["name"], note=case["note"], source=case["source"],
            sigma=sigma, threshold_frac=threshold_frac,
            max_peaks=case["max_peaks"],
            decon_iterations=3, aver_window=3,
            expected_pos_x=res["pos_x"], expected_pos_y=res["pos_y"],
            decon=res["decon"][:0],  # intermediates omitted from the file;
                                     # re-derivable via searchhighres_decimal
        ))
        print(f"{case['name']:24s} -> {len(res['pos_x'])} peaks "
              f"at {res['pos_x']}", file=sys.stderr)
    return dict(
        provenance="derived by npswf/golden/searchhighres_decimal.py "
                   "(60-digit Decimal re-derivation of SearchHighRes, "
                   "independent of golden/reference.py); regenerate with "
                   "python -m npswf.tools.derive_fixtures",
        fixtures=fixtures)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--check", action="store_true",
                    help="verify the committed file matches a fresh derivation")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    data = derive()
    if args.check:
        with open(args.out) as f:
            committed = json.load(f)
        if committed != data:
            print("MISMATCH: committed fixtures differ from fresh derivation")
            return 1
        print("fixtures up to date")
        return 0
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(data, f, indent=1)
    print(f"wrote {len(data['fixtures'])} fixtures -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
