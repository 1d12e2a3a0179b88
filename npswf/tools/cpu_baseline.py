"""Measured CPU reference baseline for the benchmark denominator.

The reference macro publishes no throughput numbers (BASELINE.md), so round-1
benchmarks divided by a documented *estimate* (1,200 blocks/s for the
4-thread ROOT macro). This module replaces the estimate with a measurement:
a single-thread CPU runner that performs, per block, exactly the stages the
reference's per-block loop performs (ref TEST_2.C:942-1020):

  1. matched filter + TH1F float32 quantization (ref :140-179),
  2. TSpectrum::SearchHighRes peak search + gates (ref :183-213),
  3. per-sample error model (ref :946-955),
  4. bounded chi^2 minimization from the same seeds/bounds the macro hands
     Minuit2 (ref :657-676), via scipy's trust-region-reflective
     least-squares — an independent production-grade optimizer standing in
     for Migrad.

Steps 1-2 use the repo's golden oracle (`golden/reference.py`), which is a
faithful scalar re-derivation of the macro's arithmetic — i.e. this measures
the reference *algorithm* on this host's CPU in numpy/scipy, the closest
defensible stand-in for the ROOT macro that can run in this environment
(ROOT is not installable here). The 4-thread figure is single-thread x 4,
mirroring the macro's `nthreads=4` default (ref TEST_2.C:283); RDataFrame's
implicit-MT scaling on this workload is embarrassingly parallel, so linear
extrapolation is, if anything, generous to the baseline.

Run directly for a standalone report:  python -m npswf.tools.cpu_baseline
"""
from __future__ import annotations

import json
import sys
import time
from typing import Dict

import numpy as np

from npswf.core.calibration import CalibrationBundle, spline_eval_np
from npswf.core.config import NPSConfig
from npswf.golden.reference import find_pulses_golden


def _error_model_np(cfg: NPSConfig, y: np.ndarray) -> np.ndarray:
    s = cfg.err_scale
    e = np.sqrt(np.abs(y * s / 2.0)) / s
    return np.where(e < 1.0, cfg.err_floor(), e)


def _fit_block_scipy(cfg: NPSConfig, least_squares, y: np.ndarray,
                     sigma: np.ndarray, coeffs: np.ndarray, x0: float,
                     t_seed: np.ndarray, a_seed: np.ndarray,
                     ped_seed: float) -> float:
    """Bounded TRF fit of one block; returns chi2 (matches the macro's
    objective, ref :678-688)."""
    n = len(t_seed)
    xgrid = np.arange(cfg.fit_lo_bin, cfg.fit_hi_bin, dtype=np.float64)

    def resid(p):
        f = np.full(xgrid.shape, p[0])
        for q in range(n):
            t, a = p[1 + 2 * q], p[2 + 2 * q]
            arg = xgrid - t
            gate = (arg > cfg.spline_gate_lo) & (arg < cfg.ntime - 1)
            f = f + np.where(gate, a * spline_eval_np(coeffs, x0, arg), 0.0)
        return (y - f) / sigma

    p0 = np.empty(1 + 2 * n)
    lo = np.empty_like(p0)
    hi = np.empty_like(p0)
    p0[0] = np.clip(ped_seed, -cfg.ped_limit, cfg.ped_limit)
    lo[0], hi[0] = -cfg.ped_limit, cfg.ped_limit
    p0[1::2] = t_seed
    lo[1::2] = t_seed - cfg.time_limit
    hi[1::2] = t_seed + cfg.time_limit
    p0[2::2] = a_seed
    lo[2::2] = np.minimum(a_seed * cfg.amp_lo_frac, a_seed * cfg.amp_hi_frac)
    hi[2::2] = np.maximum(a_seed * cfg.amp_lo_frac, a_seed * cfg.amp_hi_frac)
    sol = least_squares(resid, p0, bounds=(lo, hi), method="trf")
    return float(np.sum(sol.fun ** 2))


def measure_cpu_baseline(cfg: NPSConfig, cal: CalibrationBundle,
                         signal: np.ndarray, timeref: np.ndarray,
                         time_budget_s: float = 6.0, min_blocks: int = 32,
                         ) -> Dict[str, float]:
    """Single-thread reference-algorithm throughput on ``signal`` [E, B, T].

    Blocks are processed in a fixed interleaved order until ``time_budget_s``
    elapses (but at least ``min_blocks``); returns per-stage timings and the
    blocks/s figures. Every block is searched; blocks whose search finds
    pulses are also fitted — the same work profile as the dense bench batch.
    """
    from scipy.optimize import least_squares

    E, B, T = signal.shape
    kern_rev = np.asarray(cal.mfkern_rev, dtype=np.float64)
    mfint = np.asarray(cal.mfint, dtype=np.float64)
    coeffs = np.asarray(cal.spline_coeffs, dtype=np.float64)
    x0s = np.asarray(cal.spline_x0, dtype=np.float64)

    # interleave events so the sample isn't biased to one event's noise draw
    order = [(e, b) for b in range(B) for e in range(E)]

    n_done = n_fitted = 0
    t_search = t_fit = 0.0
    chi2_sum = 0.0
    t_start = time.perf_counter()
    for e, b in order:
        sig = signal[e, b].astype(np.float64)
        minsig = float(sig.min())
        t0 = time.perf_counter()
        npul, times, amps = find_pulses_golden(
            cfg, sig, minsig, kern_rev[b], mfint[b], True)
        t1 = time.perf_counter()
        t_search += t1 - t0
        if npul > 0:
            y = sig[cfg.fit_lo_bin:cfg.fit_hi_bin]
            sigma = _error_model_np(cfg, y)
            ped_seed = float(sig[:cfg.ped_nsamples].mean())
            chi2_sum += _fit_block_scipy(
                cfg, least_squares, y, sigma, coeffs[b], float(x0s[b]),
                times - timeref[b], amps, ped_seed)
            t_fit += time.perf_counter() - t1
            n_fitted += 1
        n_done += 1
        if (n_done >= min_blocks
                and time.perf_counter() - t_start > time_budget_s):
            break
    wall = time.perf_counter() - t_start
    bps1 = n_done / wall
    return {
        "n_blocks": n_done,
        "n_fitted": n_fitted,
        "wall_s": wall,
        "search_ms_per_block": 1e3 * t_search / n_done,
        "fit_ms_per_block": 1e3 * t_fit / max(n_fitted, 1),
        "blocks_per_sec_1thread": bps1,
        "blocks_per_sec_4thread": 4.0 * bps1,
        "mean_chi2": chi2_sum / max(n_fitted, 1),
    }


def measure_cpu_baseline_spread(cfg: NPSConfig, cal: CalibrationBundle,
                                seeds=(7, 19, 41),
                                time_budget_s: float = 5.0,
                                min_blocks: int = 48) -> Dict:
    """Run the baseline over >=3 independent noise seeds.

    A single-seed denominator is anecdotal: the fit cost depends on the
    noise draw (TRF iteration counts vary). The spread (min/median/max over
    seeds) gives the denominator an error bar; consumers wanting the most
    conservative (hardest) denominator take the max.
    """
    import statistics

    from npswf.utils.synthetic import make_events

    per_seed = []
    for seed in seeds:
        truth = make_events(cfg, cal, 4, occupancy=1.0, max_pulses=2,
                            pileup_prob=0.25, seed=seed)
        per_seed.append(measure_cpu_baseline(
            cfg, cal, truth.signal, np.asarray(cal.timeref, np.float64),
            time_budget_s=time_budget_s, min_blocks=min_blocks))

    def spread(key):
        vals = [r[key] for r in per_seed]
        return {"min": min(vals), "median": statistics.median(vals),
                "max": max(vals)}

    return {"seeds": list(seeds), "per_seed": per_seed,
            "search_ms_per_block": spread("search_ms_per_block"),
            "fit_ms_per_block": spread("fit_ms_per_block"),
            "blocks_per_sec_4thread": spread("blocks_per_sec_4thread")}


def main() -> int:
    from npswf.core.calibration import synthetic_calibration

    cfg = NPSConfig()
    cal = synthetic_calibration(cfg, seed=1)
    res = measure_cpu_baseline_spread(cfg, cal, time_budget_s=10.0)
    print(json.dumps(res, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
