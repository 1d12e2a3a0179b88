"""The LM solver vs an INDEPENDENT optimizer (scipy trust-region-reflective).

Testing the 0.05-bin parity bar fp32-vs-fp64 alone never compares the
solver with an optimizer written independently of it. Here
every converged lane is re-minimized by scipy.optimize.least_squares
(bounded TRF, numeric Jacobian, a completely foreign implementation) from
the SAME seeds/bounds/objective; the two minimizers must land on the same
minimum far inside the parity bar. This is the Migrad-replacement claim
made falsifiable without ROOT: if our solver stopped at wrong minima, an
unrelated trust-region method would expose it.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from npswf.core.calibration import spline_eval_np
from npswf.fit.lm import FitInputs, fit_waveforms, _bounds, _seed_params
from tests.test_fit import _build_inputs

scipy_opt = pytest.importorskip("scipy.optimize")


def _residual_fn(cfg, cal_coeffs, cal_x0, y, sigma, npul):
    K = cfg.nfitbins
    xgrid = np.arange(cfg.fit_lo_bin, cfg.fit_hi_bin, dtype=np.float64)

    def resid(p):
        f = np.full(K, p[0])
        for q in range(npul):
            t, a = p[1 + 2 * q], p[2 + 2 * q]
            arg = xgrid - t
            gate = (arg > cfg.spline_gate_lo) & (arg < cfg.ntime - 1)
            f = f + np.where(
                gate, a * spline_eval_np(cal_coeffs, cal_x0, arg), 0.0)
        return (y - f) / sigma

    return resid


def test_lm_matches_scipy_trf(cfg, cal):
    inp, t_true, a_true, ped, npul = _build_inputs(
        cfg, cal, n_lanes=24, seed=33, max_pulses=2, noise=0.4,
        seed_jitter=2.0)
    res = fit_waveforms(cfg, inp)
    conv = np.asarray(res.converged)
    assert conv.sum() >= 18
    params = np.asarray(res.params)
    chi2 = np.asarray(res.chi2)

    lo, hi = (np.asarray(v) for v in _bounds(cfg, inp))
    p_seed = np.asarray(_seed_params(cfg, inp))
    y = np.asarray(inp.y, dtype=np.float64)
    sig = np.asarray(inp.sigma, dtype=np.float64)
    coeffs = np.asarray(inp.coeffs, dtype=np.float64)
    x0s = np.asarray(inp.x0, dtype=np.float64)

    checked = 0
    for i in np.nonzero(conv)[0][:12]:
        n = int(npul[i])
        m = 1 + 2 * n
        resid = _residual_fn(cfg, coeffs[i], x0s[i], y[i], sig[i], n)
        sol = scipy_opt.least_squares(
            resid, p_seed[i, :m], bounds=(lo[i, :m], hi[i, :m]),
            method="trf", xtol=1e-12, ftol=1e-12, gtol=1e-10)
        # same minimum: times within a small fraction of the 0.05-bin
        # parity bar, amplitudes to ~0.1%, chi2 to ~1e-4 relative
        ours_t = params[i, 1:m:2]
        ref_t = sol.x[1::2]
        np.testing.assert_allclose(ours_t, ref_t, rtol=0, atol=5e-3,
                                   err_msg=f"lane {i} times")
        np.testing.assert_allclose(params[i, 2:m:2], sol.x[2::2],
                                   rtol=2e-3, atol=1e-3,
                                   err_msg=f"lane {i} amplitudes")
        ours_chi2 = chi2[i]
        scipy_chi2 = float(np.sum(resid(sol.x) ** 2))
        # neither optimizer may claim a meaningfully LOWER minimum
        assert ours_chi2 <= scipy_chi2 * (1 + 1e-3) + 1e-6, (
            f"lane {i}: scipy found a lower minimum "
            f"({scipy_chi2} vs ours {ours_chi2})")
        checked += 1
    assert checked >= 10


def test_lm_failure_lanes_also_fail_scipy_or_are_marginal(cfg, cal):
    """Lanes our two-stage escalation could not converge should be genuinely
    hard: scipy from the same seeds must not reach a dramatically better
    chi2 than our seed-fallback reports for them."""
    inp, t_true, a_true, ped, npul = _build_inputs(
        cfg, cal, n_lanes=64, seed=55, max_pulses=2, noise=3.0,
        seed_jitter=3.9)
    res = fit_waveforms(cfg, inp)
    conv = np.asarray(res.converged)
    failed = np.nonzero(~conv)[0]
    if failed.size == 0:
        pytest.skip("no failed lanes in this ensemble")
    lo, hi = (np.asarray(v) for v in _bounds(cfg, inp))
    p_seed = np.asarray(_seed_params(cfg, inp))
    y = np.asarray(inp.y, dtype=np.float64)
    sig = np.asarray(inp.sigma, dtype=np.float64)
    coeffs = np.asarray(inp.coeffs, dtype=np.float64)
    x0s = np.asarray(inp.x0, dtype=np.float64)
    K = cfg.nfitbins
    for i in failed[:4]:
        n = int(npul[i])
        m = 1 + 2 * n
        resid = _residual_fn(cfg, coeffs[i], x0s[i], y[i], sig[i], n)
        sol = scipy_opt.least_squares(
            resid, p_seed[i, :m], bounds=(lo[i, :m], hi[i, :m]),
            method="trf")
        seed_chi2 = float(np.sum(resid(p_seed[i, :m]) ** 2))
        scipy_chi2 = float(np.sum(resid(sol.x) ** 2))
        # scipy will improve on raw seeds, but a failed lane must not be
        # one scipy solves to a near-perfect fit (chi2/ndf ~ 1): that
        # would mean our escalation gives up on easy problems
        assert scipy_chi2 > 2.0 * K or scipy_chi2 > 0.05 * seed_chi2, (
            f"lane {i}: scipy easily solved a lane we failed "
            f"(chi2 {scipy_chi2} from seed {seed_chi2})")


def test_lm_wide_systems_match_scipy(cfg, cal):
    """High-pileup lanes (3-4 pulses, up to 9 free parameters) through the
    wide-budget path must also land on scipy's minima — the wide solver is
    otherwise only self-consistent."""
    inp, t_true, a_true, ped, npul = _build_inputs(
        cfg, cal, n_lanes=24, seed=71, max_pulses=4, noise=0.4,
        seed_jitter=1.5)
    res = fit_waveforms(cfg, inp)
    conv = np.asarray(res.converged)
    wide = npul >= 3
    take = np.nonzero(conv & wide)[0]
    assert take.size >= 5, f"only {take.size} converged wide lanes"
    params = np.asarray(res.params)
    chi2 = np.asarray(res.chi2)
    lo, hi = (np.asarray(v) for v in _bounds(cfg, inp))
    p_seed = np.asarray(_seed_params(cfg, inp))
    y = np.asarray(inp.y, dtype=np.float64)
    sig = np.asarray(inp.sigma, dtype=np.float64)
    coeffs = np.asarray(inp.coeffs, dtype=np.float64)
    x0s = np.asarray(inp.x0, dtype=np.float64)
    for i in take[:6]:
        n = int(npul[i])
        m = 1 + 2 * n
        resid = _residual_fn(cfg, coeffs[i], x0s[i], y[i], sig[i], n)
        sol = scipy_opt.least_squares(
            resid, p_seed[i, :m], bounds=(lo[i, :m], hi[i, :m]),
            method="trf", xtol=1e-12, ftol=1e-12, gtol=1e-10)
        # the model is permutation-invariant in its pulse slots (compare
        # time SETS), and overlapping-pulse systems have near-degenerate
        # flat valleys where two optimizers legitimately stop ~0.2 bins
        # apart at chi2 differing below the ftol floor — accept either
        # tight time agreement or chi2 parity with loose time agreement
        scipy_chi2 = float(np.sum(resid(sol.x) ** 2))
        ours = np.sort(params[i, 1:m:2])
        ref = np.sort(sol.x[1::2])
        if not np.allclose(ours, ref, rtol=0, atol=1e-2):
            assert abs(chi2[i] - scipy_chi2) <= 1e-3 * max(scipy_chi2, 1.0), (
                f"lane {i}: times differ ({ours} vs {ref}) AND chi2 differs "
                f"({chi2[i]} vs {scipy_chi2}) — not a flat-valley degeneracy")
            np.testing.assert_allclose(ours, ref, rtol=0, atol=0.5,
                                       err_msg=f"lane {i} times ({n} pulses)")
        assert chi2[i] <= scipy_chi2 * (1 + 1e-3) + 1e-6, (
            f"lane {i}: scipy found a lower minimum")
