"""Adversarial solver audit: classify LM fit failures via scipy TRF.

``bench.py`` reports adversarial failure rates
(wrong-shape / correlated-noise / clipped, far above the reference's 1-2%
on real data, ref README.md:129) but never asks whether those failures are
the SOLVER's fault or the DATA's. This tool answers that: every lane our
two-stage LM escalation (the Minuit2 Migrad replacement, ref
TEST_2.C:755-791) flags as failed is re-minimized by
``scipy.optimize.least_squares`` (bounded trust-region-reflective, a
completely independent implementation) from the same seeds, bounds, and
objective, and classified by the chi^2 the two optimizers reach:

- ``lm_stuck``      — TRF finds a >5% lower chi^2: a genuine LM weakness
                       (the lane had a reachable better minimum we missed).
- ``same_minimum``  — both land within 5%: the LM *optimized* fine but its
                       convergence criterion (MINPACK-style scaled gradient)
                       declined to certify the point. A criterion-calibration
                       question, not an optimization failure.
- ``lm_better``     — TRF stops >5% HIGHER: we out-minimized the
                       independent optimizer on that lane.

The per-lane fit problems are built by the same pre-fit stages the engine
runs (peak search, cluster gate, error model, seed/bound construction —
``engine.pipeline.process_batch`` without the capacity routing, which is
result-neutral), so the audited failures are exactly the pipeline's.

Usage: python -m npswf.tools.solver_audit [--events 16] [--sample 150]
Writes the classification table to stdout (markdown) and a JSON line;
SOLVER_AUDIT.md records the committed runs.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Tuple

import numpy as np

from npswf.core.config import NPSConfig
from npswf.core.calibration import (CalibrationBundle, spline_eval_np,
                                    synthetic_calibration)
from npswf.fit.lm import FitInputs, fit_waveforms, _bounds, _seed_params


def build_fit_inputs(cfg: NPSConfig, cal: CalibrationBundle,
                     signal: np.ndarray, pres: np.ndarray,
                     ) -> Tuple[FitInputs, np.ndarray]:
    """Pipeline-identical fit problems for every (event x block) lane.

    Mirrors ``engine.pipeline.process_batch`` up to the solver call —
    matched-filter peak search, 3x3 cluster gate, error model, seed times
    relative to timeref (ref TEST_2.C:662), pedestal seed from the first 20
    samples (ref :672-676) — with no capacity compaction (the routing is
    result-neutral; here we want every lane addressable by index).

    Returns (FitInputs over all N = E*B lanes, npulse [N]).
    """
    import jax
    import jax.numpy as jnp
    from npswf.fit.errors import error_model
    from npswf.ops.cluster_gate import cluster_gate
    from npswf.ops.peak_search import find_pulses

    E, B, T = signal.shape
    N = E * B
    dtype = jnp.float32 if cfg.compute_dtype == "float32" else jnp.float64
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}

    @jax.jit
    def prefit(sig, pres_in):
        sig = sig.astype(dtype)
        preswf = calib["preswf"]
        timeref = calib["timeref"].astype(dtype)
        coeffs = calib["spline_coeffs"].astype(dtype)
        x0 = calib["spline_x0"].astype(dtype)
        kern = calib["mfkern_rev"].astype(dtype)
        mfint = calib["mfint"].astype(dtype)

        present = pres_in.astype(bool) & preswf[None, :]
        flat_sig = sig.reshape(N, T)
        flat_present = present.reshape(N)
        minsignal = jnp.min(flat_sig, axis=1)
        kern_flat = jnp.broadcast_to(
            kern[None], (E, B, cfg.mfwidth)).reshape(N, -1)
        mfint_flat = jnp.broadcast_to(mfint[None], (E, B)).reshape(N)
        ps = find_pulses(cfg, flat_sig, minsignal, kern_flat, mfint_flat,
                         flat_present)
        gate = cluster_gate(cfg, sig, timeref,
                            calib["timerefacc"].astype(dtype)).reshape(N)
        active = flat_present & gate & (ps.npulse > 0)
        blocks_flat = jnp.tile(jnp.arange(B), E)
        err = error_model(cfg, flat_sig)
        inp = FitInputs(
            y=flat_sig[:, cfg.fit_lo_bin:cfg.fit_hi_bin],
            sigma=err[:, cfg.fit_lo_bin:cfg.fit_hi_bin],
            coeffs=coeffs[blocks_flat],
            x0=x0[blocks_flat],
            t_seed=ps.times - timeref[blocks_flat][:, None],
            a_seed=ps.amps,
            ped_seed=jnp.mean(flat_sig[:, :cfg.ped_nsamples], axis=1),
            pulse_mask=ps.valid,
            active=active,
            timeref=timeref[blocks_flat])
        return inp, ps.npulse

    return prefit(jnp.asarray(signal), jnp.asarray(pres))


def _residual_fn(cfg: NPSConfig, coeffs, x0, y, sigma, pmask):
    """f64 residual of the engine's objective for one lane (scipy-side)."""
    xgrid = np.arange(cfg.fit_lo_bin, cfg.fit_hi_bin, dtype=np.float64)

    def resid(p):
        f = np.full(xgrid.shape, p[0])
        for q in np.nonzero(pmask)[0]:
            t, a = p[1 + 2 * q], p[2 + 2 * q]
            arg = xgrid - t
            gate = (arg > cfg.spline_gate_lo) & (arg < cfg.ntime - 1)
            f = f + np.where(gate, a * spline_eval_np(coeffs, x0, arg), 0.0)
        return (y - f) / sigma

    return resid


def audit_signal(cfg: NPSConfig, cal: CalibrationBundle, signal: np.ndarray,
                 pres: np.ndarray, sample: int = 150,
                 seed: int = 5) -> Dict[str, float]:
    """Fit all lanes, TRF-re-minimize a sample of the failed ones."""
    from scipy.optimize import least_squares

    inp, npulse_d = build_fit_inputs(cfg, cal, signal, pres)
    res = fit_waveforms(cfg, inp)
    active = np.asarray(inp.active)
    conv = np.asarray(res.converged)
    failed = np.nonzero(active & ~conv)[0]
    n_fits = int(active.sum())
    out = {"n_fits": n_fits, "n_failed": int(failed.size),
           "fail_rate": failed.size / max(n_fits, 1)}
    if failed.size == 0:
        out.update(n_audited=0, lm_stuck=0, same_minimum=0, lm_better=0)
        return out

    rng = np.random.default_rng(seed)
    take = (failed if failed.size <= sample
            else rng.choice(failed, size=sample, replace=False))
    lo, hi = (np.asarray(v, np.float64) for v in _bounds(cfg, inp))
    p_seed = np.asarray(_seed_params(cfg, inp), np.float64)
    y = np.asarray(inp.y, np.float64)
    sig = np.asarray(inp.sigma, np.float64)
    coeffs = np.asarray(inp.coeffs, np.float64)
    x0s = np.asarray(inp.x0, np.float64)
    pmask = np.asarray(inp.pulse_mask)
    chi2_lm = np.asarray(res.chi2, np.float64)

    n_stuck = n_same = n_better = 0
    stuck_ratios, stuck_trf_ndf = [], []
    K = cfg.fit_hi_bin - cfg.fit_lo_bin
    for i in take:
        m = 1 + 2 * int(pmask[i].sum())
        # masked pulse slots sit interleaved only when valid slots are a
        # prefix (find_pulses packs valid peaks first) — assert that
        assert pmask[i, : (m - 1) // 2].all()
        resid = _residual_fn(cfg, coeffs[i], x0s[i], y[i], sig[i], pmask[i])
        sol = least_squares(resid, p_seed[i, :m],
                            bounds=(lo[i, :m], hi[i, :m]), method="trf",
                            xtol=1e-12, ftol=1e-12, gtol=1e-10)
        chi2_trf = float(np.sum(resid(sol.x) ** 2))
        ours = chi2_lm[i]
        if chi2_trf < ours * 0.95:
            n_stuck += 1
            stuck_ratios.append(chi2_trf / max(ours, 1e-12))
            stuck_trf_ndf.append(chi2_trf / max(K - m, 1))
        elif chi2_trf > ours * 1.05:
            n_better += 1
        else:
            n_same += 1
    n_aud = len(take)
    out.update(n_audited=n_aud, lm_stuck=n_stuck, same_minimum=n_same,
               lm_better=n_better,
               lm_stuck_frac=n_stuck / n_aud,
               same_minimum_frac=n_same / n_aud,
               lm_better_frac=n_better / n_aud,
               median_stuck_chi2_ratio=(float(np.median(stuck_ratios))
                                        if stuck_ratios else None),
               # is TRF's "better" minimum a GOOD fit? chi2/ndf >> 1 means
               # the lane is unfittable data, not a solver weakness
               median_stuck_trf_chi2_ndf=(float(np.median(stuck_trf_ndf))
                                          if stuck_trf_ndf else None))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=16)
    ap.add_argument("--sample", type=int, default=150,
                    help="max failed lanes to TRF-re-minimize per ensemble")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"],
                    help="fit compute dtype (float64 isolates precision-"
                    "stall failures from algorithmic ones)")
    args = ap.parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    if args.dtype == "float64":
        import jax
        jax.config.update("jax_enable_x64", True)

    from npswf.utils.synthetic import adversarial_variants, make_events

    cfg = NPSConfig(compute_dtype=args.dtype)
    cal = synthetic_calibration(cfg, seed=1)
    truth = make_events(cfg, cal, args.events, occupancy=1.0, max_pulses=2,
                        pileup_prob=0.25, seed=7)
    ensembles = {"clean": truth.signal}
    ensembles.update(adversarial_variants(cfg, cal, truth, seed=23))

    rows = {}
    for name, sig in ensembles.items():
        print(f"[audit] {name}: fitting {args.events * cfg.nblocks} lanes...",
              file=sys.stderr)
        rows[name] = audit_signal(cfg, cal, sig, truth.pres,
                                  sample=args.sample)
        print(f"[audit] {name}: {rows[name]}", file=sys.stderr)

    print("| ensemble | fits | failed | rate | audited | lm_stuck | "
          "same_minimum | lm_better |")
    print("|---|---|---|---|---|---|---|---|")
    for name, r in rows.items():
        print(f"| {name} | {r['n_fits']} | {r['n_failed']} | "
              f"{r['fail_rate']:.2%} | {r['n_audited']} | "
              f"{r.get('lm_stuck', 0)} | {r.get('same_minimum', 0)} | "
              f"{r.get('lm_better', 0)} |")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
