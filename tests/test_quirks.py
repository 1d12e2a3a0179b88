"""Behavioral-parity traps from SURVEY.md ("Quirks to preserve")."""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from npswf.core.calibration import (EpochManifest, load_calibration,
                                    synthetic_calibration,
                                    synthetic_pulse_shape)
from npswf.core.config import NPSConfig, calodist_for_run
from npswf.fit.errors import error_model


def _write_ref_calib(cfg, root, run_dir="6171-6183/fit_e_runs/RWF",
                     blocks=(0, 1, 5)):
    """Reference-format calibration files for a few blocks."""
    d = os.path.join(root, run_dir)
    os.makedirs(d, exist_ok=True)
    shape = synthetic_pulse_shape(cfg)
    argmax = int(np.argmax(shape))
    for b in blocks:
        with open(os.path.join(d, f"ref_wf_{b}.txt"), "w") as f:
            # first line: a DIFFERENT timeref value + dummy — the loader must
            # ignore it and use the argmax (ref TEST_2.C:427-438)
            f.write("999.0 0.0\n")
            for it in range(cfg.ntime):
                f.write(f"{it} {shape[it]:.9f}\n")
    np.savetxt(os.path.join(root, "tdc_offset_param.txt"),
               np.arange(cfg.nblocks) * 0.01)
    rows = np.zeros((cfg.nblocks, 5))
    rows[:, 1] = 0.5
    rows[2, 1] = 0.0   # exact zero -> must become -1e-7 (ref :464-467)
    np.savetxt(os.path.join(root, "filetime_step_i.txt"), rows)
    return argmax


def test_loader_timeref_is_argmax_not_file_value(cfg, tmp_path):
    argmax = _write_ref_calib(cfg, str(tmp_path))
    cal = load_calibration(cfg, EpochManifest(root=str(tmp_path)), run=7000)
    assert cal.preswf[0] and cal.preswf[5]
    assert not cal.preswf[7]
    assert cal.timeref[0] == float(argmax)        # NOT 999.0
    # MF kernel = reversed window around the max, UNnormalized; mfint is
    # its sum (the per-tap divisor, ref :161)
    np.testing.assert_allclose(cal.mfkern_rev[0].sum(), cal.mfint[0],
                               rtol=1e-12)
    assert cal.mfint[0] > 1.0  # genuinely unnormalized


def test_loader_cortime_zero_replacement(cfg, tmp_path):
    _write_ref_calib(cfg, str(tmp_path))
    cal = load_calibration(cfg, EpochManifest(root=str(tmp_path)), run=7000)
    assert cal.cortime[2] == pytest.approx(-1e-7)
    assert cal.cortime[3] == pytest.approx(0.5)
    # tdc offsets loaded positionally
    assert cal.tdcoffset[100] == pytest.approx(1.0)


def test_epoch_manifest_ranges(cfg):
    m = EpochManifest(root="/nonexistent")
    # strict open intervals as in the reference if-ladder (ref :377-416)
    assert m.refwf_dir(6184) is not None and "6171-6183" in m.refwf_dir(6184)
    assert m.refwf_dir(6183) is None          # boundary excluded
    assert m.refwf_dir(6170) is not None and "6151-6168" in m.refwf_dir(6170)
    assert m.refwf_dir(1000) is None


def test_calodist_epochs():
    # run-keyed geometry (ref TEST_2.C:498-523)
    assert calodist_for_run(2000) == 3.5
    assert calodist_for_run(4000) == 4.0
    assert calodist_for_run(4700) == 6.0
    assert calodist_for_run(5000) == 4.0
    assert calodist_for_run(5400) == 3.0
    assert calodist_for_run(6000) == 3.5
    assert calodist_for_run(100) == 9.5       # outside every epoch
    cfg = NPSConfig(calodist=9.5)
    assert cfg.timerefacc() == 0.0            # ref :524 with default distance


def test_error_floor_value(cfg):
    # sigma floor ~0.349 counts for |y| below ~8.19 (ref :946-955)
    y = jnp.asarray([0.0, 1.0, 8.0, 8.2, 100.0])
    e = np.asarray(error_model(cfg, y))
    floor = np.sqrt(1.0 * 4.096 / 2.0) / 4.096
    np.testing.assert_allclose(e[:3], floor, rtol=1e-12)
    assert e[3] > floor
    np.testing.assert_allclose(e[4], np.sqrt(100 * 4.096 / 2) / 4.096, rtol=1e-12)


def test_timewf_closest_to_zero_selection(cfg, cal):
    """timewf/amplwf pick the pulse with |time| nearest zero, not the first
    (ref TEST_2.C:999-1016)."""
    from npswf.engine.pipeline import EventBatch, process_batch
    from npswf.core.calibration import spline_eval_np
    rng = np.random.default_rng(4)
    E, B, T = 1, cfg.nblocks, cfg.ntime
    sig = np.zeros((E, B, T)) + 0.3 * rng.standard_normal((E, B, T))
    b = 250
    tr = cal.timeref[b]
    x = np.arange(T, dtype=np.float64)
    # two pulses: a big early one and a smaller one right at the reference
    # time (time parameter ~ 0); the near-zero one must win timewf
    for t0, a0 in ((tr - 25.0, 150.0), (tr + 0.5, 60.0)):
        arg = x - (t0 - tr)
        g = (arg > 1) & (arg < T - 1)
        sig[0, b] += np.where(g, a0 * spline_eval_np(
            cal.spline_coeffs[b], cal.spline_x0[b], arg), 0.0)
    batch = EventBatch(signal=jnp.asarray(sig),
                       pres=jnp.asarray(np.ones((E, B), bool)),
                       corr_time_HMS=jnp.zeros(E),
                       evt=jnp.arange(E), runnum=jnp.zeros(E))
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}
    out = process_batch(cfg, calib, batch)
    assert int(out.wfnpulse[0, b]) == 2
    wft = np.asarray(out.wftime[0, b, :2])
    tw = float(out.timewf[0, b])
    # the selected pulse is the one with the smaller |time|
    assert abs(tw) == pytest.approx(np.abs(wft).min())
    aw = float(out.amplwf[0, b])
    assert 30 < aw < 90   # the smaller (near-zero) pulse's amplitude


def test_short_final_block_uses_full_window(cfg, cal):
    """Quirk ledger Q1 (PARITY.md): the reference bounds its error loop
    (ref TEST_2.C:945), diagnostics loops (:1032, 1064-1071), and width scans
    (:1083-1107) by the LAST decoded block's nsamp — a data-dependent leak
    we deliberately define away. Pin our behavior: a short trailing block in
    the readout must not change any other block's errors or diagnostics."""
    from npswf.engine.diagnostics import block_diagnostics
    from npswf.golden.reference import decode_event_golden
    rng = np.random.default_rng(9)
    T = cfg.ntime
    wf_a = 10.0 + rng.standard_normal(T)        # full-length block 3
    wf_b = 5.0 + rng.standard_normal(T)         # block 7, truncated below
    short = 40                                   # nsamp of the trailing block

    def stream(with_short_tail):
        parts = [[3, T], wf_a]
        if with_short_tail:
            parts += [[7, short], wf_b[:short]]
        return np.concatenate([np.asarray(p, np.float64) for p in parts])

    sig_full, _, _, bad1 = decode_event_golden(cfg, stream(False))
    sig_tail, _, _, bad2 = decode_event_golden(cfg, stream(True))
    assert bad1 == -1 and bad2 == -1
    np.testing.assert_array_equal(sig_full[3], sig_tail[3])

    d_full = block_diagnostics(cfg, jnp.asarray(sig_full[None]))
    d_tail = block_diagnostics(cfg, jnp.asarray(sig_tail[None]))
    for k in ("ener", "integ", "bkg", "noise", "ampl"):
        # block 3 diagnostics are bit-identical with and without the short
        # trailing block (the reference's would change: nsamp=40 truncates
        # every window and renormalizes bkg/noise by nsamp-78)
        np.testing.assert_array_equal(np.asarray(d_full[k])[0, 3],
                                      np.asarray(d_tail[k])[0, 3], err_msg=k)
    # the error model is per-waveform and full-length: a short sibling block
    # cannot shrink it (the reference's Err[it] loop stops at nsamp=40,
    # leaving stale errors for bins 40..109 of EVERY later block)
    e = np.asarray(error_model(cfg, jnp.asarray(sig_tail[3])))
    assert e.shape == (T,)
    assert np.all(e > 0)


def test_fit_is_local_minimum(cfg, cal):
    """Independent optimality check: perturbing any free parameter of a
    converged fit increases chi2 (true local minimum, not solver artifact)."""
    from tests.test_fit import _build_inputs
    from npswf.fit.lm import fit_waveforms
    from npswf.models.waveform import get_model
    inp, *_ = _build_inputs(cfg, cal, n_lanes=12, seed=14)
    res = fit_waveforms(cfg, inp)
    conv = np.asarray(res.converged)
    model = get_model("spline_ref")
    xgrid = jnp.arange(cfg.fit_lo_bin, cfg.fit_hi_bin, dtype=jnp.float64)
    aux = {"coeffs": inp.coeffs, "x0": inp.x0}

    def chi2(params):
        f, _ = model.eval_and_jac(cfg, params, aux, xgrid, inp.pulse_mask)
        r = (np.asarray(inp.y) - np.asarray(f)) / np.asarray(inp.sigma)
        return (r * r).sum(axis=1)

    base = chi2(res.params)
    p = np.asarray(res.params)
    eps = 5e-3
    checked = 0
    for j in (0, 1, 2):  # pedestal, t0, A0
        for sgn in (+1, -1):
            q = p.copy()
            q[:, j] += sgn * eps
            c = chi2(jnp.asarray(q))
            ok = conv & (np.asarray(inp.pulse_mask)[:, 0] if j else conv)
            assert np.all(c[ok] >= base[ok] - 1e-9), (j, sgn)
            checked += 1
    assert checked == 6
