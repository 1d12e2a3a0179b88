"""Parity tests: batched JAX ops vs the scalar golden oracle (fp64)."""
import numpy as np
import jax.numpy as jnp
import pytest

from npswf.core.calibration import (natural_cubic_spline_coeffs,
                                    spline_eval_np, synthetic_calibration)
from npswf.golden.reference import (cluster_gate_golden,
                                    find_pulses_golden,
                                    matched_filter_golden,
                                    tspectrum_search_golden)
from npswf.ops.cluster_gate import cluster_gate
from npswf.ops.matched_filter import matched_filter
from npswf.ops.peak_search import find_pulses, tspectrum_search
from npswf.utils.synthetic import make_events


def _lanes(cfg, cal, n_events=2, seed=3, occupancy=0.15, **kw):
    truth = make_events(cfg, cal, n_events, occupancy=occupancy, seed=seed, **kw)
    E, B, T = truth.signal.shape
    sig = truth.signal.reshape(E * B, T)
    mins = sig.min(axis=1)
    kern = np.tile(cal.mfkern_rev, (E, 1))
    mfint = np.tile(cal.mfint, E)
    return truth, sig, mins, kern, mfint


def test_matched_filter_bitwise(cfg, cal):
    truth, sig, mins, kern, mfint = _lanes(cfg, cal)
    out = np.asarray(matched_filter(cfg, jnp.asarray(sig[:, None, :]),
                                    jnp.asarray(mins[:, None]),
                                    jnp.asarray(kern[:, None, :]),
                                    jnp.asarray(mfint[:, None])))[:, 0]
    # identical accumulation order => bit-equal in fp64
    for lane in range(0, sig.shape[0], 97):
        b = lane % cfg.nblocks
        ref = matched_filter_golden(cfg, sig[lane], mins[lane],
                                    cal.mfkern_rev[b], cal.mfint[b])
        np.testing.assert_array_equal(out[lane], ref)


def test_tspectrum_parity_structured(cfg, cal):
    """Clean multi-pulse spectra: positions/order must match exactly."""
    truth, sig, mins, kern, mfint = _lanes(cfg, cal, n_events=3, occupancy=0.25,
                                    max_pulses=3, seed=11)
    mf = np.asarray(matched_filter(cfg, jnp.asarray(sig[:, None, :]),
                                   jnp.asarray(mins[:, None]),
                                   jnp.asarray(kern[:, None, :]),
                                   jnp.asarray(mfint[:, None])))[:, 0]
    mf32 = mf.astype(np.float32).astype(np.float64)
    px, py, valid = tspectrum_search(cfg, jnp.asarray(mf32))
    px, py, valid = np.asarray(px), np.asarray(py), np.asarray(valid)
    checked = 0
    for lane in range(sig.shape[0]):
        gx, gy = tspectrum_search_golden(
            mf32[lane], sigma=cfg.spec_sigma, threshold_frac=cfg.specthres,
            max_peaks=cfg.maxwfpulses)
        n = int(valid[lane].sum())
        assert n == len(gx), f"lane {lane}: {n} vs {len(gx)}"
        np.testing.assert_allclose(px[lane, :n], gx, atol=0)
        np.testing.assert_allclose(py[lane, :n], gy, rtol=1e-12)
        checked += n
    assert checked > 20  # the batch must actually contain peaks


def test_find_pulses_parity(cfg, cal):
    truth, sig, mins, kern, mfint = _lanes(cfg, cal, n_events=2, occupancy=0.2,
                                    max_pulses=3, seed=21)
    present = np.ones(sig.shape[0], dtype=bool)
    res = find_pulses(cfg, jnp.asarray(sig), jnp.asarray(mins),
                      jnp.asarray(kern), jnp.asarray(mfint),
                      jnp.asarray(present))
    npulse = np.asarray(res.npulse)
    times = np.asarray(res.times)
    amps = np.asarray(res.amps)
    total = 0
    for lane in range(sig.shape[0]):
        b = lane % cfg.nblocks
        gn, gt, ga = find_pulses_golden(cfg, sig[lane], mins[lane],
                                        cal.mfkern_rev[b], cal.mfint[b], True)
        assert npulse[lane] == gn, f"lane {lane}"
        np.testing.assert_allclose(times[lane, :gn], gt, atol=0)
        np.testing.assert_allclose(amps[lane, :gn], ga, rtol=1e-12)
        total += gn
    assert total > 10


def test_find_pulses_detects_truth(cfg, cal):
    """Injected pulses above threshold are found within ~2.5 bins."""
    truth, sig, mins, kern, mfint = _lanes(cfg, cal, n_events=2, occupancy=0.1,
                                    max_pulses=1, seed=33, noise=0.3,
                                    amp_range=(50.0, 150.0))
    present = np.ones(sig.shape[0], dtype=bool)
    res = find_pulses(cfg, jnp.asarray(sig), jnp.asarray(mins),
                      jnp.asarray(kern), jnp.asarray(mfint),
                      jnp.asarray(present))
    npulse = np.asarray(res.npulse).reshape(truth.signal.shape[:2])
    times = np.asarray(res.times).reshape(truth.signal.shape[:2] + (-1,))
    found, missed = 0, 0
    for e in range(truth.signal.shape[0]):
        for b in np.nonzero(truth.npulse[e])[0]:
            t_true = truth.times[e, b, 0]
            if not (12 < t_true < 98):
                continue
            if npulse[e, b] == 0:
                missed += 1
                continue
            # detected xpos carries the reference's -2+0.5 bin convention
            err = np.min(np.abs(times[e, b, :npulse[e, b]] + 1.5 - t_true))
            assert err < 2.5, (e, b, t_true, times[e, b])
            found += 1
    assert found > 10
    assert missed <= found // 10


def test_cluster_gate_parity(cfg, cal):
    truth = make_events(cfg, cal, 2, occupancy=0.08, seed=5)
    sig = jnp.asarray(truth.signal)
    out = np.asarray(cluster_gate(cfg, sig, jnp.asarray(cal.timeref),
                                  cal.timerefacc))
    for e in range(truth.signal.shape[0]):
        interesting = list(np.nonzero(truth.npulse[e])[0][:20])
        interesting += [0, cfg.ncol - 1, cfg.nblocks - 1, 17, 555]
        for b in interesting:
            ref = cluster_gate_golden(cfg, truth.signal[e], truth.pres[e], int(b),
                                      cal.timeref[b], cal.timerefacc)
            assert bool(out[e, b]) == ref, (e, b)


def test_spline_natural_boundary_and_knots():
    rng = np.random.default_rng(7)
    x = np.arange(110, dtype=np.float64)
    y = rng.standard_normal(110).cumsum()
    co = natural_cubic_spline_coeffs(x, y)
    # interpolates the knots
    np.testing.assert_allclose(spline_eval_np(co, 0.0, x[:-1]), y[:-1], rtol=1e-12)
    # right endpoint via last segment
    a, b, c, d = co[-1]
    np.testing.assert_allclose(((d * 1 + c) * 1 + b) * 1 + a, y[-1], rtol=1e-12)
    # natural boundary: s'' = 2c = 0 at both ends
    assert abs(co[0, 2]) < 1e-12
    s2_end = 2 * co[-1, 2] + 6 * co[-1, 3] * 1.0
    assert abs(s2_end) < 1e-9
    # C1/C2 continuity at interior knots
    for i in range(co.shape[0] - 1):
        a, b, c, d = co[i]
        v_end = ((d + c) + b) + a
        d1_end = 3 * d + 2 * c + b
        d2_end = 6 * d + 2 * c
        np.testing.assert_allclose(v_end, co[i + 1, 0], atol=1e-9)
        np.testing.assert_allclose(d1_end, co[i + 1, 1], atol=1e-9)
        np.testing.assert_allclose(d2_end, 2 * co[i + 1, 2], atol=1e-9)


def test_spline_eval_gate(cfg, cal):
    from npswf.ops.spline import spline_eval_grad
    b = 13
    t = jnp.asarray(np.linspace(-5.0, 115.0, 241))
    val, dval = spline_eval_grad(cfg, jnp.asarray(cal.spline_coeffs[b])[None],
                                 jnp.asarray(cal.spline_x0[b])[None], t[None, :])
    val, dval = np.asarray(val)[0], np.asarray(dval)[0]
    tnp = np.asarray(t)
    gate = (tnp > cfg.spline_gate_lo) & (tnp < cfg.ntime - 1)
    assert np.all(val[~gate] == 0) and np.all(dval[~gate] == 0)
    ref = spline_eval_np(cal.spline_coeffs[b], cal.spline_x0[b], tnp[gate])
    np.testing.assert_allclose(val[gate], ref, rtol=1e-12)
    # derivative vs finite differences
    h = 1e-6
    fd = (spline_eval_np(cal.spline_coeffs[b], cal.spline_x0[b], tnp[gate] + h)
          - spline_eval_np(cal.spline_coeffs[b], cal.spline_x0[b], tnp[gate] - h)) / (2 * h)
    np.testing.assert_allclose(dval[gate], fd, atol=1e-5)


def test_find_pulses_edge_peaks_match_golden(cfg, cal):
    """Pulses jammed against both spectrum edges: exercises the centroid
    edge clips in the gather-free window selects (key / pos_y / raw-aux),
    which must still reproduce the scalar oracle exactly."""
    rng = np.random.default_rng(77)
    T = cfg.ntime
    n_lanes = 24
    x = np.arange(T, dtype=np.float64)
    sig = np.zeros((n_lanes, T))
    blocks = rng.integers(0, cfg.nblocks, n_lanes)
    from npswf.core.calibration import spline_eval_np
    for i, b in enumerate(blocks):
        sig[i] = 0.5 * rng.standard_normal(T)
        # one pulse near each edge of the search window plus one mid-window;
        # edge centroids trigger the clip paths in the window selects
        for t0 in (2.0, 11.0, 55.0, 97.0, 107.0):
            arg = x - (t0 - cal.timeref[b])
            gate = (arg > cfg.spline_gate_lo) & (arg < T - 1)
            sig[i] += np.where(gate, rng.uniform(60, 160) * spline_eval_np(
                cal.spline_coeffs[b], cal.spline_x0[b], arg), 0.0)
    mins = sig.min(axis=1)
    kern = cal.mfkern_rev[blocks]
    mfint = cal.mfint[blocks]
    present = np.ones(n_lanes, bool)
    res = find_pulses(cfg, jnp.asarray(sig), jnp.asarray(mins),
                      jnp.asarray(kern), jnp.asarray(mfint),
                      jnp.asarray(present))
    npulse = np.asarray(res.npulse)
    times = np.asarray(res.times)
    amps = np.asarray(res.amps)
    total = 0
    for lane in range(n_lanes):
        b = blocks[lane]
        gn, gt, ga = find_pulses_golden(cfg, sig[lane], mins[lane],
                                        cal.mfkern_rev[b], cal.mfint[b], True)
        assert npulse[lane] == gn, f"lane {lane}"
        np.testing.assert_allclose(times[lane, :gn], gt, atol=0)
        np.testing.assert_allclose(amps[lane, :gn], ga, rtol=1e-12)
        total += gn
    assert total > 30
