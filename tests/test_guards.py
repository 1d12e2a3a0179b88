"""Runtime guards: truncated/oversize/short streams, config & calib validation.

Covers the reference's inline runtime assertions (SURVEY.md section 4):
the Ndata guard (ref TEST_2.C:830-836), slot validity (ref :867-872), and the
framework-side validations added around them (stream truncation, matched-
filter symmetry, unit knot spacing).
"""
import os

import numpy as np
import pytest

from npswf.core.config import NPSConfig
from npswf.golden.reference import decode_event_golden
from npswf.io.decode import decode_segment
from npswf.io.rawstream import build_segment

_EMPTY_HITS = {k: np.zeros(0) for k in
               ("adc_counter", "pulse_time", "pulse_time_raw",
                "pulse_amp", "pulse_int", "pulse_ped")}


def _one_event_segment(cfg, stream):
    return build_segment(cfg, [np.asarray(stream, np.float64)], [_EMPTY_HITS],
                         evt=np.array([1.0]), runnum=np.array([1.0]))


def test_short_block_decodes_identically(cfg, cal):
    """nsamp < ntime: samples land in [0, nsamp), minsignal spans only the
    decoded samples (ref :854-889), all three decoders agree."""
    nsamp = 50
    samples = 10.0 + np.arange(nsamp, dtype=np.float64)  # all positive
    stream = np.concatenate([[7.0, float(nsamp)], samples,
                             [9.0, float(cfg.ntime)],
                             5.0 + np.zeros(cfg.ntime)])
    seg = _one_event_segment(cfg, stream)
    nat = decode_segment(cfg, cal, seg, use_native=True)
    npd = decode_segment(cfg, cal, seg, use_native=False)
    g_sig, g_pres, g_min, g_bad = decode_event_golden(cfg, stream)
    assert g_bad == -1
    for dec in (nat, npd):
        assert dec.bad_slot[0] == -1
        np.testing.assert_allclose(dec.signal[0], g_sig.astype(np.float32))
        np.testing.assert_allclose(dec.minsignal[0], g_min.astype(np.float32))
    # the decoded minimum must NOT be pulled to the zero padding
    assert g_min[7] == 10.0
    assert np.all(g_sig[7, nsamp:] == 0.0)


def test_truncated_stream_clamped_and_flagged(cfg, cal):
    """An nsamp running past the event boundary is clamped (no over-read)
    and flagged bad = -2, identically in native/numpy/golden decoders."""
    stream = np.concatenate([[3.0, float(cfg.ntime)],
                             np.full(40, 2.5)])  # claims 110, carries 40
    seg = _one_event_segment(cfg, stream)
    nat = decode_segment(cfg, cal, seg, use_native=True)
    npd = decode_segment(cfg, cal, seg, use_native=False)
    g_sig, g_pres, g_min, g_bad = decode_event_golden(cfg, stream)
    assert g_bad == -2
    assert g_pres[3] == 1
    assert np.all(g_sig[3, :40] == 2.5) and np.all(g_sig[3, 40:] == 0.0)
    for dec in (nat, npd):
        assert dec.bad_slot[0] == -2
        np.testing.assert_allclose(dec.signal[0], g_sig.astype(np.float32))
        np.testing.assert_allclose(dec.minsignal[0], g_min.astype(np.float32))


def test_oversize_event_skipped(cfg, cal):
    """A stream longer than ndata_max is skipped entirely and counted
    (the reference's Ndata guard, ref :830-836)."""
    stream = np.zeros(cfg.ndata_max + 8)
    stream[0], stream[1] = 5.0, float(cfg.ntime)
    seg = _one_event_segment(cfg, stream)
    for use_native in (True, False):
        dec = decode_segment(cfg, cal, seg, use_native=use_native)
        assert dec.bad_slot[0] == -3
        assert dec.pres[0].sum() == 0
        assert dec.signal[0].sum() == 0.0
    _, g_pres, _, g_bad = decode_event_golden(cfg, stream)
    assert g_bad == -3 and g_pres.sum() == 0


def test_guard_counters_reach_run_result(small_cfg, small_cal, tmp_path):
    """Bad-slot / truncated / oversize events are tallied into RunResult and
    the merged WF file's counters (the reference's printed warnings as
    counters, ref :830-836, :867-872)."""
    from npswf.runtime.executor import run_segment
    from npswf.io.writer import read_wf
    cfg, cal = small_cfg, small_cal
    T = cfg.ntime
    ok = np.concatenate([[0.0, float(T)], 3.0 + np.zeros(T)])
    bad_slot = np.concatenate([[3000.0, float(T)], np.zeros(T)])  # invalid slot
    truncated = np.concatenate([[1.0, float(T)], np.zeros(12)])
    oversize = np.zeros(cfg.ndata_max + 4)
    streams = [ok, bad_slot, truncated, oversize]
    seg = build_segment(cfg, streams, [_EMPTY_HITS] * 4,
                        evt=np.arange(1.0, 5.0), runnum=np.full(4, 1.0))
    out = str(tmp_path / "wf.npz")
    res = run_segment(cfg, cal, seg, out, batch_size=4, resume=False)
    assert res.n_bad_slot == 1
    assert res.n_truncated == 1
    assert res.n_oversize == 1
    wf = read_wf(out)
    assert list(wf["fit_counters"][3:6]) == [1, 1, 1]


def test_mf_asymmetry_rejected():
    """mfleft != mfright reads out of bounds in the reference (TEST_2.C:158)
    -> rejected at config construction."""
    with pytest.raises(ValueError, match="mfleft"):
        NPSConfig(mfleft=4, mfright=6)


def test_nonunit_knot_spacing_rejected(cfg, tmp_path):
    """A calibration file whose time axis is not a unit grid must be rejected
    (the device spline assumes dx == 1; ref Interpolator handles any x)."""
    from npswf.core.calibration import EpochManifest, load_calibration
    root = str(tmp_path)
    T = cfg.ntime
    xs = 0.5 * np.arange(T)              # dx = 0.5: invalid
    ys = np.exp(-0.5 * ((np.arange(T) - 40.0) / 4.0) ** 2)
    lines = ["40.0 0.0"] + [f"{x} {y}" for x, y in zip(xs, ys)]
    with open(os.path.join(root, "ref_wf_0.txt"), "w") as f:
        f.write("\n".join(lines))
    manifest = EpochManifest(root=root, epochs=[(0, 10 ** 9, ".")])
    with pytest.raises(ValueError, match="knot spacing"):
        load_calibration(cfg, manifest, run=3000)
