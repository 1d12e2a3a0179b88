"""Template extraction: recover per-block reference waveforms from raw data.

The reference consumes externally produced templates (ref TEST_2.C:425-455);
tools/extract_templates.py regenerates them from clean single-pulse events.
Ground truth: synthesize events from a known calibration, extract, compare.
"""
import numpy as np
import pytest

from npswf.tools.extract_templates import (estimate_template_shift,
                                           extract_templates,
                                           extract_templates_from_arrays)
from npswf.utils.synthetic import make_events


def _aligned_dev(true_y, ext_y):
    """Max template deviation after removing the phase gauge freedom
    (the extracted template's absolute phase is set by the mean pulse
    arrival time, error ~ jitter/sqrt(n); absorbed by cortime downstream)."""
    delta = estimate_template_shift(true_y, ext_y)
    t = np.arange(true_y.size, dtype=np.float64)
    aligned = np.interp(t + delta, t, true_y)
    return float(np.max(np.abs(aligned - ext_y))), delta


@pytest.fixture(scope="module")
def extracted(small_cfg, small_cal):
    cfg, cal = small_cfg, small_cal
    truth = make_events(cfg, cal, 64, occupancy=1.0, max_pulses=1,
                        noise=0.4, amp_range=(40.0, 200.0), seed=11)
    bundle, st = extract_templates_from_arrays(
        cfg, truth.signal, truth.pres.astype(bool), min_candidates=6)
    return cfg, cal, bundle, st


def test_templates_match_truth(extracted):
    cfg, cal, bundle, st = extracted
    B = cfg.nblocks
    assert st.n_extracted == B, (st.n_extracted, st.candidates_per_block)
    assert bundle.preswf.all()
    # unit-peak templates agree with the true shapes everywhere, after
    # removing the per-block phase gauge freedom (see _aligned_dev)
    for b in range(B):
        dev, delta = _aligned_dev(cal.interp_y[b], bundle.interp_y[b])
        assert dev < 0.03, (b, dev)
        assert abs(delta) < 1.5, (b, delta)
    # the argmax-derived timeref lands near the true one (integer-bin rule
    # + the <1.5-bin phase freedom)
    assert np.max(np.abs(bundle.timeref - cal.timeref)) <= 2.0
    # derived artifacts are self-consistent with the loader's derivation
    np.testing.assert_allclose(bundle.mfint, bundle.mfkern_rev.sum(axis=1),
                               rtol=1e-12)


def test_extracted_calibration_drives_the_pipeline(extracted):
    """End-to-end: a pipeline run with the EXTRACTED calibration reproduces
    pulse times found with the true calibration to a fraction of a bin."""
    import jax.numpy as jnp
    from npswf.engine.pipeline import EventBatch, process_batch
    cfg, cal, bundle, _ = extracted
    truth = make_events(cfg, cal, 4, occupancy=0.3, max_pulses=1,
                        noise=0.4, amp_range=(40.0, 200.0), seed=12)
    E = truth.signal.shape[0]
    batch = EventBatch(
        signal=jnp.asarray(truth.signal),
        pres=jnp.asarray(truth.pres.astype(bool)),
        corr_time_HMS=jnp.zeros(E),
        evt=jnp.arange(E, dtype=jnp.float64),
        runnum=jnp.full(E, 3000.0))
    out_true = process_batch(
        cfg, {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()},
        batch)
    out_ext = process_batch(
        cfg, {k: jnp.asarray(v) for k, v in bundle.device_arrays(cfg).items()},
        batch)
    npul_t = np.asarray(out_true.wfnpulse)
    npul_e = np.asarray(out_ext.wfnpulse)
    active = truth.npulse > 0
    # every true pulse is found under both calibrations (noise-only lanes
    # are excluded: their sub-threshold peaks may flip either way)
    sel = active & (npul_t > 0) & (npul_e > 0)
    assert sel.sum() >= 0.9 * active.sum()

    # wftime is ns with each calibration's own timeref/cortime folded in
    # (t_ns = (t - timeref)*dt + corr - cortime - timerefacc*dt); invert
    # per bundle to compare the ABSOLUTE fitted pulse time in bins
    def absolute_bins(out, cb):
        t_ns = np.asarray(out.wftime)[..., 0]
        t_rel = (t_ns + cb.cortime[None, :] +
                 cb.timerefacc * cfg.dt) / cfg.dt
        return t_rel + cb.timeref[None, :]

    # the extracted template's phase offset delta_b shifts all fitted
    # times of block b coherently; measure it from the templates and
    # remove it (it is a calibration constant, absorbed by cortime)
    delta = np.array([estimate_template_shift(cal.interp_y[b],
                                              bundle.interp_y[b])
                      for b in range(cfg.nblocks)])
    t_true = absolute_bins(out_true, cal)[sel]
    t_ext = (absolute_bins(out_ext, bundle) - delta[None, :])[sel]
    med = np.median(np.abs(t_true - t_ext))
    assert med < 0.12, med


def test_starved_blocks_fall_back_or_absent(small_cfg, small_cal):
    cfg, cal = small_cfg, small_cal
    truth = make_events(cfg, cal, 24, occupancy=1.0, max_pulses=1,
                        noise=0.4, amp_range=(40.0, 200.0), seed=13)
    # blank out all data for the last two blocks
    sig = truth.signal.copy()
    pres = truth.pres.astype(bool).copy()
    pres[:, -2:] = False
    # no base: starved blocks are absent
    b1, s1 = extract_templates_from_arrays(cfg, sig, pres, min_candidates=6,
                                           run=3032)
    assert not b1.preswf[-2:].any()
    assert s1.n_absent == 2
    # absent blocks keep the loader's -1e6 timeref sentinel (empty cluster
    # coincidence window), and the requested run is recorded
    assert (b1.timeref[-2:] == -1.0e6).all()
    assert b1.run == 3032
    # with base: starved blocks keep the base template and its metadata
    b2, s2 = extract_templates_from_arrays(cfg, sig, pres, base=cal,
                                           min_candidates=6)
    assert b2.preswf.all()
    assert s2.n_from_base == 2
    np.testing.assert_array_equal(b2.interp_y[-2:], cal.interp_y[-2:])
    np.testing.assert_array_equal(b2.tdcoffset, cal.tdcoffset)


def test_pileup_rejected_by_isolation(small_cfg, small_cal):
    """Events with a second displaced pulse must not pollute the template."""
    cfg, cal = small_cfg, small_cal
    clean = make_events(cfg, cal, 48, occupancy=1.0, max_pulses=1,
                        noise=0.4, amp_range=(40.0, 200.0), seed=14)
    piled = make_events(cfg, cal, 48, occupancy=1.0, max_pulses=3,
                        noise=0.4, amp_range=(40.0, 200.0), seed=15,
                        pileup_prob=1.0)
    sig = np.concatenate([clean.signal, piled.signal])
    pres = np.concatenate([clean.pres, piled.pres]).astype(bool)
    bundle, st = extract_templates_from_arrays(cfg, sig, pres,
                                               min_candidates=6)
    assert st.n_extracted == cfg.nblocks
    for b in range(cfg.nblocks):
        dev, _ = _aligned_dev(cal.interp_y[b], bundle.interp_y[b])
        assert dev < 0.04, (b, dev)


def test_cli_roundtrip(small_cfg, small_cal, tmp_path, monkeypatch):
    """segment file -> extract-templates CLI -> loadable bundle."""
    from npswf.io.rawstream import (build_segment, encode_event_stream,
                                    write_segment)
    from npswf.tools import extract_templates as mod
    cfg, cal = small_cfg, small_cal
    truth = make_events(cfg, cal, 32, occupancy=1.0, max_pulses=1,
                        noise=0.4, amp_range=(40.0, 200.0), seed=16)
    streams = [encode_event_stream(cfg, truth.signal[e],
                                   truth.pres[e].astype(bool))
               for e in range(32)]
    hits = [{"adc_counter": np.zeros(0), "pulse_time": np.zeros(0),
             "pulse_time_raw": np.zeros(0), "pulse_amp": np.zeros(0),
             "pulse_int": np.zeros(0), "pulse_ped": np.zeros(0)}
            for _ in range(32)]
    seg = build_segment(cfg, streams, hits,
                        evt=np.arange(1, 33, dtype=np.float64),
                        runnum=np.full(32, 3000.0))
    seg_path = str(tmp_path / "seg.npz")
    write_segment(seg_path, seg)
    out = str(tmp_path / "cal_extracted.npz")
    # config_for_run would build the full 1080-block geometry; pin the
    # small one for the CLI path
    monkeypatch.setattr("npswf.core.config.config_for_run",
                        lambda run: cfg)
    rc = mod.main([seg_path, out, "--no-native"])
    assert rc == 0
    from npswf.core.calibration import CalibrationBundle
    loaded = CalibrationBundle.load(out)
    assert loaded.preswf.sum() == cfg.nblocks

    # drift-monitoring mode: extracted vs true bundle — small phase shift,
    # small aligned shape deviation
    cal_path = str(tmp_path / "cal_true.npz")
    cal.save(cal_path)
    rc = mod.main([cal_path, out, "--compare"])
    assert rc == 0
    delta, dev = mod.compare_bundles(cal, loaded)
    assert np.nanmax(np.abs(delta)) < 1.5
    assert np.nanmax(dev) < 0.04
