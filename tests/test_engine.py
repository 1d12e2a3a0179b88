"""End-to-end engine tests on synthetic batches."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from npswf.engine.pipeline import EventBatch, make_pipeline, process_batch
from npswf.golden.reference import cluster_gate_golden, find_pulses_golden
from npswf.utils.synthetic import make_events


def _batch(cfg, cal, E=3, seed=7, occupancy=0.05, **kw):
    truth = make_events(cfg, cal, E, occupancy=occupancy, seed=seed, **kw)
    rng = np.random.default_rng(seed + 1)
    corr = rng.uniform(-2, 2, E)
    batch = EventBatch(
        signal=jnp.asarray(truth.signal),
        pres=jnp.asarray(truth.pres.astype(bool)),
        corr_time_HMS=jnp.asarray(corr),
        evt=jnp.arange(E, dtype=jnp.int64),
        runnum=jnp.full(E, 3000, dtype=jnp.int64))
    return truth, batch, corr


def test_pipeline_end_to_end(cfg, cal):
    truth, batch, corr = _batch(cfg, cal, E=3, occupancy=0.06, max_pulses=2)
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}
    out = process_batch(cfg, calib, batch)
    E, B = truth.signal.shape[:2]
    npulse = np.asarray(out.wfnpulse)
    assert npulse.sum() > 0.5 * truth.npulse.sum()
    # converged fits dominate
    act = np.asarray(out.gate) & (npulse > 0)
    conv = np.asarray(out.fit_converged)
    assert conv[act].mean() > 0.95
    assert int(out.n_fit_success) == int(conv.sum())
    assert int(out.n_fit_failure) == int((act & ~conv).sum())
    assert int(out.n_fit_dropped) == 0
    # chi2 flag semantics
    chi2 = np.asarray(out.chi2)
    assert np.all(chi2[~act] == -100.0)
    assert np.all(chi2[conv] >= 0.0)
    # timewf defined exactly on fitted lanes with pulses
    timewf = np.asarray(out.timewf)
    assert np.all(timewf[~act] == -100.0)
    assert np.all(timewf[act & conv] != -100.0)


def test_time_conversion_formula(cfg, cal):
    """wftime on fit paths must equal t_rel*dt + corr - cortime - timerefacc*dt."""
    truth, batch, corr = _batch(cfg, cal, E=2, occupancy=0.05, max_pulses=1)
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}
    out = process_batch(cfg, calib, batch)
    E, B = truth.signal.shape[:2]
    npulse = np.asarray(out.wfnpulse)
    conv = np.asarray(out.fit_converged)
    wftime = np.asarray(out.wftime)
    checked = 0
    for e in range(E):
        for b in np.nonzero(conv[e] & (npulse[e] == 1))[0]:
            t_ns = wftime[e, b, 0]
            # invert: recovered absolute peak bin should be near the truth
            t_rel = (t_ns - corr[e] + cal.cortime[b] + cal.timerefacc * cfg.dt) / cfg.dt
            t_abs = t_rel + cal.timeref[b]
            if truth.npulse[e, b] == 1:
                assert abs(t_abs - truth.times[e, b, 0]) < 0.5, (e, b)
                checked += 1
    assert checked > 5


def test_gate_fail_path_keeps_bins(cfg, cal):
    """Blocks failing the cluster gate keep raw TSpectrum bin times, chi2=-100."""
    truth, batch, corr = _batch(cfg, cal, E=2, occupancy=0.05, max_pulses=1,
                                amp_range=(25.0, 60.0))
    # sabotage the gate with a huge trig threshold -> nothing passes
    cfg_hi = cfg.replace(trig_thres=1e9)
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}
    out = process_batch(cfg_hi, calib, batch)
    npulse = np.asarray(out.wfnpulse)
    wftime = np.asarray(out.wftime)
    chi2 = np.asarray(out.chi2)
    assert not np.asarray(out.gate).any()
    assert np.all(chi2 == -100.0)
    assert np.all(np.asarray(out.timewf) == -100.0)
    # raw times are bin positions inside the search window
    lanes = npulse > 0
    assert lanes.sum() > 0
    for e, b in zip(*np.nonzero(lanes)):
        t = wftime[e, b, :npulse[e, b]]
        assert np.all((t > cfg.mfstart) & (t < cfg.mfend))


def test_fit_capacity_drop_counter(cfg, cal):
    truth, batch, corr = _batch(cfg, cal, E=2, occupancy=0.08, max_pulses=1)
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}
    cfg_cap = cfg.replace(fit_capacity=4)
    out = process_batch(cfg_cap, calib, batch)
    out_full = process_batch(cfg, calib, batch)
    n_act = int((np.asarray(out_full.gate) & (np.asarray(out_full.wfnpulse) > 0)).sum())
    assert int(out.n_fit_dropped) == max(0, n_act - 4)
    assert int(out.n_fit_success) <= 4


def test_engine_matches_golden_decisions(cfg, cal):
    """wfnpulse and gate decisions match the scalar oracle per lane."""
    truth, batch, corr = _batch(cfg, cal, E=1, occupancy=0.04, max_pulses=2, seed=17)
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}
    out = process_batch(cfg, calib, batch)
    npulse = np.asarray(out.wfnpulse)[0]
    gate = np.asarray(out.gate)[0]
    sig = truth.signal[0]
    pres = truth.pres[0]
    check_blocks = list(np.nonzero(truth.npulse[0])[0][:15]) + [0, 500, 1079]
    for b in check_blocks:
        gn, gt, ga = find_pulses_golden(cfg, sig[b], sig[b].min(),
                                        cal.mfkern_rev[b], cal.mfint[b], True)
        assert npulse[b] == gn, b
        gg = cluster_gate_golden(cfg, sig, pres, int(b), cal.timeref[b],
                                 cal.timerefacc)
        assert bool(gate[b]) == gg, b


def test_pipeline_jit_consistency(cfg, cal):
    truth, batch, corr = _batch(cfg, cal, E=2, occupancy=0.04)
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}
    eager = process_batch(cfg, calib, batch)
    jitted = make_pipeline(cfg, calib)(batch)
    for name in ("wfnpulse", "chi2", "wftime", "timewf", "enertot"):
        np.testing.assert_allclose(np.asarray(getattr(jitted, name)),
                                   np.asarray(getattr(eager, name)),
                                   rtol=1e-10, atol=1e-10, err_msg=name)


def test_diagnostics_match_golden(cfg, cal):
    from npswf.engine.diagnostics import block_diagnostics
    from npswf.golden.reference import diagnostics_golden
    truth = make_events(cfg, cal, 1, occupancy=0.05, seed=19)
    d = block_diagnostics(cfg, jnp.asarray(truth.signal))
    g = diagnostics_golden(cfg, truth.signal[0])
    for k in ("ener", "integ", "bkg", "noise", "sigmax", "ampl", "time"):
        np.testing.assert_allclose(np.asarray(d[k])[0], g[k], rtol=1e-10,
                                   atol=1e-10, err_msg=k)
    np.testing.assert_allclose(float(d["enertot"][0]), g["enertot"], rtol=1e-10)
    np.testing.assert_allclose(float(d["integtot"][0]), g["integtot"], rtol=1e-10)


def test_executor_with_mesh(cfg, cal, tmp_path):
    """The executor's sharded path produces the same WF file as single-device."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from npswf.io.rawstream import build_segment, encode_event_stream
    from npswf.runtime.executor import run_segment
    from npswf.parallel.mesh import make_mesh
    from npswf.io.writer import read_wf
    rng = np.random.default_rng(3)
    E = 8
    truth = make_events(cfg, cal, E, occupancy=0.04, seed=23)
    streams = [encode_event_stream(cfg, truth.signal[e],
                                   truth.pres[e].astype(bool))
               for e in range(E)]
    hits = [{k: np.zeros(0) for k in
             ("adc_counter", "pulse_time", "pulse_time_raw",
              "pulse_amp", "pulse_int", "pulse_ped")} for _ in range(E)]
    seg = build_segment(cfg, streams, hits,
                        evt=np.arange(1, E + 1, dtype=np.float64),
                        runnum=np.full(E, 3000.0))
    out1 = str(tmp_path / "wf1.npz")
    out2 = str(tmp_path / "wf2.npz")
    run_segment(cfg, cal, seg, out1, batch_size=8)
    mesh = make_mesh(cfg, n_data=4, n_block=2)
    run_segment(cfg, cal, seg, out2, batch_size=8, mesh=mesh)
    a, b = read_wf(out1), read_wf(out2)
    np.testing.assert_array_equal(a["wfnpulse"], b["wfnpulse"])
    # Last-ulp (fp32) tolerance, not bitwise: the tiered stage-1
    # continuation re-solves unconverged lanes in compacted chunks whose
    # width is shard-local (N//8), and XLA's vector-body vs remainder-tail
    # codegen for the transcendentals differs by 1 ulp between widths
    # (same caveat as the tier-equivalence test in test_fit.py).
    np.testing.assert_allclose(a["chi2"], b["chi2"], rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(a["wftime_flat"], b["wftime_flat"],
                               rtol=2e-6, atol=2e-6)


def test_search_capacity_equivalence_and_overflow(small_cfg, small_cal):
    """Search-lane compaction (cfg.search_capacity) is result-identical when
    the capacity covers every present lane, and counts (never silently
    drops) the overflow when it does not."""
    import jax
    from npswf.utils.synthetic import make_events
    cfg = small_cfg
    E = 4
    truth = make_events(cfg, small_cal, E, occupancy=0.4, max_pulses=2,
                        pileup_prob=0.3, seed=41)
    # make readout presence itself sparse (make_events marks every block
    # present; real events read out only the hit region, ref :854-889)
    rng = np.random.default_rng(43)
    pres = truth.pres.astype(bool) & (rng.random((E, cfg.nblocks)) < 0.6)
    batch = EventBatch(signal=jnp.asarray(truth.signal),
                       pres=jnp.asarray(pres),
                       corr_time_HMS=jnp.zeros(E),
                       evt=jnp.arange(E), runnum=jnp.zeros(E))
    calib = {k: jnp.asarray(v) for k, v in
             small_cal.device_arrays(cfg).items()}
    N = E * cfg.nblocks
    n_present = int((pres & np.asarray(calib["preswf"])[None, :]).sum())
    assert 0 < n_present < N

    base = jax.jit(lambda b: process_batch(cfg, calib, b))(batch)
    cfg_cap = cfg.replace(search_capacity=n_present + 3)
    capped = jax.jit(lambda b: process_batch(cfg_cap, calib, b))(batch)
    assert int(np.asarray(capped.n_search_dropped)) == 0
    np.testing.assert_array_equal(np.asarray(base.wfnpulse),
                                  np.asarray(capped.wfnpulse))
    np.testing.assert_array_equal(np.asarray(base.wftime),
                                  np.asarray(capped.wftime))
    np.testing.assert_array_equal(np.asarray(base.chi2),
                                  np.asarray(capped.chi2))
    np.testing.assert_array_equal(np.asarray(base.fit_converged),
                                  np.asarray(capped.fit_converged))

    # capacity below the present count: overflow is counted, processed
    # lanes still match the uncompacted results lane-for-lane
    cap = max(2, n_present - 5)
    cfg_small = cfg.replace(search_capacity=cap)
    over = jax.jit(lambda b: process_batch(cfg_small, calib, b))(batch)
    assert int(np.asarray(over.n_search_dropped)) == n_present - cap
    searched = np.asarray(over.wfnpulse) > 0
    np.testing.assert_array_equal(np.asarray(over.wfnpulse)[searched],
                                  np.asarray(base.wfnpulse)[searched])
    # the per-lane overflow flag marks exactly the present lanes that lost
    # their search slot (so wfnpulse==0 there is a capacity artifact)
    so = np.asarray(over.search_overflow)
    present = pres & np.asarray(calib["preswf"])[None, :]
    assert int(so.sum()) == n_present - cap
    assert np.all(~so | present)                     # flagged => present
    assert np.all(np.asarray(over.wfnpulse)[so] == 0)
    assert not np.asarray(capped.search_overflow).any()
    assert not np.asarray(base.search_overflow).any()


def test_max_pileup_zero_drops(cfg, cal):
    """fit_capacity=0 means fit EVERY gate-passed block, including when every
    lane lands in the wide (high-pileup) bucket — the reference fits every
    block unconditionally (ref TEST_2.C:942-1020). Full geometry on purpose:
    with N = 1080 lanes all wide, a fixed 256-lane wide-bucket cap (the old
    heuristic) would drop 824 of them."""
    from npswf.core.calibration import spline_eval_np
    E, B, T = 1, cfg.nblocks, cfg.ntime
    # deterministic max-pileup event: 4 pulses at 25-bin spacing per block —
    # wide enough apart for the MF/TSpectrum chain to resolve all four
    # against the ~60-bin synthetic template (verified: every block yields
    # found npulse == 4), so EVERY lane lands in the wide bucket
    rng = np.random.default_rng(57)
    x = np.arange(T, dtype=np.float64)
    signal = 2.0 + 0.4 * rng.standard_normal((E, B, T))
    for b in range(B):
        tr = cal.timeref[b]
        for t0, a0 in ((18.0, 150.0), (43.0, 90.0), (68.0, 150.0),
                       (93.0, 90.0)):
            arg = x - (t0 - tr)
            g = (arg > cfg.spline_gate_lo) & (arg < T - 1)
            signal[0, b] += np.where(g, a0 * spline_eval_np(
                cal.spline_coeffs[b], cal.spline_x0[b], arg), 0.0)
    batch = EventBatch(signal=jnp.asarray(signal),
                       pres=jnp.ones((E, B), bool),
                       corr_time_HMS=jnp.zeros(E),
                       evt=jnp.arange(E), runnum=jnp.zeros(E))
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}
    out = jax.jit(lambda b: process_batch(cfg, calib, b))(batch)
    npulse = np.asarray(out.wfnpulse)
    act = np.asarray(out.gate) & (npulse > 0)
    # (nearly) every lane actually landed in the wide bucket — far beyond
    # the old 256-lane cap
    assert int((npulse > cfg.fit_small_pulses).sum()) > 1000
    assert int(out.n_fit_dropped) == 0
    # every active lane was fitted (success or failure, never dropped)
    assert int(out.n_fit_success) + int(out.n_fit_failure) == int(act.sum())
    # fitted+converged lanes carry sane chi2 (not the -100 sentinel)
    chi2 = np.asarray(out.chi2)
    conv = np.asarray(out.fit_converged)
    assert np.all(chi2[conv] >= 0.0)
    assert np.all(chi2[~act] == -100.0)
