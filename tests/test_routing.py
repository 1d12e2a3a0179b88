"""Engine fit-lane routing is result-neutral.

The pipeline buckets fit lanes by pulse count (narrow 1+2*Ps parameter
systems for <= fit_small_pulses pulses, the wide 1+2*P system otherwise,
engine/pipeline.py). Routing is an efficiency choice and must not change any
result: masked parameter slots contribute exact zeros through the model sum,
the normal equations, and the Cholesky solve. The outputs are not bit-exact
across system widths (XLA picks different reduction trees for 5- vs
25-element sums, so last-ulp differences exist), so equivalence is asserted
as: identical convergence decisions and params/chi2 agreement far below the
0.05-bin parity bar, on noiseless data where convergence is decisive."""
import numpy as np
import jax
import jax.numpy as jnp

from npswf.engine.pipeline import EventBatch, process_batch
from npswf.fit.errors import error_model
from npswf.fit.lm import FitInputs, fit_waveforms
from npswf.ops.peak_search import find_pulses
from npswf.utils.synthetic import make_events


def _pileup_batch(cfg, cal, E=3, seed=29, noise=0.0):
    truth = make_events(cfg, cal, E, occupancy=0.4, max_pulses=4,
                        pileup_prob=0.9, seed=seed, noise=noise)
    batch = EventBatch(signal=jnp.asarray(truth.signal),
                       pres=jnp.asarray(truth.pres.astype(bool)),
                       corr_time_HMS=jnp.zeros(E),
                       evt=jnp.arange(E), runnum=jnp.zeros(E))
    return truth, batch


def test_bucket_boundary_is_result_neutral(small_cfg, small_cal):
    """fit_small_pulses in {1, 2, 12}: identical wftime/wfampl/chi2/converged
    for every lane (bit-exact in fp64 on CPU)."""
    truth, batch = _pileup_batch(small_cfg, small_cal)
    calib = {k: jnp.asarray(v) for k, v in
             small_cal.device_arrays(small_cfg).items()}
    outs = {}
    for ps in (1, 2, small_cfg.maxwfpulses):
        cfg = small_cfg.replace(fit_small_pulses=ps)
        outs[ps] = jax.jit(lambda b, c=cfg: process_batch(c, calib, b))(batch)
    base = outs[2]
    assert int(np.asarray(base.n_fit_dropped)) == 0
    assert np.asarray(base.fit_converged).sum() >= 10
    base_iter = np.asarray(base.fit_n_iter)
    for ps, out in outs.items():
        assert int(np.asarray(out.n_fit_dropped)) == 0, f"ps={ps} dropped lanes"
        np.testing.assert_array_equal(np.asarray(out.wfnpulse),
                                      np.asarray(base.wfnpulse),
                                      err_msg=f"ps={ps}")
        np.testing.assert_array_equal(np.asarray(out.fit_converged),
                                      np.asarray(base.fit_converged),
                                      err_msg=f"ps={ps}")
        # Two-tier tolerance: near the ftol convergence
        # threshold a width-dependent reduction-tree ulp can flip one
        # accept decision and end the trajectory an iteration early/late —
        # same certified minimum, values agreeing to ~1e-7 relative
        # instead of 1e-16. Those "flipped" lanes are identified exactly
        # (their solver iteration counts differ) and get the loose 1e-5
        # cascade bound; every same-trajectory lane must still agree at
        # the near-ulp 1e-7 level, so a genuine sub-1e-5 numeric
        # regression on the routing path cannot hide behind the cascade.
        flip = np.asarray(out.fit_n_iter) != base_iter
        nflip = int(flip.sum())
        assert nflip <= max(4, int(0.02 * np.asarray(base.fit_converged).sum())), \
            f"ps={ps}: {nflip} trajectory flips — routing is not result-neutral"
        for name, tight_atol in (("chi2", 1e-6), ("wftime", 1e-6),
                                 ("wfampl", 1e-6)):
            a, b = np.asarray(getattr(out, name)), np.asarray(getattr(base, name))
            fl = flip[..., None] if a.ndim == 3 else flip
            np.testing.assert_allclose(
                np.where(fl, 0, a), np.where(fl, 0, b),
                rtol=1e-7, atol=tight_atol,
                err_msg=f"ps={ps} {name} (same-trajectory lanes)")
            np.testing.assert_allclose(
                a, b, rtol=1e-5, atol=1e-5,
                err_msg=f"ps={ps} {name} (flipped-lane cascade bound)")
        np.testing.assert_allclose(np.asarray(out.pedwf),
                                   np.asarray(base.pedwf),
                                   rtol=0, atol=1e-6, err_msg=f"ps={ps}")


def test_engine_wide_bucket_matches_standalone_fit(small_cfg, small_cal):
    """A multi-pulse lane routed through the engine's wide bucket must equal
    the same lane fitted by a standalone fit_waveforms call fed the identical
    inputs (seeds, errors, spline, timeref frame)."""
    cfg = small_cfg  # fit_small_pulses=2 -> >2-pulse lanes take the wide path
    truth, batch = _pileup_batch(cfg, small_cal)
    calib = {k: jnp.asarray(v) for k, v in
             small_cal.device_arrays(cfg).items()}
    out = jax.jit(lambda b: process_batch(cfg, calib, b))(batch)
    gate = np.asarray(out.gate)
    npulse = np.asarray(out.wfnpulse)
    conv = np.asarray(out.fit_converged)
    lanes = np.argwhere(gate & (npulse > 2) & conv)
    assert lanes.shape[0] >= 1, "no wide-bucket lanes in the batch"

    E, B, T = truth.signal.shape
    flat_sig = jnp.asarray(truth.signal.reshape(E * B, T))
    mins = jnp.min(flat_sig, axis=1)
    kern = jnp.asarray(np.tile(small_cal.mfkern_rev, (E, 1)))
    mfint = jnp.asarray(np.tile(small_cal.mfint, E))
    ps = find_pulses(cfg, flat_sig, mins, kern, mfint,
                     jnp.ones(E * B, bool))
    P = cfg.maxwfpulses
    for e, b in lanes[:4]:
        lane = e * B + b
        err = error_model(cfg, flat_sig[lane:lane + 1])
        tr = small_cal.timeref[b]
        inp = FitInputs(
            y=flat_sig[lane:lane + 1, cfg.fit_lo_bin:cfg.fit_hi_bin],
            sigma=err[:, cfg.fit_lo_bin:cfg.fit_hi_bin],
            coeffs=jnp.asarray(small_cal.spline_coeffs[b][None]),
            x0=jnp.asarray(small_cal.spline_x0[b][None]),
            t_seed=ps.times[lane:lane + 1] - tr,
            a_seed=ps.amps[lane:lane + 1],
            ped_seed=jnp.mean(flat_sig[lane:lane + 1, :cfg.ped_nsamples],
                              axis=1),
            pulse_mask=ps.valid[lane:lane + 1],
            active=jnp.ones(1, bool),
            timeref=jnp.asarray(np.asarray([tr])))
        res = fit_waveforms(cfg, inp)
        assert bool(np.asarray(res.converged)[0])
        # engine wftime: t_rel*dt + corr - cortime - timerefacc*dt, corr = 0
        conv_term = (-small_cal.cortime[b]
                     - small_cal.timerefacc * cfg.dt)
        t_rel_engine = (np.asarray(out.wftime)[e, b] - conv_term) / cfg.dt
        t_rel_solver = np.asarray(res.params)[0, 1::2]
        n = int(npulse[e, b])
        # XLA lowers the batched normal-equation einsums differently for
        # batch 90 vs batch 1, so the two LM trajectories stop at minima a
        # few 1e-4 bins apart (inside the solver's own lm_gtol slop);
        # equality is asserted at that level — still 25x under the 0.05-bin
        # parity bar
        np.testing.assert_allclose(t_rel_engine[:n], t_rel_solver[:n],
                                   rtol=0, atol=2e-3)
        np.testing.assert_allclose(np.asarray(out.wfampl)[e, b, :n],
                                   np.asarray(res.params)[0, 2::2][:n],
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(np.asarray(out.chi2)[e, b],
                                   np.asarray(res.chi2_ndf)[0],
                                   rtol=1e-2, atol=1e-6)
