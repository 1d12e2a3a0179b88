"""Model-family plumbing: cfg.model_name end-to-end through the engine.

These tests run the gaussian family through
``process_batch`` purely by config — model selection, the generic
``model_aux`` channel, and the relative-time frame (FitInputs.timeref)."""
import numpy as np
import jax.numpy as jnp
import pytest

from npswf.engine.pipeline import EventBatch, process_batch


def _gauss_batch(cfg, cal, width, seed=3):
    """Events whose true pulses ARE gaussians of the given width."""
    rng = np.random.default_rng(seed)
    E, B, T = 2, cfg.nblocks, cfg.ntime
    x = np.arange(T, dtype=np.float64)
    sig = 0.3 * rng.standard_normal((E, B, T))
    truth = {}
    for e in range(E):
        for b in rng.choice(B, size=6, replace=False):
            delta = rng.uniform(-2.0, 2.0)
            amp = rng.uniform(80.0, 150.0)
            ped = rng.uniform(-3.0, 3.0)
            c = cal.timeref[b] + delta
            sig[e, b] += ped + amp * np.exp(-0.5 * ((x - c) / width) ** 2)
            truth[(e, int(b))] = (delta, amp, ped)
    batch = EventBatch(signal=jnp.asarray(sig),
                       pres=jnp.ones((E, B), bool),
                       corr_time_HMS=jnp.zeros(E),
                       evt=jnp.arange(E), runnum=jnp.zeros(E))
    return batch, truth


def test_gaussian_family_through_engine(small_cfg, small_cal):
    width = 3.5
    cfg = small_cfg.replace(model_name="gaussian",
                            model_aux=(("width", width),))
    batch, truth = _gauss_batch(small_cfg, small_cal, width)
    calib = {k: jnp.asarray(v) for k, v in small_cal.device_arrays(cfg).items()}
    import jax
    out = jax.jit(lambda b: process_batch(cfg, calib, b))(batch)
    conv = np.asarray(out.fit_converged)
    chi2 = np.asarray(out.chi2)
    pedwf = np.asarray(out.pedwf)
    wftime = np.asarray(out.wftime)
    gate = np.asarray(out.gate)
    checked = 0
    for (e, b), (delta, amp, ped) in truth.items():
        if not gate[e, b]:
            continue  # noise landed the cluster gate below threshold
        assert conv[e, b], f"gaussian fit failed on lane ({e},{b})"
        assert chi2[e, b] >= 0
        # fitted pedestal persisted (solver p0, not a re-estimate)
        assert abs(pedwf[e, b] - ped) < 1.0, (pedwf[e, b], ped)
        # first pulse time in ns: t_rel*dt + corr - cortime - timerefacc*dt
        expect_ns = (delta * cfg.dt - small_cal.cortime[b]
                     - small_cal.timerefacc * cfg.dt)
        assert abs(wftime[e, b, 0] - expect_ns) < 0.5 * cfg.dt, \
            (wftime[e, b, 0], expect_ns)
        checked += 1
    assert checked >= 8, f"only {checked} truth lanes exercised"


def test_gaussian_beats_spline_on_gaussian_data(small_cfg, small_cal):
    """Selecting the matching model family must lower chi2: the same batch
    fitted with model_name='gaussian' vs the (wrong-shape) spline template."""
    width = 3.5
    batch, truth = _gauss_batch(small_cfg, small_cal, width, seed=9)
    calib = {k: jnp.asarray(v) for k, v in
             small_cal.device_arrays(small_cfg).items()}
    import jax
    cfg_g = small_cfg.replace(model_name="gaussian",
                              model_aux=(("width", width),))
    out_g = jax.jit(lambda b: process_batch(cfg_g, calib, b))(batch)
    out_s = jax.jit(lambda b: process_batch(small_cfg, calib, b))(batch)
    cg, cs = np.asarray(out_g.chi2), np.asarray(out_s.chi2)
    both = (cg >= 0) & (cs >= 0)
    assert both.sum() >= 5
    assert np.median(cg[both]) < np.median(cs[both])


def _biexp_shape(x, c, tau_r, tau_d):
    """Unit-peak biexp with peak at c (the model's parameterization)."""
    ustar = np.log(tau_d / tau_r) * tau_r * tau_d / (tau_d - tau_r)
    norm = 1.0 / (np.exp(-ustar / tau_d) - np.exp(-ustar / tau_r))
    v = x - c + ustar
    s = np.where(v > 0,
                 norm * (np.exp(-np.maximum(v, 0) / tau_d)
                         - np.exp(-np.maximum(v, 0) / tau_r)), 0.0)
    return s


def test_biexp_family_through_engine(small_cfg, small_cal):
    tau_r, tau_d = 1.8, 9.0
    cfg = small_cfg.replace(model_name="biexp",
                            model_aux=(("tau_r", tau_r), ("tau_d", tau_d)))
    rng = np.random.default_rng(7)
    E, B, T = 2, small_cfg.nblocks, small_cfg.ntime
    x = np.arange(T, dtype=np.float64)
    sig = 0.3 * rng.standard_normal((E, B, T))
    truth = {}
    for e in range(E):
        for b in rng.choice(B, size=6, replace=False):
            delta = rng.uniform(-2.0, 2.0)
            amp = rng.uniform(80.0, 150.0)
            ped = rng.uniform(-3.0, 3.0)
            c = small_cal.timeref[b] + delta
            sig[e, b] += ped + amp * _biexp_shape(x, c, tau_r, tau_d)
            truth[(e, int(b))] = (delta, amp, ped)
    batch = EventBatch(signal=jnp.asarray(sig),
                       pres=jnp.ones((E, B), bool),
                       corr_time_HMS=jnp.zeros(E),
                       evt=jnp.arange(E), runnum=jnp.zeros(E))
    calib = {k: jnp.asarray(v) for k, v in small_cal.device_arrays(cfg).items()}
    import jax
    out = jax.jit(lambda b: process_batch(cfg, calib, b))(batch)
    conv = np.asarray(out.fit_converged)
    wftime = np.asarray(out.wftime)
    wfampl = np.asarray(out.wfampl)
    gate = np.asarray(out.gate)
    checked = 0
    for (e, b), (delta, amp, ped) in truth.items():
        if not gate[e, b]:
            continue
        assert conv[e, b], f"biexp fit failed on lane ({e},{b})"
        expect_ns = (delta * cfg.dt - small_cal.cortime[b]
                     - small_cal.timerefacc * cfg.dt)
        assert abs(wftime[e, b, 0] - expect_ns) < 0.5 * cfg.dt, \
            (wftime[e, b, 0], expect_ns)
        assert abs(wfampl[e, b, 0] - amp) / amp < 0.15
        checked += 1
    assert checked >= 8, f"only {checked} truth lanes exercised"


def test_model_aux_round_trips_through_json():
    from npswf.core.config import NPSConfig
    cfg = NPSConfig(model_name="gaussian", model_aux=(("width", 4.0),))
    cfg2 = NPSConfig.from_json(cfg.to_json())
    assert cfg2 == cfg
    assert hash(cfg2) == hash(cfg)  # stays jit-cache-key compatible


def test_cli_model_flag_parses():
    from npswf.tools.cli import build_parser
    args = build_parser().parse_args(
        ["run", "--model", "gaussian", "--input", "x.npz", "--out", "y.npz"])
    assert args.model == "gaussian"
