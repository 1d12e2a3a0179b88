"""spline_mode="onehot" must be numerically identical to "gather"."""
import numpy as np
import jax.numpy as jnp

from npswf.ops.spline import spline_eval_grad


def test_onehot_matches_gather_exactly(cfg, cal):
    rng = np.random.default_rng(9)
    N, Q = 64, 180
    blocks = rng.integers(0, cfg.nblocks, N)
    t = rng.uniform(-20.0, 130.0, (N, Q))
    co = jnp.asarray(cal.spline_coeffs[blocks].astype(np.float32))
    x0 = jnp.asarray(cal.spline_x0[blocks].astype(np.float32))
    tq = jnp.asarray(t.astype(np.float32))
    v1, d1 = spline_eval_grad(cfg.replace(spline_mode="gather"), co, x0, tq)
    v2, d2 = spline_eval_grad(cfg.replace(spline_mode="onehot"), co, x0, tq)
    # bit-identical: one-hot rows have a single exact 1.0
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


def test_fit_same_result_under_onehot(cfg, cal):
    from tests.test_fit import _build_inputs
    from npswf.fit.lm import fit_waveforms
    inp, t_true, a_true, ped, npul = _build_inputs(cfg, cal, n_lanes=16, seed=8,
                                                   dtype=np.float32)
    r1 = fit_waveforms(cfg.replace(spline_mode="gather"), inp)
    r2 = fit_waveforms(cfg.replace(spline_mode="onehot"), inp)
    np.testing.assert_array_equal(np.asarray(r1.converged), np.asarray(r2.converged))
    np.testing.assert_allclose(np.asarray(r1.params), np.asarray(r2.params),
                               rtol=1e-6, atol=1e-6)
