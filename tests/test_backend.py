"""Spline-mode policy, compile-cache placement, device refusal, dot precision,
synthetic segments."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from npswf.fit.lm import _prepare, lm_solve
from npswf.models.waveform import get_model
from npswf.ops.spline import spline_mode
from npswf.utils import compile_cache
from tests.test_fit import _build_inputs

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


@pytest.mark.parametrize("platform", ["cpu", "gpu", "unknown"])
def test_spline_mode_policy(cfg, platform):
    """auto takes the gather everywhere (on the GPU by measurement); an
    explicit mode is kept on every platform."""
    assert spline_mode(cfg, platform) == "gather"
    for mode in ("gather", "onehot"):
        assert spline_mode(cfg.replace(spline_mode=mode), platform) == mode


@pytest.mark.parametrize("env_dir", [None, "/somewhere/jax-cache"])
def test_compile_cache_placement(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and no other directory is set in
    code; without it the cache sits at the fixed <repo>/.jax_cache."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    used = compile_cache.setup_compile_cache()
    if env_dir is None:
        assert used == os.path.join(_REPO, ".jax_cache")
        assert calls["jax_compilation_cache_dir"] == used
    else:
        assert used == env_dir
        assert "jax_compilation_cache_dir" not in calls


def test_dryrun_multichip_raises_with_too_few_devices():
    sys.path.insert(0, _REPO)
    from __graft_entry__ import dryrun_multichip
    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match=f"need {n} devices"):
        dryrun_multichip(n)


def _dot_precisions(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out += _dot_precisions(sub)
    return out


def test_normal_equation_dots_pin_highest_precision(cfg, cal):
    """At fp32 a GPU dot may take TF32 operands (~3 digits) unless asked
    for more: every dot of the LM solve asks for HIGHEST."""
    inp, *_ = _build_inputs(cfg, cal, n_lanes=8, seed=3, max_pulses=2,
                            dtype=np.float32)
    lo, hi, p_seed, pm, u0, _, _ = _prepare(cfg, inp)
    jaxpr = jax.make_jaxpr(lambda i: lm_solve(
        cfg, get_model("spline_ref"), i, u0, lo, hi, p_seed, pm, i.active, 4,
        cfg.lm_lambda_init))(inp)
    precs = _dot_precisions(jaxpr.jaxpr)
    assert len(precs) >= 2                 # A = J^T J and g = J^T r
    hi_prec = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None and all(q == hi_prec for q in p), p


def test_bench_refuses_cpu_platform():
    res = subprocess.run([sys.executable, os.path.join(_REPO, "bench.py")],
                         cwd=_REPO, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 2, res.stderr[-2000:]
    assert res.stdout.strip() == ""
    assert "not 'gpu'" in res.stderr


def test_require_gpu_refuses_cpu():
    from npswf.utils.device_info import NotOnGPU, require_gpu
    with pytest.raises(NotOnGPU, match="not 'gpu'"):
        require_gpu()


def test_synthetic_segment_sparse_readout_round_trip(cfg, cal):
    """A segment encoded with sparse readout (present = blocks with a
    pulse) decodes back to exactly those blocks and their samples."""
    from npswf.io.decode import decode_segment
    from npswf.utils.synthetic import make_events, synthetic_segment
    truth = make_events(cfg, cal, 3, occupancy=0.05, seed=6)
    pres = truth.npulse > 0
    d = decode_segment(cfg, cal, synthetic_segment(cfg, truth, pres=pres),
                       use_native=False)
    np.testing.assert_array_equal(d.pres[:, :cfg.nblocks].astype(bool), pres)
    np.testing.assert_allclose(d.signal[pres], truth.signal[pres], rtol=1e-6,
                               atol=1e-4)
    assert not np.asarray(d.signal)[~pres].any()
