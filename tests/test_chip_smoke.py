"""chip_smoke.py on a host without a GPU, its comparison helpers, and the
XLA matched filter / search / gate against the fp64 golden oracle on one
full 1080-block event (the check chip_smoke's phase 4 runs on the card)."""
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from npswf.golden.reference import (cluster_gate_golden, find_pulses_golden,
                                    matched_filter_golden)
from npswf.ops.cluster_gate import cluster_gate
from npswf.ops.matched_filter import matched_filter
from npswf.ops.peak_search import find_pulses
from npswf.utils.synthetic import make_events

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, _REPO)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_cpu_without_ok_line(tmp_path, alone):
    """No GPU: non-zero exit and no ok line — in the repo, and in a
    directory that holds chip_smoke.py and nothing else of the repo."""
    script = os.path.join(_REPO, "chip_smoke.py")
    cwd = _REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _file_and_output(E=2, B=6, P=3, seed=0):
    """A PipelineOutput-like record and the merged-WF-file view of it."""
    rng = np.random.default_rng(seed)
    npul = rng.integers(1, P + 1, (E, B))
    slot = np.arange(P)[None, None, :] < npul[..., None]
    out = SimpleNamespace(
        wfnpulse=npul,
        wftime=np.where(slot, rng.uniform(-50, 50, (E, B, P)), 0.0),
        chi2=np.where(rng.random((E, B)) < 0.9, 1.0, -100.0))
    wf = {"wfnpulse": npul.copy(), "chi2": out.chi2.copy(),
          "wftime_flat": out.wftime[slot]}
    return wf, out


def test_file_mismatch_catches_shifted_time():
    wf, out = _file_and_output()
    assert chip_smoke.file_mismatch(wf, out, "same")["lanes"] == 12
    wf["wftime_flat"] = wf["wftime_flat"].copy()
    wf["wftime_flat"][3] += 0.5           # 0.125 bins: above the 0.05 bar
    with pytest.raises(AssertionError, match="time_off 1 of 12"):
        chip_smoke.file_mismatch(wf, out, "shifted")


def test_file_mismatch_catches_changed_pulse_count():
    wf, out = _file_and_output()
    wf["wfnpulse"] = wf["wfnpulse"].copy()
    wf["wfnpulse"][0, 0] -= 1
    wf["wftime_flat"] = np.delete(wf["wftime_flat"], 0)
    # one lane of a dozen changed: far outside the 1% band ...
    with pytest.raises(AssertionError, match="count_off 1 of 12"):
        chip_smoke.file_mismatch(wf, out, "changed")
    # ... and inside a band that allows one lane in ten
    assert chip_smoke.file_mismatch(wf, out, "banded",
                                    max_count_off=0.1)["count_off"] == 1


def test_single_pulse_dt_catches_shifted_time(cfg, cal):
    """A WF file whose single-pulse times sit 0.5 bins off the truth fails
    the timing bar; the exact times pass."""
    truth = make_events(cfg, cal, 2, occupancy=0.05, max_pulses=1, seed=4)
    corr = np.array([0.7, -1.3])
    e, b = np.nonzero(truth.npulse == 1)
    t_ns = ((truth.times[e, b, 0] - cal.timeref[b]) * cfg.dt + corr[e]
            - cal.cortime[b] - cal.timerefacc * cfg.dt)
    wf = {"wfnpulse": truth.npulse.copy(), "wftime_flat": t_ns,
          "chi2": np.where(truth.npulse > 0, 1.0, -100.0)}
    res = SimpleNamespace(n_fit_success=e.size, n_fit_failure=0)
    dt = chip_smoke.single_pulse_dt(cfg, cal, wf, truth, corr)
    assert dt.size == e.size and dt.max() < 1e-9
    chip_smoke.fit_quality("exact", res, dt)
    wf["wftime_flat"] = t_ns + 0.5 * cfg.dt
    with pytest.raises(AssertionError, match="single-pulse"):
        chip_smoke.fit_quality("shifted", res, chip_smoke.single_pulse_dt(
            cfg, cal, wf, truth, corr))


@pytest.mark.parametrize("occupancy", [1.0, 0.03], ids=["dense", "sparse"])
def test_xla_ops_match_golden_on_full_event(cfg, cal, occupancy):
    """All 1080 blocks of one event, fp64: the matched filter bit-equal,
    the search's pulse list and the 3x3 gate exactly as the oracle."""
    truth = make_events(cfg, cal, 1, occupancy=occupancy, max_pulses=2,
                        pileup_prob=0.25, seed=5)
    sig = truth.signal[0]
    mins = sig.min(axis=1)
    present = truth.pres[0].astype(bool)
    mf = np.asarray(matched_filter(
        cfg, jnp.asarray(sig[:, None]), jnp.asarray(mins[:, None]),
        jnp.asarray(cal.mfkern_rev[:, None]), jnp.asarray(cal.mfint[:, None])
    ))[:, 0]
    ps = find_pulses(cfg, jnp.asarray(sig), jnp.asarray(mins),
                     jnp.asarray(cal.mfkern_rev), jnp.asarray(cal.mfint),
                     jnp.asarray(present))
    gate = np.asarray(cluster_gate(cfg, jnp.asarray(sig)[None],
                                   jnp.asarray(cal.timeref),
                                   cal.timerefacc))[0]
    npulse, times = np.asarray(ps.npulse), np.asarray(ps.times)
    amps = np.asarray(ps.amps)
    for b in range(cfg.nblocks):
        np.testing.assert_array_equal(mf[b], matched_filter_golden(
            cfg, sig[b], mins[b], cal.mfkern_rev[b], cal.mfint[b]))
        gn, gt, ga = find_pulses_golden(cfg, sig[b], mins[b],
                                        cal.mfkern_rev[b], cal.mfint[b], True)
        assert npulse[b] == gn, b
        np.testing.assert_array_equal(times[b, :gn], gt)
        np.testing.assert_allclose(amps[b, :gn], ga, rtol=1e-12)
        assert bool(gate[b]) == cluster_gate_golden(
            cfg, sig, truth.pres[0], b, cal.timeref[b], cal.timerefacc), b
    assert npulse.sum() >= 0.5 * truth.npulse.sum()
