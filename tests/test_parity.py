"""The parity harness (tools/parity.py): alignment, residuals, verdict.

Exercised on framework-produced WF files (self-comparison must PASS with
zero residuals; perturbations must FAIL or be counted), and on a stubbed
uproot for the ROOT WF loader — the harness becomes usable against a real
reference-produced file the day one is available.
"""
import sys
import types

import numpy as np
import pytest

from npswf.tools.parity import compare, load_wf, load_wf_npz


@pytest.fixture(scope="module")
def wf_file(small_cfg, small_cal, tmp_path_factory):
    from npswf.runtime.executor import run_segment
    from npswf.io.rawstream import build_segment, encode_event_stream
    from npswf.utils.synthetic import make_events
    cfg, cal = small_cfg, small_cal
    E = 6
    truth = make_events(cfg, cal, E, occupancy=0.3, max_pulses=2, seed=11)
    streams = [encode_event_stream(cfg, truth.signal[e],
                                   truth.pres[e].astype(bool))
               for e in range(E)]
    hits = [{k: np.zeros(0) for k in
             ("adc_counter", "pulse_time", "pulse_time_raw",
              "pulse_amp", "pulse_int", "pulse_ped")} for _ in range(E)]
    seg = build_segment(cfg, streams, hits,
                        evt=np.arange(1.0, E + 1.0), runnum=np.full(E, 7.0))
    out = str(tmp_path_factory.mktemp("parity") / "wf.npz")
    run_segment(cfg, cal, seg, out, batch_size=3, resume=False)
    return out


def test_self_comparison_passes(wf_file):
    ref = load_wf(wf_file)
    ours = load_wf(wf_file)
    rep = compare(ref, ours)
    assert rep["pass"]
    assert rep["events_aligned"] == 6
    assert rep["time_q95_bins"] == 0.0
    assert rep["amp_rel_q95"] == 0.0
    assert rep["npulse_mismatch"] == 0
    assert rep["fit_status_mismatch"] == 0
    assert rep["pulses_compared"] > 0


def test_time_shift_fails_the_bar(wf_file):
    ref = load_wf_npz(wf_file)
    ours = load_wf_npz(wf_file)
    ours.wftime = ours.wftime + 0.1 * 4.0   # +0.1 bins in ns
    rep = compare(ref, ours)
    assert not rep["pass"]
    assert abs(rep["time_q95_bins"] - 0.1) < 1e-9
    # a shift well under the bar still passes
    ours.wftime = ref.wftime + 0.01 * 4.0
    rep2 = compare(ref, ours)
    assert rep2["pass"] and abs(rep2["time_q50_bins"] - 0.01) < 1e-9


def test_npulse_and_status_mismatches_counted(wf_file):
    ref = load_wf_npz(wf_file)
    ours = load_wf_npz(wf_file)
    ours.wfnpulse = ours.wfnpulse.copy()
    lanes = np.argwhere(ours.wfnpulse > 0)
    e0, b0 = lanes[0]
    ours.wfnpulse[e0, b0] += 1
    ours.chi2 = ours.chi2.copy()
    e1, b1 = lanes[1]
    ours.chi2[e1, b1] = -100.0               # flip one lane to fit-failed
    rep = compare(ref, ours)
    assert rep["npulse_mismatch"] == 1
    assert rep["fit_status_mismatch"] == 1


def test_partial_event_overlap(wf_file):
    ref = load_wf_npz(wf_file)
    ours = load_wf_npz(wf_file)
    ours.evt = ours.evt.copy()
    ours.evt[0] = 999.0                       # un-align one event
    rep = compare(ref, ours)
    assert rep["events_aligned"] == 5


def test_root_wf_loader_with_stubbed_uproot(wf_file, monkeypatch, tmp_path):
    """load_wf_root reads the reference Snapshot schema (ref :1387) through
    uproot's library='np' object-array interface."""
    ours = load_wf_npz(wf_file)
    E, B = ours.wfnpulse.shape

    def rows(flat, offsets):
        return np.asarray([flat[offsets[i]:offsets[i + 1]]
                           for i in range(E)], object)

    branches = {
        "evt": ours.evt, "runnum": ours.runnum,
        "wfnpulse": np.asarray([ours.wfnpulse[i] for i in range(E)], object),
        "chi2": np.asarray([ours.chi2[i] for i in range(E)], object),
        "wftime": rows(ours.wftime, ours.offsets),
        "wfampl": rows(ours.wfampl, ours.offsets),
    }

    class FakeTree:
        def arrays(self, names, library="np"):
            assert library == "np"
            return {n: branches[n] for n in names}

    class FakeFile:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def __getitem__(self, k):
            assert k == "WF"
            return FakeTree()

    stub = types.ModuleType("uproot")
    stub.open = lambda path: FakeFile()
    monkeypatch.setitem(sys.modules, "uproot", stub)
    fake_root = str(tmp_path / "ref_wf.root")
    with open(fake_root, "wb") as f:
        f.write(b"stub")
    ref = load_wf(fake_root)                  # .root path -> uproot loader
    rep = compare(ref, ours)
    assert rep["pass"] and rep["time_q95_bins"] == 0.0
