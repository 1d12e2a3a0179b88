"""convert_root exercised against a stubbed uproot module.

uproot is not installed in this environment, so the ROOT-file bridge
(the only real-data ingestion path, ref TEST_2.C:288-338) is tested by
injecting a fake ``uproot`` into sys.modules that exposes exactly the API
surface convert_root uses. Covers: ragged conversion + offsets, the
FastCloneAndFilter payload contract (all of T minus the waveform branch,
ref TEST_2.C:88-122), non-T object capture, --entry-stop, and the
payload round-trip into the final WF output file.
"""
import sys
import types

import numpy as np
import pytest

from npswf.io.rawstream import read_segment


def _obj_array(list_of_arrays):
    out = np.empty(len(list_of_arrays), object)
    for i, a in enumerate(list_of_arrays):
        out[i] = np.asarray(a, np.float64)
    return out


class FakeBranch:
    def __init__(self, data):
        self._data = data

    def array(self, entry_stop=None, library="np"):
        assert library == "np"
        return self._data[:entry_stop] if entry_stop is not None else self._data


class FakeTree:
    def __init__(self, branches):
        self._branches = branches

    def keys(self):
        return list(self._branches)

    def __getitem__(self, name):
        return FakeBranch(self._branches[name])

    def arrays(self, names, entry_stop=None, library="np"):
        assert library == "np"
        return {n: FakeBranch(self._branches[n]).array(entry_stop=entry_stop)
                for n in names}


class FakeHist:
    def __init__(self, values, edges):
        self._v, self._e = values, edges

    def to_numpy(self):
        return (self._v, self._e)


class FakeParam:
    def __init__(self, value):
        self.value = value


class FakeOpaque:
    """An object with no numpy representation (e.g. a TCanvas)."""


class FakeFile:
    def __init__(self, objects):
        self._objects = objects

    def keys(self, cycle=False):
        return list(self._objects)

    def __getitem__(self, key):
        return self._objects[key]

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.fixture()
def fake_root(monkeypatch, tmp_path):
    """Install a stub uproot and return (input_path, truth dict)."""
    rng = np.random.default_rng(7)
    E = 4
    streams = [np.concatenate([[float(b), 3.0], rng.uniform(0, 50, 3)])
               for b in range(E)]
    counts = rng.integers(1, 4, E)
    hits = {k: _obj_array([rng.uniform(0, 100, c) for c in counts])
            for k in ("NPS.cal.fly.adcCounter", "NPS.cal.fly.adcSampPulseAmp",
                      "NPS.cal.fly.adcSampPulseInt", "NPS.cal.fly.adcSampPed",
                      "NPS.cal.fly.adcSampPulseTime",
                      "NPS.cal.fly.adcSampPulseTimeRaw")}
    branches = {
        "NPS.cal.fly.adcSampWaveform": _obj_array(streams),
        "Ndata.NPS.cal.fly.adcSampWaveform":
            np.asarray([len(s) for s in streams], np.float64),
        "Ndata.NPS.cal.fly.adcCounter": counts.astype(np.float64),
        "g.evnum": np.arange(1.0, E + 1.0),
        "g.runnum": np.full(E, 3000.0),
        # extra enabled-tree content FastCloneAndFilter must preserve:
        "g.trigtype": rng.integers(0, 8, E).astype(np.float64),  # flat
        "NPS.cal.fly.block_clusterID":
            _obj_array([rng.integers(0, 5, c) for c in counts]),  # ragged
        "T.some.string.branch": np.asarray(["a", "b", "c", "d"]),  # non-numeric
        **hits,
    }
    objects = {
        "T": FakeTree(branches),
        "hZClus": FakeHist(np.arange(5.0), np.linspace(0, 1, 6)),
        "runParam": FakeParam(3.14),
        "canvas1": FakeOpaque(),
    }
    stub = types.ModuleType("uproot")
    stub.open = lambda path: FakeFile(objects)
    monkeypatch.setitem(sys.modules, "uproot", stub)
    input_path = tmp_path / "fake.root"
    input_path.write_bytes(b"not really root")
    return str(input_path), dict(branches=branches, streams=streams,
                                 counts=counts, E=E)


def test_convert_primary_fields(fake_root, tmp_path):
    from npswf.tools.convert_root import convert
    input_path, truth = fake_root
    out = str(tmp_path / "seg.npz")
    n = convert(input_path, out)
    assert n == truth["E"]
    seg = read_segment(out)
    np.testing.assert_allclose(seg.stream,
                               np.concatenate(truth["streams"]), atol=0)
    np.testing.assert_array_equal(
        np.diff(seg.stream_offsets), [len(s) for s in truth["streams"]])
    np.testing.assert_array_equal(np.diff(seg.hit_offsets), truth["counts"])
    np.testing.assert_allclose(
        seg.pulse_amp,
        np.concatenate(list(truth["branches"]["NPS.cal.fly.adcSampPulseAmp"])),
        atol=0)
    np.testing.assert_allclose(seg.evt, np.arange(1.0, truth["E"] + 1.0))


def test_convert_payload_carries_all_of_T_minus_waveform(fake_root, tmp_path):
    """The FastCloneAndFilter contract (ref TEST_2.C:88-122): every T branch
    except NPS.cal.fly.adcSampWaveform reaches the payload."""
    from npswf.tools.convert_root import convert, WAVEFORM_BRANCH
    input_path, truth = fake_root
    out = str(tmp_path / "seg.npz")
    convert(input_path, out)
    seg = read_segment(out)
    numeric = {n for n, v in truth["branches"].items()
               if np.asarray(v).dtype == object
               or np.issubdtype(np.asarray(v).dtype, np.number)}
    for name in numeric - {WAVEFORM_BRANCH}:
        assert f"T.{name}" in seg.payload, f"payload missing T.{name}"
    assert f"T.{WAVEFORM_BRANCH}" not in seg.payload
    # ragged branch round-trips with offsets
    cid = truth["branches"]["NPS.cal.fly.block_clusterID"]
    np.testing.assert_allclose(seg.payload["T.NPS.cal.fly.block_clusterID"],
                               np.concatenate(list(cid)), atol=0)
    np.testing.assert_array_equal(
        np.diff(seg.payload["T.NPS.cal.fly.block_clusterID__offsets"]),
        truth["counts"])
    # flat branch round-trips
    np.testing.assert_allclose(seg.payload["T.g.trigtype"],
                               truth["branches"]["g.trigtype"], atol=0)
    # non-T objects captured
    np.testing.assert_allclose(seg.payload["obj.hZClus__values"],
                               np.arange(5.0))
    np.testing.assert_allclose(seg.payload["obj.hZClus__edges"],
                               np.linspace(0, 1, 6))
    np.testing.assert_allclose(seg.payload["obj.runParam"], [3.14])
    # unrepresentables are declared, not silently dropped
    unrep = list(seg.payload["__unrepresentable"])
    assert "canvas1" in unrep
    assert "T.T.some.string.branch" in unrep


def test_convert_entry_stop(fake_root, tmp_path):
    from npswf.tools.convert_root import convert
    input_path, truth = fake_root
    out = str(tmp_path / "seg2.npz")
    n = convert(input_path, out, entry_stop=2)
    assert n == 2
    seg = read_segment(out)
    assert seg.n_events == 2
    assert seg.payload["T.g.trigtype"].shape[0] == 2
    assert np.diff(seg.payload["T.NPS.cal.fly.block_clusterID__offsets"]).shape[0] == 2


def test_convert_missing_input_path(fake_root):
    from npswf.tools.convert_root import convert
    with pytest.raises(SystemExit, match="Cannot open file"):
        convert("/nonexistent/file.root", "/tmp/never.npz")


_HAVE_REAL_UPROOT_AWKWARD = all(
    __import__("importlib.util", fromlist=["util"]).find_spec(m) is not None
    for m in ("uproot", "awkward"))


@pytest.mark.skipif(not _HAVE_REAL_UPROOT_AWKWARD,
                    reason="uproot/awkward not installed (zero-egress "
                           "environment); runs automatically wherever they "
                           "exist — RUNBOOK.md validation step")
def test_real_uproot_raw_round_trip(tmp_path):
    """With REAL uproot: write a raw-shaped T tree, read it via convert_root.

    Zero-new-code external validation of the ingestion bridge: real uproot
    writes the 9 analysis branches (jagged via awkward) and convert_root
    must pull them through byte-identically."""
    import awkward as ak
    import uproot

    from npswf.tools.convert_root import convert

    rng = np.random.default_rng(11)
    E = 4
    streams = [np.concatenate([[float(b), 3.0], rng.uniform(0, 50, 3)])
               for b in range(E)]
    counts = rng.integers(1, 4, E)
    hits = {k: ak.Array([rng.uniform(0, 100, c).tolist() for c in counts])
            for k in ("NPS.cal.fly.adcCounter", "NPS.cal.fly.adcSampPulseAmp",
                      "NPS.cal.fly.adcSampPulseInt", "NPS.cal.fly.adcSampPed",
                      "NPS.cal.fly.adcSampPulseTime",
                      "NPS.cal.fly.adcSampPulseTimeRaw")}
    path = str(tmp_path / "real_raw.root")
    with uproot.recreate(path) as f:
        f["T"] = {
            "NPS.cal.fly.adcSampWaveform": ak.Array(
                [s.tolist() for s in streams]),
            "Ndata.NPS.cal.fly.adcSampWaveform": np.asarray(
                [len(s) for s in streams], np.float64),
            "Ndata.NPS.cal.fly.adcCounter": counts.astype(np.float64),
            "g.evnum": np.arange(1.0, E + 1.0),
            "g.runnum": np.full(E, 3000.0),
            **hits,
        }
    out = str(tmp_path / "real_seg.npz")
    assert convert(path, out) == E
    seg = read_segment(out)
    np.testing.assert_allclose(seg.stream, np.concatenate(streams), atol=0)
    np.testing.assert_array_equal(np.diff(seg.hit_offsets), counts)
    np.testing.assert_allclose(seg.evt, np.arange(1.0, E + 1.0))


def test_payload_round_trips_into_wf_output(fake_root, tmp_path, small_cfg,
                                            small_cal):
    """converted -> processed: the WF output preserves every payload column
    (the reference's output file keeps the whole filtered input,
    README.md:101-102)."""
    from npswf.tools.convert_root import convert
    from npswf.runtime.executor import run_segment
    from npswf.io.writer import read_wf
    input_path, truth = fake_root
    seg_path = str(tmp_path / "seg3.npz")
    convert(input_path, seg_path)
    seg = read_segment(seg_path)
    out = str(tmp_path / "wf.npz")
    run_segment(small_cfg, small_cal, seg, out, batch_size=4, resume=False)
    wf = read_wf(out)
    for k in seg.payload:
        assert f"payload_{k}" in wf, f"WF output dropped payload column {k}"
    np.testing.assert_allclose(wf["payload_T.g.trigtype"],
                               truth["branches"]["g.trigtype"], atol=0)
