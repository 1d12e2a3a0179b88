"""convert_wf_to_root exercised against a stubbed uproot module.

The inverse bridge (WF .npz -> the reference consumers' ROOT file,
ref TEST_2.C:1383-1432) is tested by injecting a fake writable ``uproot``
into sys.modules — the FIDELITY stub (tests/uproot_stub.py), which enforces
real uproot's call shapes and input constraints (equal branch lengths,
jagged-input form, histogram edge structure) so an API misuse fails here
instead of on the first machine with real uproot. Covers: the 17-branch WF
tree content in (runnum, evt)-sorted order, jagged wfampl/wftime/h1time/
h2time reconstruction, the restored T tree (flat + ragged payload), restored
histograms and scalar parameters, a full pipeline round trip
(npz -> root-stub -> column equality), a committed schema snapshot pinning
the output contract, and (auto-skipped here) a REAL-uproot round trip that
runs with zero new code on any machine where uproot is installed.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

from npswf.io.writer import WFWriter, read_wf
from tests.uproot_stub import install_stub

HAVE_REAL_UPROOT = importlib.util.find_spec("uproot") is not None


@pytest.fixture()
def stub_uproot(monkeypatch):
    return install_stub(monkeypatch)


def _make_wf_file(tmp_path, small_cfg, small_cal, payload=None):
    """Run the real pipeline on a few synthetic events and write a WF file."""
    import jax.numpy as jnp
    from npswf.engine.pipeline import EventBatch, process_batch
    from npswf.io.decode import DecodedBatch
    from npswf.utils.synthetic import make_events
    cfg = small_cfg
    E, B = 5, cfg.nblocks
    truth = make_events(cfg, small_cal, E, occupancy=0.3, seed=31)
    batch = EventBatch(signal=jnp.asarray(truth.signal),
                       pres=jnp.asarray(truth.pres.astype(bool)),
                       corr_time_HMS=jnp.asarray(np.linspace(-1, 1, E)),
                       evt=jnp.asarray(np.asarray([5, 3, 4, 1, 2])),
                       runnum=jnp.full(E, 3000))
    calib = {k: jnp.asarray(v) for k, v in
             small_cal.device_arrays(cfg).items()}
    out = process_batch(cfg, calib, batch)
    zeros = np.zeros((E, B))
    pres_slots = np.zeros((E, cfg.nslots), np.int32)
    pres_slots[:, :B] = truth.pres
    decoded = DecodedBatch(
        signal=truth.signal, pres=pres_slots,
        minsignal=truth.signal.min(axis=2),
        corr_time_HMS=np.asarray(batch.corr_time_HMS),
        sampampl=zeros, samptime=zeros, sampener=zeros, sampped=zeros,
        hcana_npulse=zeros,
        evt=np.asarray([5, 3, 4, 1, 2], np.int64),
        runnum=np.full(E, 3000, np.int64),
        bad_slot=np.full(E, -1, np.int64))
    w = WFWriter(cfg, payload=dict(payload or {}))
    w.add_batch(out, decoded)
    path = str(tmp_path / "wf.npz")
    w.finalize(path)
    return path, out, decoded


def test_wf_tree_round_trip_sorted(stub_uproot, tmp_path, small_cfg, small_cal):
    from npswf.tools.convert_wf_to_root import convert, REFERENCE_BRANCHES
    path, out, decoded = _make_wf_file(tmp_path, small_cfg, small_cal)
    root_path = str(tmp_path / "out.root")
    n = convert(path, root_path)
    assert n == 5
    written = stub_uproot[root_path].written
    wf_tree = written["WF"]
    for b in REFERENCE_BRANCHES:
        assert b in wf_tree, f"missing reference branch {b}"
    # rows come out (runnum, evt)-sorted: evt must read 1..5
    np.testing.assert_array_equal(wf_tree["evt"], [1.0, 2.0, 3.0, 4.0, 5.0])
    assert wf_tree["evt"].dtype == np.float64
    # per-block vector branches permuted consistently: row of evt=5 is the
    # writer's row 0
    wf = read_wf(path)
    order = wf["sort_order"]
    np.testing.assert_allclose(np.asarray(wf_tree["chi2"]),
                               wf["chi2"][order], atol=0)
    np.testing.assert_array_equal(np.asarray(wf_tree["wfnpulse"]),
                                  wf["wfnpulse"][order])
    # jagged wfampl/wftime: per-row lengths equal the row's total pulse count
    for i, row in enumerate(order):
        lo, hi = wf["wf_offsets"][row], wf["wf_offsets"][row + 1]
        np.testing.assert_allclose(wf_tree["wfampl"][i],
                                   wf["wfampl_flat"][lo:hi], atol=0)
        np.testing.assert_allclose(wf_tree["wftime"][i],
                                   wf["wftime_flat"][lo:hi], atol=0)
        assert len(wf_tree["wfampl"][i]) == int(wf["wfnpulse"][row].sum())
    # histograms restored with the booked binning (ref :533-534)
    h1 = written["h1time"]
    assert h1[0].shape[0] == 200 and h1[1][0] == -50.0 and h1[1][-1] == 50.0


def test_payload_restoration(stub_uproot, tmp_path, small_cfg, small_cal):
    from npswf.tools.convert_wf_to_root import convert
    flat = np.arange(5.0)
    ragged = np.asarray([0.0, 1.0, 2.0, 3.0, 4.0, 5.0])
    offsets = np.asarray([0, 2, 3, 3, 5, 6], np.int64)
    payload = {
        "T.g.trigtype": flat,
        "T.NPS.cal.fly.block_clusterID": ragged,
        "T.NPS.cal.fly.block_clusterID__offsets": offsets,
        "obj.hZClus__values": np.arange(4.0),
        "obj.hZClus__edges": np.linspace(0, 1, 5),
        "obj.runParam": np.asarray([3.14]),
        "__unrepresentable": np.asarray(["canvas1"]),
    }
    path, *_ = _make_wf_file(tmp_path, small_cfg, small_cal, payload=payload)
    root_path = str(tmp_path / "out2.root")
    convert(path, root_path)
    written = stub_uproot[root_path].written
    # T tree in ORIGINAL (unsorted) order — it is a clone of the input
    t = written["T"]
    np.testing.assert_allclose(t["g.trigtype"], flat, atol=0)
    assert [len(x) for x in t["NPS.cal.fly.block_clusterID"]] == [2, 1, 0, 2, 1]
    np.testing.assert_allclose(np.concatenate(
        list(t["NPS.cal.fly.block_clusterID"])), ragged, atol=0)
    # histogram object restored as a (values, edges) tuple
    hv, he = written["hZClus"]
    np.testing.assert_allclose(hv, np.arange(4.0))
    np.testing.assert_allclose(he, np.linspace(0, 1, 5))
    # scalar parameter restored through the params tree
    np.testing.assert_allclose(written["params"]["runParam"], [3.14])


def test_empty_wf_file_converts(stub_uproot, tmp_path):
    from npswf.io.writer import write_empty_wf
    from npswf.tools.convert_wf_to_root import convert, REFERENCE_BRANCHES
    path = str(tmp_path / "empty.npz")
    write_empty_wf(path)
    root_path = str(tmp_path / "empty.root")
    assert convert(path, root_path) == 0
    wf_tree = stub_uproot[root_path].written["WF"]
    for b in REFERENCE_BRANCHES:
        assert b in wf_tree
        assert len(wf_tree[b]) == 0


# ----------------------------------------------------------------------
# Output-contract schema snapshot
# ----------------------------------------------------------------------
_SNAPSHOT = os.path.join(os.path.dirname(__file__), "data",
                         "wf_root_schema.json")


def _derive_schema(written, jagged):
    """Canonical structural description of the converted ROOT output.

    dtype KINDS (f/i/b/u) rather than widths so the snapshot is invariant
    to the test suite's x64 mode vs production fp32; jaggedness, branch
    inventory, histogram binning, and key order are pinned exactly.
    """
    schema = {}
    for key in sorted(written):
        v = written[key]
        if isinstance(v, dict):  # a tree
            branches = {}
            for name in sorted(v):
                b = v[name]
                if jagged.get(key, {}).get(name):
                    kind = (np.asarray(b[0]).dtype.kind if len(b) else "f")
                    branches[name] = {"jagged": True, "kind": kind}
                else:
                    arr = np.asarray(b)
                    branches[name] = {
                        "jagged": False, "kind": arr.dtype.kind,
                        "leaf_shape": list(arr.shape[1:])}
            schema[key] = {"type": "tree", "branches": branches}
        elif isinstance(v, tuple):  # a histogram
            values = np.asarray(v[0])
            schema[key] = {
                "type": "histogram",
                "bins": list(values.shape),
                "edges": [[float(np.asarray(e)[0]), float(np.asarray(e)[-1])]
                          for e in v[1:]]}
    return schema


def test_root_output_schema_snapshot(stub_uproot, tmp_path, small_cfg,
                                     small_cal):
    """The converted ROOT output's structure is pinned by a committed
    snapshot: branch inventory, jaggedness, dtype kinds, leaf shapes, and
    histogram binning (the contract downstream ROOT consumers read,
    ref TEST_2.C:1383-1432, README.md:100-122). Any drift fails here.

    Regenerate after an INTENTIONAL contract change:
        NPSWF_UPDATE_SNAPSHOTS=1 python -m pytest \
            tests/test_convert_wf_root.py -k snapshot
    """
    from npswf.tools.convert_wf_to_root import convert
    path, *_ = _make_wf_file(tmp_path, small_cfg, small_cal)
    root_path = str(tmp_path / "schema.root")
    convert(path, root_path)
    f = stub_uproot[root_path]
    schema = _derive_schema(f.written, f.jagged)
    if os.environ.get("NPSWF_UPDATE_SNAPSHOTS"):
        with open(_SNAPSHOT, "w") as fh:
            json.dump(schema, fh, indent=1, sort_keys=True)
    with open(_SNAPSHOT) as fh:
        expected = json.load(fh)
    assert schema == expected, (
        "ROOT output schema drifted from the committed snapshot "
        f"({_SNAPSHOT}); if intentional, regenerate with "
        "NPSWF_UPDATE_SNAPSHOTS=1")


@pytest.mark.skipif(not HAVE_REAL_UPROOT,
                    reason="uproot not installed (zero-egress environment); "
                           "runs automatically wherever uproot exists — "
                           "RUNBOOK.md validation step")
def test_real_uproot_round_trip(tmp_path, small_cfg, small_cal):
    """With REAL uproot: write the ROOT file, read it back, compare columns.

    This is the zero-new-code external validation path: the first machine
    with uproot installed runs the true bridge round trip just by running
    the suite."""
    import uproot

    from npswf.tools.convert_wf_to_root import convert
    path, *_ = _make_wf_file(tmp_path, small_cfg, small_cal)
    root_path = str(tmp_path / "real.root")
    n = convert(path, root_path)
    wf = read_wf(path)
    order = np.asarray(wf["sort_order"], np.int64)
    with uproot.open(root_path) as f:
        tree = f["WF"]
        assert tree.num_entries == n
        np.testing.assert_allclose(tree["evt"].array(library="np"),
                                   np.asarray(wf["evt"], np.float64)[order])
        np.testing.assert_allclose(tree["chi2"].array(library="np"),
                                   wf["chi2"][order])
        ampl = tree["wfampl"].array(library="np")
        for i, row in enumerate(order):
            lo, hi = wf["wf_offsets"][row], wf["wf_offsets"][row + 1]
            np.testing.assert_allclose(np.asarray(ampl[i]),
                                       wf["wfampl_flat"][lo:hi])
