"""Streaming part merge: equivalence with the in-memory WFWriter path.

The executor's finalize uses io.merge.merge_parts (bounded memory, the
row-streamed CloneTree analogue of ref TEST_2.C:1396-1432); these tests pin
it to the in-memory WFWriter.ingest_part reference implementation.
"""
import numpy as np
import jax.numpy as jnp

from npswf.engine.pipeline import make_pipeline
from npswf.io.decode import decode_segment
from npswf.io.merge import merge_parts
from npswf.io.rawstream import build_segment, encode_event_stream
from npswf.io.writer import WFWriter, read_wf
from npswf.runtime.executor import _pad_decoded, _to_event_batch
from npswf.utils.synthetic import make_events


def _make_parts(cfg, cal, tmp_path, n_events=10, batch=4, seed=11):
    truth = make_events(cfg, cal, n_events, occupancy=0.4, max_pulses=2,
                        seed=seed)
    streams = [encode_event_stream(cfg, truth.signal[e],
                                   truth.pres[e].astype(bool))
               for e in range(n_events)]
    hits = [{k: np.zeros(0) for k in
             ("adc_counter", "pulse_time", "pulse_time_raw",
              "pulse_amp", "pulse_int", "pulse_ped")}] * n_events
    seg = build_segment(cfg, streams, hits,
                        evt=np.arange(1.0, n_events + 1.0),
                        runnum=np.full(n_events, 3000.0))
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}
    pipeline = make_pipeline(cfg, calib)
    dtype = np.dtype(cfg.compute_dtype)
    paths = []
    for lo in range(0, n_events, batch):
        hi = min(lo + batch, n_events)
        d = decode_segment(cfg, cal, seg, lo, hi)
        d_pad = _pad_decoded(cfg, d, batch)
        out = pipeline(_to_event_batch(cfg, d_pad, dtype))
        w = WFWriter(cfg)
        w.add_batch(out, d_pad, n_valid=hi - lo)
        p = str(tmp_path / f"part_{lo:04d}.npz")
        w.finalize(p)
        paths.append(p)
    return paths


def test_streaming_merge_matches_in_memory(small_cfg, small_cal, tmp_path):
    paths = _make_parts(small_cfg, small_cal, tmp_path)
    payload = {"meta": np.array([1.5, 2.5]),
               "branch_x": np.arange(7, dtype=np.int32)}

    mem = WFWriter(small_cfg, payload=dict(payload))
    for p in paths:
        part = np.load(p)
        mem.ingest_part({k: part[k] for k in part.files})
    mem_path = str(tmp_path / "mem.npz")
    mem_cols = mem.finalize(mem_path)

    stream_path = str(tmp_path / "stream.npz")
    res = merge_parts(paths, stream_path, payload=dict(payload))
    got = read_wf(stream_path)

    assert set(got) == set(read_wf(mem_path))
    for k, v in read_wf(mem_path).items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert res.n_events == mem_cols["evt"].shape[0]
    assert res.n_fit_success == mem.n_fit_success
    assert res.n_fit_failure == mem.n_fit_failure
    assert res.n_fit_dropped == mem.n_fit_dropped


def test_merge_single_part_and_empty_payload(small_cfg, small_cal, tmp_path):
    paths = _make_parts(small_cfg, small_cal, tmp_path, n_events=3, batch=4,
                        seed=5)
    out = str(tmp_path / "one.npz")
    res = merge_parts(paths, out)
    wf = read_wf(out)
    assert wf["evt"].shape[0] == 3
    assert wf["wf_offsets"].shape[0] == 4
    assert wf["wf_offsets"][-1] == wf["wfnpulse"].sum()
    assert res.n_events == 3
    # sorted index is a valid permutation
    assert sorted(wf["sort_order"].tolist()) == [0, 1, 2]
