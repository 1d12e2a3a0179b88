"""IO layer: stream encode/decode (native C++ vs oracle), writer, validator."""
import os

import numpy as np
import pytest

from npswf.golden.reference import decode_event_golden
from npswf.io import native
from npswf.io.decode import decode_segment
from npswf.io.rawstream import (build_segment, encode_event_stream,
                                read_segment, write_segment)
from npswf.io.writer import (WFWriter, flatten_pulses, flatten_pulses_np,
                             iter_events_sorted, read_wf)
from npswf.utils.synthetic import make_events


def _make_segment(cfg, cal, E=6, seed=41, sparse=False):
    truth = make_events(cfg, cal, E, occupancy=0.05, seed=seed)
    rng = np.random.default_rng(seed)
    streams, hits = [], []
    pres = truth.pres.astype(bool)
    if sparse:
        # drop a random subset of blocks from the readout entirely
        pres &= rng.random(pres.shape) < 0.7
    for e in range(E):
        scint = rng.standard_normal((2, cfg.ntime)) if e % 2 == 0 else None
        streams.append(encode_event_stream(cfg, truth.signal[e], pres[e], scint))
        nb = np.nonzero(truth.npulse[e])[0]
        hits.append({"adc_counter": nb.astype(np.float64),
                     "pulse_time": rng.uniform(100, 200, nb.size),
                     "pulse_time_raw": rng.uniform(0, 4000, nb.size),
                     "pulse_amp": rng.uniform(10, 100, nb.size),
                     "pulse_int": rng.uniform(10, 100, nb.size),
                     "pulse_ped": rng.uniform(-2, 2, nb.size)})
    seg = build_segment(cfg, streams, hits,
                        evt=np.arange(1, E + 1, dtype=np.float64),
                        runnum=np.full(E, 3000.0),
                        payload={"meta": np.array([1, 2, 3])})
    return truth, seg, pres


def test_native_library_builds():
    assert native.load() is not None, "C++ host library failed to build"


def test_decode_native_matches_golden(cfg, cal):
    truth, seg, pres = _make_segment(cfg, cal, E=4, sparse=True)
    dec = decode_segment(cfg, cal, seg, use_native=True)
    for e in range(seg.n_events):
        g_sig, g_pres, g_min, g_bad = decode_event_golden(cfg, seg.event_stream(e))
        np.testing.assert_allclose(dec.signal[e], g_sig.astype(np.float32),
                                   rtol=0, atol=0)
        np.testing.assert_array_equal(dec.pres[e], g_pres.astype(np.uint8))
        np.testing.assert_allclose(dec.minsignal[e],
                                   g_min.astype(np.float32), rtol=1e-6)
        assert dec.bad_slot[e] == -1


def test_decode_numpy_matches_native(cfg, cal):
    truth, seg, pres = _make_segment(cfg, cal, E=3)
    a = decode_segment(cfg, cal, seg, use_native=True)
    b = decode_segment(cfg, cal, seg, use_native=False)
    np.testing.assert_allclose(a.signal, b.signal, atol=0)
    np.testing.assert_array_equal(a.pres, b.pres)
    np.testing.assert_allclose(a.corr_time_HMS, b.corr_time_HMS)


def test_decode_bad_slot_aborts(cfg, cal):
    stream = np.concatenate([
        [5.0, float(cfg.ntime)], np.ones(cfg.ntime),
        [3000.0, float(cfg.ntime)], np.ones(cfg.ntime),   # invalid slot
        [7.0, float(cfg.ntime)], 2 * np.ones(cfg.ntime)])  # must NOT be decoded
    seg = build_segment(cfg, [stream],
                        [{k: np.zeros(0) for k in
                          ("adc_counter", "pulse_time", "pulse_time_raw",
                           "pulse_amp", "pulse_int", "pulse_ped")}],
                        evt=np.array([1.0]), runnum=np.array([1.0]))
    dec = decode_segment(cfg, cal, seg)
    assert dec.bad_slot[0] == 3000
    assert dec.pres[0, 5] == 1
    assert dec.pres[0, 7] == 0            # decode aborted before block 7
    assert dec.signal[0, 7].sum() == 0
    g_sig, g_pres, _, g_bad = decode_event_golden(cfg, stream)
    np.testing.assert_array_equal(dec.pres[0], g_pres.astype(np.uint8))
    assert g_bad == 3000


def test_hms_matches_golden(cfg, cal):
    from npswf.golden.reference import hms_correction_golden
    truth, seg, pres = _make_segment(cfg, cal, E=4)
    dec = decode_segment(cfg, cal, seg)
    for e in range(seg.n_events):
        h = seg.event_hits(e)
        if h["adc_counter"].size == 0:
            continue
        corr, sa, st, se_, sp, npl = hms_correction_golden(
            cfg, cal.tdcoffset, cal.timemean2, h["adc_counter"],
            h["pulse_time"], h["pulse_time_raw"], h["pulse_amp"],
            h["pulse_int"], h["pulse_ped"])
        np.testing.assert_allclose(dec.corr_time_HMS[e], corr, rtol=1e-12)
        np.testing.assert_allclose(dec.sampampl[e], sa, rtol=1e-12)
        np.testing.assert_allclose(dec.samptime[e], st, rtol=1e-12)


def test_segment_roundtrip(cfg, cal, tmp_path):
    truth, seg, pres = _make_segment(cfg, cal, E=3)
    p = str(tmp_path / "seg.npz")
    write_segment(p, seg)
    seg2 = read_segment(p)
    np.testing.assert_allclose(seg2.stream, seg.stream, atol=0)
    np.testing.assert_array_equal(seg2.stream_offsets, seg.stream_offsets)
    np.testing.assert_array_equal(seg2.payload["meta"], seg.payload["meta"])
    sub = seg2.slice(1, 3)
    np.testing.assert_allclose(sub.event_stream(0), seg.event_stream(1), atol=0)


def test_flatten_native_matches_numpy(cfg):
    rng = np.random.default_rng(5)
    E, B, P = 3, cfg.nblocks, cfg.maxwfpulses
    npulse = rng.integers(0, 4, (E, B)).astype(np.int32)
    times = rng.standard_normal((E, B, P))
    amps = rng.standard_normal((E, B, P))
    t1, a1, o1 = flatten_pulses(npulse, times, amps)
    t2, a2, o2 = flatten_pulses_np(npulse, times, amps)
    np.testing.assert_allclose(t1, t2, atol=0)
    np.testing.assert_allclose(a1, a2, atol=0)
    np.testing.assert_array_equal(o1, o2)
