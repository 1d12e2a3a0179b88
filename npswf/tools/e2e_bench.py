"""End-to-end (host-I/O-inclusive) benchmark of ``run_segment``.

``bench.py`` times the device pipeline only; the
reference's self-timing covers its WHOLE job including I/O (ref
TEST_2.C:283-284, 1388-1393, 1424-1428). This tool times the framework's
full production path on a multi-thousand-event synthetic segment:

    native C++ decode -> jit pipeline (async, double-buffered) ->
    uncompressed part files -> streaming ordered merge

and reports end-to-end blocks/s next to a device-only measurement taken in
the same process, plus the executor's per-stage wall breakdown. The input
segment is held in memory (the reference reads a page-cached ROOT file; the
decode stage is the comparable work).

Usage:  python -m npswf.tools.e2e_bench [--events 5120] [--mode both]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Tuple

import numpy as np

from npswf.core.config import NPSConfig
from npswf.core.calibration import CalibrationBundle, synthetic_calibration
from npswf.io.rawstream import RawSegment, build_segment, encode_event_stream
from npswf.utils.synthetic import make_events


def build_tiled_segment(cfg: NPSConfig, cal: CalibrationBundle,
                        n_events: int, occupancy: float,
                        sparse_readout: bool, base_events: int = 64,
                        seed: int = 7) -> Tuple[RawSegment, np.ndarray]:
    """A ``n_events`` segment tiled from ``base_events`` synthetic events.

    Tiling keeps host-side generation tractable (the per-event decode work
    is identical for repeated waveforms); event numbers stay unique.
    Returns (segment, base_pres) for sanity checks.
    """
    truth = make_events(cfg, cal, base_events, occupancy=occupancy,
                        max_pulses=2, pileup_prob=0.25, seed=seed)
    # real FADC streams carry integral ADC counts stored as doubles (ref
    # TEST_2.C:854-889); quantize the synthetic waveforms the same way so
    # the bench exercises the production uplink (lossless int16 route)
    truth.signal = np.rint(truth.signal)
    pres = (truth.npulse > 0) if sparse_readout else np.ones_like(
        truth.npulse, dtype=bool)
    rng = np.random.default_rng(seed + 1)
    streams, hits = [], []
    for e in range(base_events):
        streams.append(encode_event_stream(cfg, truth.signal[e],
                                           pres[e].astype(bool)))
        nb = np.nonzero(truth.npulse[e])[0]
        hits.append({
            "adc_counter": nb.astype(np.float64),
            "pulse_time": truth.times[e, nb, 0] * cfg.dt
            + rng.standard_normal(nb.size) * 0.1,
            "pulse_time_raw": rng.uniform(0, 4000, nb.size),
            "pulse_amp": truth.amps[e, nb, 0],
            "pulse_int": truth.amps[e, nb, 0] * 7.5,
            "pulse_ped": truth.pedestal[e, nb]})
    ntiles = (n_events + base_events - 1) // base_events
    streams = (streams * ntiles)[:n_events]
    hits = (hits * ntiles)[:n_events]
    seg = build_segment(
        cfg, streams, hits,
        evt=np.arange(n_events, dtype=np.float64),
        runnum=np.full(n_events, 3000, np.float64))
    return seg, pres


def measure_device_only(cfg: NPSConfig, cal: CalibrationBundle,
                        seg: RawSegment, batch_size: int) -> float:
    """Pipelined device-only ms/batch on this segment's first batch (the
    same two-in-flight regime bench.py reports)."""
    import jax
    import jax.numpy as jnp
    from npswf.engine.pipeline import make_pipeline
    from npswf.io.decode import decode_segment
    from npswf.runtime.executor import _pad_decoded, _to_event_batch

    d = _pad_decoded(cfg, decode_segment(cfg, cal, seg, 0, batch_size),
                     batch_size)
    batch = _to_event_batch(cfg, d, np.dtype(cfg.compute_dtype))
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}
    pipeline = make_pipeline(cfg, calib)
    _ = np.asarray(pipeline(batch).chi2)   # compile + warm
    _ = np.asarray(pipeline(batch).chi2)
    iters = 8
    t0 = time.perf_counter()
    prev = None
    for _ in range(iters):
        out = pipeline(batch)
        if prev is not None:
            _ = np.asarray(prev.chi2)
        prev = out
    _ = np.asarray(prev.chi2)
    return (time.perf_counter() - t0) / iters


def run_mode(cfg: NPSConfig, cal: CalibrationBundle, n_events: int,
             batch_size: int, mode: str, workdir: str,
             compress: bool = False, chain_batches: int = 4) -> dict:
    from npswf.runtime.executor import run_segment
    from npswf.utils.timers import StageTimer

    sparse = mode == "sparse"
    if sparse:
        cfg = cfg.replace(
            search_capacity=max(1024, batch_size * cfg.nblocks // 8))
    print(f"[{mode}] building {n_events}-event segment...", file=sys.stderr)
    seg, _ = build_tiled_segment(cfg, cal, n_events,
                                 occupancy=0.05 if sparse else 1.0,
                                 sparse_readout=sparse)
    stream_gb = seg.stream.nbytes / 1e9
    print(f"[{mode}] segment stream: {stream_gb:.2f} GB", file=sys.stderr)

    dt_dev = measure_device_only(cfg, cal, seg, batch_size)
    dev_bps = batch_size * cfg.nblocks / dt_dev
    print(f"[{mode}] device-only (pipelined): {dt_dev * 1e3:.1f} ms/batch "
          f"= {dev_bps:,.0f} blocks/s", file=sys.stderr)

    out_path = os.path.join(workdir, f"wf_{mode}.npz")
    timers = StageTimer()
    t0 = time.perf_counter()
    res = run_segment(cfg, cal, seg, out_path, batch_size=batch_size,
                      resume=False, timers=timers, progress_every=10 ** 9,
                      compress_output=compress, chain_batches=chain_batches)
    wall = time.perf_counter() - t0
    e2e_bps = n_events * cfg.nblocks / wall
    frac = e2e_bps / dev_bps
    # steady-state figure: the MEDIAN inter-batch completion gap, which a
    # rare slow batch (first-call compile, host hiccup) cannot move
    med_gap = timers.median("interbatch")
    med_bps = (batch_size * cfg.nblocks / med_gap) if med_gap > 0 else 0.0
    med_frac = med_bps / dev_bps
    print(f"[{mode}] end-to-end: {wall:.1f}s for {n_events} events = "
          f"{res.events_per_sec:,.1f} ev/s, {e2e_bps:,.0f} blocks/s "
          f"({frac:.0%} of device-only); steady-state (median batch "
          f"period {med_gap * 1e3:.0f} ms): {med_bps:,.0f} blocks/s "
          f"({med_frac:.0%} of device-only)", file=sys.stderr)
    print(f"[{mode}] stage breakdown (threaded stages overlap): "
          f"{timers.report()}", file=sys.stderr)
    size_mb = os.path.getsize(out_path) / 1e6
    print(f"[{mode}] output: {size_mb:.1f} MB, fits ok={res.n_fit_success} "
          f"fail={res.n_fit_failure}", file=sys.stderr)
    return {"mode": mode, "events": n_events,
            "e2e_blocks_per_sec": round(e2e_bps, 1),
            "e2e_steady_blocks_per_sec": round(med_bps, 1),
            "device_blocks_per_sec": round(dev_bps, 1),
            "e2e_frac_of_device": round(frac, 3),
            "e2e_steady_frac_of_device": round(med_frac, 3),
            "wall_s": round(wall, 2),
            "stages": {k: round(v, 2) for k, v in timers.totals.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=5120)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--mode", choices=["dense", "sparse", "both"],
                    default="both")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--chain-batches", type=int, default=4,
                    help="batches per device dispatch (executor chaining)")
    ap.add_argument("--compress", action="store_true",
                    help="DEFLATE the final merged file (the default is "
                    "ZIP_STORED: single-core DEFLATE of the multi-hundred-MB "
                    "output would dominate the job; both are valid .npz)")
    args = ap.parse_args(argv)

    import jax
    print(f"device: {jax.devices()[0]}", file=sys.stderr)
    cfg = NPSConfig(compute_dtype="float32")
    cal = synthetic_calibration(cfg, seed=1)
    workdir = args.workdir or tempfile.mkdtemp(prefix="npswf_e2e_")
    results = []
    try:
        modes = ["dense", "sparse"] if args.mode == "both" else [args.mode]
        for m in modes:
            results.append(run_mode(cfg, cal, args.events, args.batch_size,
                                    m, workdir, compress=args.compress,
                                    chain_batches=args.chain_batches))
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
