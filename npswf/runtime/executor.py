"""Streaming segment executor.

The job-driver layer (component C1/C4/L4 of the reference, TEST_2.C:281-534,
1302-1439), rebuilt for a device-fed pipeline:

- events stream through fixed-size batches (static shapes for jit); the last
  batch is zero-padded and trimmed on output,
- host decode of batch i+1 overlaps device compute of batch i (double
  buffering via a background thread — the pipelined-prefetch answer to the
  reference's per-thread event buckets),
- each completed batch is persisted as a part file and recorded in a
  progress sidecar, giving batch-granular checkpoint/resume — the reference
  restarts from scratch on a kill (SURVEY.md section 5); here a rerun skips
  completed ranges,
- finalize merges the parts in event order, builds the (runnum, evt) index
  and writes the final WF file (the temp-Snapshot + ordered-merge pattern,
  ref TEST_2.C:1383-1432),
- per-stage wall timers and fit-health counters are reported at exit
  (ref TEST_2.C:1436-1438).
"""
from __future__ import annotations

import functools
import json
import logging
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Optional

from collections import deque

import numpy as np
import jax
import jax.numpy as jnp

from npswf.core.calibration import CalibrationBundle
from npswf.core.config import NPSConfig
from npswf.engine.pipeline import EventBatch, make_pipeline
from npswf.io.decode import DecodedBatch, decode_segment
from npswf.io.rawstream import RawSegment
from npswf.io.writer import WFWriter
from npswf.utils.timers import StageTimer

log = logging.getLogger("npswf")


@dataclass
class RunResult:
    n_events: int
    n_fit_success: int
    n_fit_failure: int
    n_fit_dropped: int
    wall_time: float
    events_per_sec: float
    blocks_per_sec: float
    out_path: str
    # runtime-guard tallies (the reference's inline warnings as counters)
    n_bad_slot: int = 0      # events aborted on an out-of-range slot (ref :867-872)
    n_oversize: int = 0      # events skipped by the Ndata guard (ref :830-836)
    n_truncated: int = 0     # events whose stream ended mid-block
    n_high_pulse: int = 0    # lanes with npulse > maxwfpulses-2 (ref :209-213)
    n_search_dropped: int = 0  # present lanes beyond cfg.search_capacity


def _pad_decoded(cfg: NPSConfig, d: DecodedBatch, target: int) -> DecodedBatch:
    n = d.signal.shape[0]
    if n == target:
        return d
    pad = target - n

    def z(a, fill=0):
        shape = (pad,) + a.shape[1:]
        return np.concatenate([a, np.full(shape, fill, a.dtype)], axis=0)

    return DecodedBatch(
        signal=z(d.signal), pres=z(d.pres), minsignal=z(d.minsignal, 1e6),
        bad_slot=z(d.bad_slot, -1), corr_time_HMS=z(d.corr_time_HMS),
        sampampl=z(d.sampampl, -100.0), samptime=z(d.samptime, -100.0),
        sampener=z(d.sampener, -100.0), sampped=z(d.sampped, -100.0),
        hcana_npulse=z(d.hcana_npulse), evt=z(d.evt, -1), runnum=z(d.runnum, -1))


def _to_event_batch(cfg: NPSConfig, d: DecodedBatch, dtype) -> EventBatch:
    B = cfg.nblocks
    return EventBatch(
        signal=jnp.asarray(d.signal.astype(dtype)),
        pres=jnp.asarray(d.pres[:, :B].astype(bool)),
        corr_time_HMS=jnp.asarray(d.corr_time_HMS.astype(dtype)),
        evt=jnp.asarray(d.evt),
        runnum=jnp.asarray(d.runnum),
        minsignal=jnp.asarray(d.minsignal.astype(dtype)))


# ---------------------------------------------------------------------
# Uplink compaction (host->device transfer volume)
# ---------------------------------------------------------------------
# The [E, B, T] signal tensor dominates the uplink; two lossless reducers:
#  - int16 when every sample is integral (real FADC streams carry raw ADC
#    counts stored as doubles, ref TEST_2.C:854-889): 2 bytes/sample, cast
#    back to the compute dtype on device;
#  - present-lane compaction when the batch is sparse (production events
#    read out only the hit region): upload [cap, T] rows + row indices and
#    scatter into dense zeros on device — exact, because the decoder
#    zero-fills absent lanes (io/native/decode.cpp:50).
# Both preserve bitwise results; dense float batches fall through to the
# plain upload.

@functools.partial(jax.jit, static_argnames=("dt",))
def _dev_cast(sig, dt):
    return sig.astype(dt)


@functools.partial(jax.jit, static_argnames=("shape", "dt"))
def _dev_scatter(sig_c, rows, shape, dt):
    E, B, T = shape
    dense = jnp.zeros((E * B, T), dt).at[rows].set(
        sig_c.astype(dt), mode="drop")
    return dense.reshape(shape)


def _pow2(n: int) -> int:
    """Next power of two (bucketing keeps jit cache variants few)."""
    return 1 << max(int(n) - 1, 1).bit_length()


def _maybe_int16(sig: np.ndarray) -> np.ndarray:
    """Lossless int16 view of an integral float array, else the original."""
    if sig.size == 0:
        return sig
    lo, hi = sig.min(), sig.max()
    if lo < -32768.0 or hi > 32767.0:
        return sig
    if not np.array_equal(sig, np.rint(sig)):
        return sig
    return sig.astype(np.int16)


def _upload_signal(cfg: NPSConfig, d: DecodedBatch, dtype) -> jnp.ndarray:
    """Device [E, B, T] signal via the cheapest lossless uplink route."""
    B, T = cfg.nblocks, cfg.ntime
    E = d.signal.shape[0]
    dt = np.dtype(dtype)
    pres = d.pres[:, :B].astype(bool)
    n_pres = int(pres.sum())
    if n_pres <= (E * B) // 2:
        rows = np.flatnonzero(pres.reshape(-1)).astype(np.int32)
        # bucket the capacity so jit variants stay few
        cap = max(1024, 1 << int(np.ceil(np.log2(max(n_pres, 1)))))
        cap = min(cap, E * B)
        sig_c = np.zeros((cap, T), d.signal.dtype)
        sig_c[:n_pres] = d.signal.reshape(E * B, T)[rows]
        rows_p = np.full(cap, E * B, np.int32)   # out-of-range -> dropped
        rows_p[:n_pres] = rows
        return _dev_scatter(jnp.asarray(_maybe_int16(sig_c)),
                            jnp.asarray(rows_p), (E, B, T), dt)
    return _dev_cast(jnp.asarray(_maybe_int16(d.signal)), dt)


@functools.partial(jax.jit, static_argnames=("B", "dt"))
def _dev_unpack_small(combo, B, dt):
    """Split the combined [E, 2B+3] f64 host array into EventBatch fields."""
    minsignal = combo[:, :B].astype(dt)
    pres = combo[:, B:2 * B] != 0.0
    corr = combo[:, 2 * B].astype(dt)
    evt = combo[:, 2 * B + 1].astype(jnp.int32)
    runnum = combo[:, 2 * B + 2].astype(jnp.int32)
    return pres, corr, evt, runnum, minsignal


def _upload_batch(cfg: NPSConfig, d: DecodedBatch, dtype) -> EventBatch:
    """Decoded batch -> device EventBatch in exactly TWO host->device
    transfers: the (compacted/int16) signal and one combined f64 array of
    every small field: each transfer pays a fixed latency, so transfer
    COUNT matters as well as bytes."""
    B = cfg.nblocks
    E = d.signal.shape[0]
    combo = np.empty((E, 2 * B + 3), np.float64)
    combo[:, :B] = d.minsignal
    combo[:, B:2 * B] = d.pres[:, :B]
    combo[:, 2 * B] = d.corr_time_HMS
    combo[:, 2 * B + 1] = d.evt
    combo[:, 2 * B + 2] = d.runnum
    pres, corr, evt, runnum, minsignal = _dev_unpack_small(
        jnp.asarray(combo), B, np.dtype(dtype))
    return EventBatch(
        signal=_upload_signal(cfg, d, dtype),
        pres=pres, corr_time_HMS=corr, evt=evt, runnum=runnum,
        minsignal=minsignal)


class _Progress:
    """Sidecar recording completed batch ranges for resume."""

    def __init__(self, path: str):
        self.path = path
        self.completed = set()
        if os.path.exists(path):
            with open(path) as f:
                self.completed = {tuple(r) for r in json.load(f)["completed"]}

    def done(self, lo: int, hi: int) -> bool:
        return (lo, hi) in self.completed

    def mark(self, lo: int, hi: int) -> None:
        self.completed.add((lo, hi))
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"completed": sorted(self.completed)}, f)
        os.replace(tmp, self.path)


def run_segment(cfg: NPSConfig, cal: CalibrationBundle, seg: RawSegment,
                out_path: str, batch_size: int = 64,
                mesh=None, resume: bool = True,
                use_native_decode: bool = True,
                timers: Optional[StageTimer] = None,
                progress_every: int = 1000,
                profile_dir: Optional[str] = None,
                compress_output: bool = True,
                chain_batches: int = 1) -> RunResult:
    """Process a full raw segment into a WF output file.

    ``profile_dir`` wraps the event loop in a JAX profiler trace
    (xprof-compatible) — the structured-tracing equivalent of the reference's
    TStopwatch instrumentation (SURVEY.md section 5).

    ``compress_output`` controls DEFLATE of the FINAL merged file only;
    transient part files are always written uncompressed (single-core
    DEFLATE of parts would throttle the device pipeline — PERF.md).

    ``chain_batches`` > 1 dispatches k batches per jit call (a lax.scan
    over a stacked EventBatch) and fetches ONE [k, total] packet stack,
    amortizing the per-dispatch and per-fetch fixed cost. Results are
    bit-identical to k separate dispatches;
    resume granularity stays per batch. Ignored on the mesh path.
    """
    timers = timers or StageTimer()
    t_start = time.perf_counter()
    dtype = np.dtype(cfg.compute_dtype)
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}

    from npswf.engine.pipeline import (flatten_packet,
                                       make_pipeline_packed,
                                       make_pipeline_packed_chain,
                                       pack_for_writer,
                                       stack_event_batches,
                                       unflatten_packet)
    E, B = batch_size, cfg.nblocks
    packed = None
    if mesh is not None:
        from npswf.parallel.mesh import (make_sharded_pipeline,
                                         shard_calibration,
                                         shard_event_batch)
        calib = shard_calibration(cfg, calib, mesh)
        base = make_sharded_pipeline(cfg, calib, mesh)

        def pipeline(b):
            return base(shard_event_batch(cfg, b, mesh))
    else:
        pipeline = make_pipeline(cfg, calib)

    E_total = seg.n_events
    parts_dir = out_path + ".parts"
    os.makedirs(parts_dir, exist_ok=True)
    progress = _Progress(out_path + ".progress.json")

    ranges = [(lo, min(lo + batch_size, E_total))
              for lo in range(0, E_total, batch_size)]
    pending = [r for r in ranges if not (resume and progress.done(*r))]
    if len(pending) < len(ranges):
        log.info("resume: skipping %d completed batches",
                 len(ranges) - len(pending))

    # ---- packet sizing from the first batch's occupancy ----------------
    # Sparse readout (production events light up 1-3% of the calorimeter)
    # shrinks BOTH packet sections: present-lane compaction of the [E, B]
    # fields and a smaller pulse flat-buffer. Sized once, from batch 0 —
    # later batches that overflow fall back to the dense fetch (logged).
    first = None
    pack_cap, lane_cap = 2 * E * B, 0
    if pending:
        lo0, hi0 = pending[0]
        with timers.stage("decode"):
            d0 = decode_segment(cfg, cal, seg, lo0, hi0,
                                use_native=use_native_decode)
            d0_pad = _pad_decoded(cfg, d0, batch_size)
        n_pres0 = int(d0_pad.pres[:, :B].astype(bool).sum())
        if mesh is None and n_pres0 <= (E * B) // 4:
            lane_cap = min(_pow2(max(1024, 2 * n_pres0)), E * B)
            pack_cap = min(_pow2(max(4096, 8 * n_pres0)), 2 * E * B)
        first = (d0, d0_pad)
    packed_chain = None
    k_chain = max(int(chain_batches), 1) if mesh is None else 1
    if packed is None and mesh is None:
        # single-dispatch fused pipeline+packer (one RPC out, one fetch in)
        packed = make_pipeline_packed(cfg, calib, pack_cap, lane_cap)
        if k_chain > 1:
            packed_chain = make_pipeline_packed_chain(cfg, calib, pack_cap,
                                                      lane_cap)
    if mesh is not None:
        # mesh path: pack+serialize as a second jit over the sharded output
        _flat = jax.jit(lambda o: flatten_packet(pack_for_writer(o, pack_cap)))

    done_events = 0
    from npswf.utils.timers import device_trace
    trace_ctx = device_trace(profile_dir)
    trace_ctx.__enter__()

    def produce(group, pre_decoded=None):
        """Decode -> upload -> dispatch for a CHAIN of batch ranges (runs
        on a stage worker thread).

        Upload and dispatch are async under JAX; doing them here lets the
        next chain's host-to-device copy overlap the main thread's
        blocking device-to-host fetch. A full-length chain dispatches as ONE scanned
        executable; shorter tail chains (and k=1) take the single-batch
        path per range."""
        items = []
        for j, (lo, hi) in enumerate(group):
            if j == 0 and pre_decoded is not None:
                d, d_pad = pre_decoded
            else:
                with timers.stage("decode"):
                    d = decode_segment(cfg, cal, seg, lo, hi,
                                       use_native=use_native_decode)
                    d_pad = _pad_decoded(cfg, d, batch_size)
            with timers.stage("upload"):
                dev_batch = _upload_batch(cfg, d_pad, dtype)
            items.append((lo, hi, d, d_pad, dev_batch))
        with timers.stage("pipeline"):
            if packed_chain is not None and len(items) == k_chain > 1:
                stack = stack_event_batches([it[4] for it in items])
                flat = packed_chain(stack)                  # [k, total]
            elif packed is not None:
                # ONE output buffer per batch (the dense PipelineOutput
                # would be 25 more buffers per step)
                flat = [packed(it[4]) for it in items]
            else:
                flat = [_flat(pipeline(it[4])) for it in items]
        return items, flat

    last_done = [None]

    def write_part(lo, hi, n_valid, d_pad, pkt_host, out):
        nonlocal done_events
        # inter-batch completion gap: its MEDIAN is the steady-state
        # batch period, robust to a rare slow batch
        t_now = time.perf_counter()
        if last_done[0] is not None:
            timers.record("interbatch", t_now - last_done[0])
        last_done[0] = t_now
        with timers.stage("write"):
            w = WFWriter(cfg)
            if pkt_host is None:
                w.add_batch(out, d_pad, n_valid=n_valid)
            else:
                w.add_packet(pkt_host, d_pad, n_valid=n_valid)
            w.finalize(os.path.join(parts_dir, f"part_{lo:09d}_{hi:09d}.npz"),
                       compress=False)
        progress.mark(lo, hi)
        done_events += n_valid
        if done_events % progress_every < batch_size:
            dt_el = time.perf_counter() - t_start
            log.info(" Entry = %d  elapsed=%.2fs (%.0f ev/s)",
                     lo + n_valid, dt_el, done_events / max(dt_el, 1e-9))

    # three-deep pipeline: 2 stage workers (decode+upload+dispatch), the
    # main thread fetches results in order, 1 writer thread persists parts.
    groups = [pending[i:i + k_chain]
              for i in range(0, len(pending), k_chain)]
    stage_pool = ThreadPoolExecutor(max_workers=2)
    write_pool = ThreadPoolExecutor(max_workers=1)
    max_inflight = 3
    futs = deque()
    wfuts = deque()
    idx_next = 0

    def submit_next():
        nonlocal idx_next, first
        if idx_next < len(groups):
            pre = first if idx_next == 0 else None
            first = None
            futs.append(stage_pool.submit(produce, groups[idx_next], pre))
            idx_next += 1

    try:
        for _ in range(max_inflight):
            submit_next()
        while futs:
            items, flat = futs.popleft().result()
            submit_next()
            # ONE device_get per chain; the next chains are already
            # dispatched, so compute hides behind this transfer
            with timers.stage("fetch"):
                if isinstance(flat, list):
                    rows = [np.asarray(f) for f in flat]
                else:
                    rows = list(np.asarray(flat))           # [k, total]
            for (lo, hi, d, d_pad, dev_batch), buf in zip(items, rows):
                n_valid = hi - lo
                bad = d.bad_slot[:n_valid]
                if np.any(bad != -1):
                    # the reference's per-event warnings (slot problem ref
                    # :867-872, Ndata guard ref :830-836), per batch
                    for e in np.nonzero(bad != -1)[0]:
                        kind = {-2: "truncated stream",
                                -3: "oversize (Ndata guard)"}\
                            .get(int(bad[e]),
                                 f"slot number problem (slot {bad[e]})")
                        log.warning("event %s: %s", d.evt[e], kind)
                pkt_host, lane_ovf = unflatten_packet(
                    buf, batch_size, cfg.nblocks, pack_cap,
                    pres=d_pad.pres[:, :B], lane_cap=lane_cap,
                    P=cfg.maxwfpulses)
                out = None
                # slab packets (lane_cap > 0) have no element capacity —
                # only lane overflow forces the dense fallback
                if lane_ovf or (lane_cap == 0
                                and (int(pkt_host.n_wf) > pack_cap
                                     or int(pkt_host.n_h) > pack_cap)):
                    # occupancy burst beyond the batch-0 sizing: re-run
                    # this batch through the dense pipeline (one extra
                    # batch of compute — the packed path returns only the
                    # flat buffer, see make_pipeline_packed)
                    log.warning("writer-packet overflow (%d/%d wf, %d/%d "
                                "h, lane_ovf=%s); re-running batch dense",
                                int(pkt_host.n_wf), pack_cap,
                                int(pkt_host.n_h), pack_cap, lane_ovf)
                    pkt_host = None
                    out = jax.device_get(pipeline(dev_batch))
                wfuts.append(write_pool.submit(
                    write_part, lo, hi, n_valid, d_pad, pkt_host, out))
            while len(wfuts) > 2:
                wfuts.popleft().result()
        for wf_ in wfuts:
            wf_.result()
    finally:
        # on error: let queued part writes finish (progress sidecar stays
        # resumable), then surface the original exception
        trace_ctx.__exit__(None, None, None)
        stage_pool.shutdown(wait=True)
        write_pool.shutdown(wait=True)

    # ---- ordered merge of parts (the temp->final clone, ref :1396-1432) ----
    # streaming two-pass merge: peak memory = one part's largest column,
    # matching the reference's row-streamed CloneTree (not whole-run RAM).
    with timers.stage("merge"):
        from npswf.io.merge import merge_parts
        part_paths = [os.path.join(parts_dir, f)
                      for f in sorted(os.listdir(parts_dir))]
        merged = merge_parts(part_paths, out_path, payload=dict(seg.payload),
                             compress=compress_output)
    shutil.rmtree(parts_dir, ignore_errors=True)
    if os.path.exists(out_path + ".progress.json"):
        os.remove(out_path + ".progress.json")

    wall = time.perf_counter() - t_start
    res = RunResult(
        n_events=E_total,
        n_fit_success=merged.n_fit_success,
        n_fit_failure=merged.n_fit_failure,
        n_fit_dropped=merged.n_fit_dropped,
        wall_time=wall,
        events_per_sec=E_total / max(wall, 1e-9),
        blocks_per_sec=E_total * cfg.nblocks / max(wall, 1e-9),
        out_path=out_path,
        n_bad_slot=merged.n_bad_slot,
        n_oversize=merged.n_oversize,
        n_truncated=merged.n_truncated,
        n_high_pulse=merged.n_high_pulse,
        n_search_dropped=getattr(merged, "n_search_dropped", 0))
    log.info("Total failed fits: %d total fits succeed: %d (dropped %d)",
             res.n_fit_failure, res.n_fit_success, res.n_fit_dropped)
    if (res.n_bad_slot or res.n_oversize or res.n_truncated
            or res.n_high_pulse or res.n_search_dropped):
        log.warning(
            "decode/search guards: %d bad-slot, %d oversize-skipped, "
            "%d truncated events; %d high-pulse-count blocks; "
            "%d search-capacity-dropped lanes",
            res.n_bad_slot, res.n_oversize, res.n_truncated,
            res.n_high_pulse, res.n_search_dropped)
    log.info(timers.report())
    return res
