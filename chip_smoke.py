#!/usr/bin/env python3
"""On-card smoke test of the waveform pipeline: one GPU, or four with --multi.

Drives the main path once through its user entry point,
``runtime.executor.run_segment`` (decode -> upload -> jitted pipeline ->
packet -> part files -> merge), at full detector width: 1080 blocks x 110
samples in 64-event batches. Phases, all in this one process (a second JAX
process on the card would fail for want of memory):

  1. device line: devices, JAX version, XLA_FLAGS, card name and power
     limit, compile-cache directory, native decoder or numpy fallback;
  2. dense segment (occupancy 1.0, up to 2 pulses, 25% pileup) through
     run_segment, validated by the plotstats check; blocks/s and the
     executor's stage times;
  3. sparse production segment (3% occupancy, sparse readout,
     search_capacity set): no present lane may be dropped;
  4. correctness: matched filter, search and gate against the fp64 golden
     oracle on sampled blocks of a batch the dense phase ran (with their
     device times); the fit in the dense output against the same XLA
     pipeline on the host's CPU device; fit failure rate and single-pulse
     timing of the dense and sparse outputs.

``--multi`` runs only the four-card mesh path (data x block 4x1 and 2x2
through ``run_segment(mesh=...)``) and its comparison with one card.

Each phase prints its wall time. The last line of stdout is the JSON
``{"ok": true, "device": {...}}`` only when every phase passed; the script
exits non-zero, with no such line, when a phase fails or JAX finds no GPU.

Usage: python3 chip_smoke.py [--multi]
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import logging
import os
import shutil
import sys
import tempfile
import time

import numpy as np

# ---- tolerances, each with its reason ---------------------------------
# Fit failure rate: the reference's documented 1-2% band (README.md:129).
MAX_FAIL_RATE = 0.02
# Single-pulse timing: the 0.05-bin parity bar (PARITY.md).
MAX_MEDIAN_DT_BINS = 0.05
# Matched filter: fp32 on the card vs fp64 in the oracle; 11 per-tap
# products and one min-subtraction round at ~6e-8 relative each, so 1e-5 of
# the lane's peak magnitude leaves >10x margin.
MF_RTOL_OF_PEAK = 1e-5
# Search and gate decisions compare thresholds (2% of the deconvolved max,
# the 1.5 mV filter threshold, the 10 mV 3x3 sum): a value within fp32
# rounding of a threshold may decide the other way than the fp64 oracle.
# At most this share of sampled blocks may differ.
MAX_DECISION_MISMATCH = 0.01
# Card vs host at fp32: summation order and the transcendental functions
# differ, and XLA's autotuner may pick another summation order in another
# process, so a lane whose chi2 decrease sits within an ulp of ftol can end
# its LM trajectory an iteration apart — at a different point of a flat
# chi2 valley, or out of budget on one side. Each of the two fit
# differences (fit verdict; a pulse time beyond the timing bar) may touch
# at most this share of the lanes with pulses.
MAX_FP32_OFF = 0.02
# Four-card mesh vs one card: per-lane math is the same on every shard, so
# flips come only from width-dependent XLA reductions; a quarter of the dry
# run's former 2% budget.
MAX_MESH_FLIP = 0.005
# Same-trajectory lanes: the timing bar in ns (0.05 bins x 4 ns).
SAME_LANE_TIME_NS = MAX_MEDIAN_DT_BINS * 4.0
# Blocks sampled for the golden-oracle comparison.
N_GOLDEN_SAMPLES = 384

DENSE = dict(occupancy=1.0, max_pulses=2, pileup_prob=0.25, seed=7)
SPARSE = dict(occupancy=0.03, max_pulses=2, seed=8)


@contextlib.contextmanager
def phase(name: str):
    print(f"== phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== phase {name}: {time.perf_counter() - t0:.1f} s wall",
          flush=True)


# ---- comparison helpers (CPU-tested in tests/test_chip_smoke.py) ---------
def _wf_lanes(wf, n_events: int, n_blocks: int):
    """(pulse counts [E, B], fit-ok [E, B], first-slot offsets [E, B]) of
    the first ``n_events`` rows of a merged WF file (``read_wf``)."""
    npul = np.asarray(wf["wfnpulse"]).reshape(-1, n_blocks)
    start = np.concatenate([[0], np.cumsum(npul.reshape(-1))])[:-1]
    start = start.reshape(npul.shape)[:n_events]
    ok = np.asarray(wf["chi2"]).reshape(-1, n_blocks)[:n_events] > -100.0
    return npul[:n_events], ok, start


def file_mismatch(wf, ref, label: str,
                  max_count_off: float = MAX_DECISION_MISMATCH,
                  max_fit_off: float = MAX_FP32_OFF,
                  time_tol_ns: float = SAME_LANE_TIME_NS) -> dict:
    """Compare the leading events of a merged WF file (``read_wf``) with a
    PipelineOutput ``ref`` of the same events; raise AssertionError beyond
    the bands, else return the counts.

    Of the lanes with pulses, at most ``max_count_off`` may differ in pulse
    count (a search decision); of those with equal counts, at most
    ``max_fit_off`` may differ in fit verdict (chi2 = -100 or not), and at
    most ``max_fit_off`` in a pulse time by more than ``time_tol_ns``."""
    npul_r = np.asarray(ref.wfnpulse)
    E, B = npul_r.shape
    npul_f, ok_f, start = _wf_lanes(wf, E, B)
    ok_r = np.asarray(ref.chi2) > -100.0
    t_r = np.asarray(ref.wftime)
    P = t_r.shape[-1]
    count_off = npul_f != npul_r
    slot = (np.arange(P)[None, None, :] < npul_f[..., None]) \
        & ~count_off[..., None]
    flat = np.asarray(wf["wftime_flat"])
    t_f = flat[np.where(slot, start[..., None] + np.arange(P), 0)]
    dt = np.where(slot, np.abs(t_f - t_r), 0.0)
    time_off = ~count_off & (dt.max(axis=-1) > time_tol_ns)
    verdict_off = ~count_off & (ok_f != ok_r)
    off = count_off | verdict_off | time_off
    n_lanes = max(int(((npul_f > 0) | (npul_r > 0)).sum()), 1)
    counts = {"lanes": n_lanes, "count_off": int(count_off.sum()),
              "verdict_off": int(verdict_off.sum()),
              "time_off": int(time_off.sum()),
              "max_dt_ns_same": float(dt[~off].max()) if (~off).any()
              else 0.0}
    for what, band in (("count_off", max_count_off),
                       ("verdict_off", max_fit_off),
                       ("time_off", max_fit_off)):
        if counts[what] > band * n_lanes:
            raise AssertionError(f"{label}: {what} {counts[what]} of "
                                 f"{n_lanes} lanes with pulses (band "
                                 f"{band:.1%}); {counts}")
    return counts


def single_pulse_dt(cfg, cal, wf, truth, corr) -> np.ndarray:
    """|t_fit - t_true| in bins for blocks with one true and one found
    pulse and a converged fit, from a merged WF file (``read_wf``) of the
    events in ``truth`` (rows in event order); ``corr`` is the per-event
    HMS correction the decoder applied."""
    npul, ok, start = _wf_lanes(wf, *truth.npulse.shape)
    flat = np.asarray(wf["wftime_flat"])
    sel = (truth.npulse == 1) & (npul == 1) & ok
    e, b = np.nonzero(sel)
    t_ns = flat[start[e, b]]
    t_rel = (t_ns - corr[e] + cal.cortime[b]
             + cal.timerefacc * cfg.dt) / cfg.dt
    return np.abs(t_rel + cal.timeref[b] - truth.times[e, b, 0])


def fit_quality(label: str, res, dt_bins: np.ndarray) -> None:
    n = res.n_fit_success + res.n_fit_failure
    rate = res.n_fit_failure / max(n, 1)
    med = float(np.median(dt_bins)) if dt_bins.size else float("nan")
    print(f"{label}: fit failure rate {rate:.4%} ({res.n_fit_failure}/{n}); "
          f"single-pulse |t_fit - t_true| median {med:.4f} bins over "
          f"{dt_bins.size} blocks", flush=True)
    if n == 0 or rate > MAX_FAIL_RATE:
        raise AssertionError(f"{label}: failure rate {rate:.4%} outside "
                             f"the {MAX_FAIL_RATE:.0%} band")
    if not dt_bins.size or med > MAX_MEDIAN_DT_BINS:
        raise AssertionError(f"{label}: single-pulse median {med} bins "
                             f"above {MAX_MEDIAN_DT_BINS}")


# ---- phases --------------------------------------------------------------
class Smoke:
    """State shared by the phases: config, calibration, segments, outputs."""

    def __init__(self, n_dense: int, n_sparse: int, workdir: str):
        from npswf.core.calibration import synthetic_calibration
        from npswf.core.config import NPSConfig
        self.cfg = NPSConfig()
        self.cal = synthetic_calibration(self.cfg, seed=1)
        self.n_dense, self.n_sparse = n_dense, n_sparse
        self.workdir = workdir
        self.E = 64

    def segment(self, n, occupancy, max_pulses, seed, pileup_prob=0.3,
                sparse_readout=False):
        from npswf.utils.synthetic import make_events, synthetic_segment
        truth = make_events(self.cfg, self.cal, n, occupancy=occupancy,
                            max_pulses=max_pulses, pileup_prob=pileup_prob,
                            seed=seed)
        pres = truth.npulse > 0 if sparse_readout else None
        return truth, synthetic_segment(self.cfg, truth, pres=pres,
                                        seed=seed)

    def run(self, cfg, seg, name, mesh=None, timers=None):
        from npswf.runtime.executor import run_segment
        out = os.path.join(self.workdir, f"{name}.npz")
        return run_segment(cfg, self.cal, seg, out, batch_size=self.E,
                           mesh=mesh, resume=False, timers=timers)

    def validate(self, path):
        from npswf.tools.plotstats import main as plotstats_main
        rc = plotstats_main([path])
        if rc != 0:
            raise AssertionError(f"plotstats validation failed on {path}")

    def corr(self, seg):
        from npswf.io.decode import decode_segment
        return decode_segment(self.cfg, self.cal, seg).corr_time_HMS

    # -- 2 ------------------------------------------------------------------
    def dense(self):
        from npswf.utils.timers import StageTimer
        self.dense_truth, self.dense_seg = self.segment(self.n_dense, **DENSE)
        res = self.run(self.cfg, self.dense_seg, "dense")
        print(f"dense cold: {res.blocks_per_sec:,.0f} blocks/s "
              f"({res.wall_time:.1f} s incl. compile)", flush=True)
        rates = []
        for _ in range(2):
            timers = StageTimer()
            res = self.run(self.cfg, self.dense_seg, "dense", timers=timers)
            rates.append(res.blocks_per_sec)
            print(f"dense: {res.blocks_per_sec:,.0f} blocks/s "
                  f"({res.n_events} events, {res.wall_time:.3f} s); "
                  f"{timers.report()}", flush=True)
        print("dense blocks/s runs: " + ", ".join(f"{v:,.0f}" for v in rates),
              flush=True)
        self.dense_res = res
        self.dense_path = os.path.join(self.workdir, "dense.npz")
        self.validate(self.dense_path)

    # -- 3 ------------------------------------------------------------------
    def sparse(self):
        from npswf.utils.timers import StageTimer
        self.sparse_truth, self.sparse_seg = self.segment(
            self.n_sparse, sparse_readout=True, **SPARSE)
        n_pres = int((self.sparse_truth.npulse > 0).reshape(
            -1, self.E * self.cfg.nblocks).sum(1).max())
        # the CLI's --search-capacity: the per-batch present-lane bound of
        # the data, with headroom (never below it)
        cap = 1 << int(np.ceil(np.log2(2 * max(n_pres, 1))))
        cfg = self.cfg.replace(search_capacity=cap)
        self.run(cfg, self.sparse_seg, "sparse")                  # warm
        timers = StageTimer()
        res = self.run(cfg, self.sparse_seg, "sparse", timers=timers)
        print(f"sparse: {res.blocks_per_sec:,.0f} blocks/s scanned "
              f"({res.n_events} events, {res.wall_time:.3f} s, "
              f"search_capacity {cap} for <= {n_pres} present lanes/batch, "
              f"n_search_dropped {res.n_search_dropped}); {timers.report()}",
              flush=True)
        if res.n_search_dropped != 0:
            raise AssertionError(f"sparse: {res.n_search_dropped} present "
                                 "lanes dropped by search_capacity")
        self.sparse_res = res
        self.sparse_path = os.path.join(self.workdir, "sparse.npz")
        self.validate(self.sparse_path)

    # -- 4 ------------------------------------------------------------------
    def correctness(self, n_cpu_events: int = 8, reps: int = 5):
        import jax
        import jax.numpy as jnp
        from npswf.engine.pipeline import make_pipeline
        from npswf.golden.reference import (cluster_gate_golden,
                                            find_pulses_golden,
                                            matched_filter_golden)
        from npswf.io.decode import decode_segment
        from npswf.io.writer import read_wf
        from npswf.ops.cluster_gate import cluster_gate
        from npswf.ops.matched_filter import matched_filter
        from npswf.ops.peak_search import find_pulses
        from npswf.runtime.executor import _to_event_batch
        cfg, cal = self.cfg, self.cal

        # fit quality of the dense and sparse run_segment outputs
        dense_wf = read_wf(self.dense_path)
        for label, res, wf, truth, seg in (
                ("dense", self.dense_res, dense_wf, self.dense_truth,
                 self.dense_seg),
                ("sparse", self.sparse_res, read_wf(self.sparse_path),
                 self.sparse_truth, self.sparse_seg)):
            fit_quality(label, res, single_pulse_dt(
                cfg, cal, wf, truth, self.corr(seg)))

        def timed(label, fn, *a):
            out = jax.block_until_ready(fn(*a))              # compile
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(*a))
                ts.append((time.perf_counter() - t0) * 1e3)
            print(f"{label} on the card, one {self.E}-event batch: median "
                  f"{np.median(ts):.3f} ms (runs " + ", ".join(
                      f"{t:.3f}" for t in ts) + ")", flush=True)
            return out

        # batch 0 of the dense segment: matched filter, search and gate on
        # the card, against the fp64 golden oracle
        d = decode_segment(cfg, cal, self.dense_seg, 0, self.E)
        sig = np.asarray(d.signal, np.float64).reshape(-1, cfg.ntime)
        mins = np.asarray(d.minsignal, np.float64).reshape(-1)
        N = sig.shape[0]
        lane_blk = np.arange(N) % cfg.nblocks
        kern = cal.mfkern_rev[lane_blk]
        mfint = cal.mfint[lane_blk]
        a32 = [jnp.asarray(v, jnp.float32) for v in (sig, mins, kern, mfint)]
        mf = np.asarray(timed("matched filter", jax.jit(
            lambda s_, m_, k_, i_: matched_filter(
                cfg, s_[:, None], m_[:, None], k_[:, None], i_[:, None]
            )[:, 0]), *a32))
        ps = timed("matched filter + peak search",
                   jax.jit(functools.partial(find_pulses, cfg)), *a32,
                   jnp.ones(N, bool))
        sig3 = jnp.asarray(d.signal, jnp.float32)
        gate = np.asarray(timed("3x3 cluster gate", jax.jit(
            lambda s_: cluster_gate(cfg, s_, jnp.asarray(cal.timeref,
                                                         jnp.float32),
                                    cal.timerefacc)), sig3)).reshape(-1)
        npulse = np.asarray(ps.npulse)
        npul_file = _wf_lanes(dense_wf, self.E, cfg.nblocks)[0].reshape(-1)
        n_pipe_off = int((npulse != npul_file).sum())
        rng = np.random.default_rng(3)
        with_pulse = np.flatnonzero(npulse > 0)
        lanes = np.unique(np.concatenate([
            rng.choice(with_pulse, min(N_GOLDEN_SAMPLES // 2,
                                       with_pulse.size), replace=False),
            rng.choice(N, N_GOLDEN_SAMPLES // 2, replace=False)]))
        pres = np.asarray(d.pres[:, :cfg.nblocks]).astype(bool)
        sig_e = sig.reshape(self.E, cfg.nblocks, -1)
        mf_err, search_bad, gate_bad = 0.0, 0, 0
        for lane in lanes:
            b, e = lane_blk[lane], lane // cfg.nblocks
            g_mf = matched_filter_golden(cfg, sig[lane], mins[lane],
                                         kern[lane], mfint[lane])
            scale = max(1.0, float(np.abs(g_mf).max()))
            mf_err = max(mf_err, float(np.abs(mf[lane] - g_mf).max()) / scale)
            gn, gt, ga = find_pulses_golden(cfg, sig[lane], mins[lane],
                                            kern[lane], mfint[lane], True)
            n = int(npulse[lane])
            if (n != gn
                    or not np.array_equal(np.asarray(ps.times)[lane, :n], gt)
                    or not np.allclose(np.asarray(ps.amps)[lane, :n], ga,
                                       rtol=1e-4, atol=1e-3)):
                search_bad += 1
            gate_bad += int(bool(gate[lane]) != cluster_gate_golden(
                cfg, sig_e[e], pres[e], int(b), cal.timeref[b],
                cal.timerefacc))
        print(f"golden oracle on {lanes.size} sampled blocks: matched filter "
              f"max error {mf_err:.3g} of peak (tol {MF_RTOL_OF_PEAK}); "
              f"search mismatches {search_bad}, gate mismatches {gate_bad} "
              f"(tol {MAX_DECISION_MISMATCH:.0%} each); pulse counts of the "
              f"search vs the run_segment output: {n_pipe_off} of {N} lanes "
              "differ", flush=True)
        if mf_err > MF_RTOL_OF_PEAK:
            raise AssertionError(f"matched filter error {mf_err}")
        for what, bad, tot in (("search", search_bad, lanes.size),
                               ("gate", gate_bad, lanes.size),
                               ("pipeline pulse count", n_pipe_off, N)):
            if bad > MAX_DECISION_MISMATCH * tot:
                raise AssertionError(f"{what}: {bad}/{tot} blocks differ")

        # the fit in the dense output vs the same XLA pipeline on the host
        cpu = jax.devices("cpu")[0]
        d8 = decode_segment(cfg, cal, self.dense_seg, 0, n_cpu_events)
        batch = jax.device_put(_to_event_batch(cfg, d8, np.float32), cpu)
        calib = jax.device_put(cal.device_arrays(cfg), cpu)
        t0 = time.perf_counter()
        ref = jax.block_until_ready(make_pipeline(cfg, calib)(batch))
        print(f"host-CPU pipeline, {n_cpu_events} events: "
              f"{time.perf_counter() - t0:.1f} s incl. compile", flush=True)
        print(f"card (dense run_segment output) vs host CPU: "
              f"{file_mismatch(dense_wf, ref, 'card vs CPU')}", flush=True)

    # -- --multi --------------------------------------------------------------
    def multi(self, n_events: int = 256):
        import jax
        from npswf.engine.pipeline import make_pipeline
        from npswf.io.decode import decode_segment
        from npswf.io.writer import read_wf
        from npswf.parallel.mesh import (make_mesh, make_sharded_pipeline,
                                         shard_calibration, shard_event_batch)
        from npswf.runtime.executor import _to_event_batch
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from __graft_entry__ import compare_to_unsharded
        import jax.numpy as jnp
        cfg, cal = self.cfg, self.cal
        truth, seg = self.segment(n_events, **DENSE)
        ref_res = self.run(cfg, seg, "one_card")
        print(f"one card: {ref_res.blocks_per_sec:,.0f} blocks/s (cold)",
              flush=True)
        ref_res = self.run(cfg, seg, "one_card")
        ref_wf = read_wf(os.path.join(self.workdir, "one_card.npz"))
        print(f"one card: {ref_res.blocks_per_sec:,.0f} blocks/s",
              flush=True)
        d = decode_segment(cfg, cal, seg, 0, self.E)
        batch = _to_event_batch(cfg, d, np.float32)
        calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}
        ref_out = jax.block_until_ready(make_pipeline(cfg, calib)(batch))
        for n_data, n_block in ((4, 1), (2, 2)):
            label = f"{n_data}x{n_block}"
            mesh = make_mesh(cfg, n_data=n_data, n_block=n_block)
            self.run(cfg, seg, f"mesh_{label}", mesh=mesh)           # warm
            res = self.run(cfg, seg, f"mesh_{label}", mesh=mesh)
            path = os.path.join(self.workdir, f"mesh_{label}.npz")
            self.validate(path)
            wf = read_wf(path)
            if not np.array_equal(wf["wfnpulse"], ref_wf["wfnpulse"]):
                raise AssertionError(f"mesh {label}: pulse counts differ "
                                     "from one card")
            n_fit = ref_res.n_fit_success + ref_res.n_fit_failure
            d_fail = abs(res.n_fit_failure - ref_res.n_fit_failure)
            if d_fail > MAX_MESH_FLIP * n_fit:
                raise AssertionError(f"mesh {label}: failures "
                                     f"{res.n_fit_failure} vs "
                                     f"{ref_res.n_fit_failure}")
            calib_s = shard_calibration(cfg, calib, mesh)
            out = make_sharded_pipeline(cfg, calib_s, mesh)(
                shard_event_batch(cfg, batch, mesh))
            nflip, nfit = compare_to_unsharded(
                jax.device_get(out), jax.device_get(ref_out), label,
                max_flip_frac=MAX_MESH_FLIP)
            print(f"mesh {label}: {res.blocks_per_sec:,.0f} blocks/s "
                  f"({res.n_events} events) vs one card "
                  f"{ref_res.blocks_per_sec:,.0f}; file: pulse counts "
                  f"equal, failures {res.n_fit_failure} vs "
                  f"{ref_res.n_fit_failure}; batch 0: {nflip}/{nfit} "
                  f"trajectory flips (band {MAX_MESH_FLIP:.1%})", flush=True)


def device_line(multi: bool) -> None:
    import jax
    from npswf.io import native
    from npswf.utils.compile_cache import setup_compile_cache
    from npswf.utils.device_info import card_name_and_power_limit
    devs = jax.devices()
    print(f"jax {jax.__version__}; devices {devs}; device_kind "
          f"{devs[0].device_kind}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {setup_compile_cache()}")
    print("host decoder: " + ("native C++ library loaded" if native.load()
                              is not None else "numpy fallback"))
    if multi and len(devs) < 4:
        raise AssertionError(f"--multi needs 4 GPUs, found {len(devs)}")
    print(card_name_and_power_limit(), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card mesh path and its "
                         "one-card comparison")
    args = ap.parse_args(argv)
    import jax
    from npswf.utils.device_info import NotOnGPU, require_gpu
    try:
        dev = require_gpu()
    except NotOnGPU as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.WARNING,
                        format="%(name)s %(levelname)s %(message)s")
    t_all = time.perf_counter()
    with phase("1 device"):
        device_line(args.multi)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        smoke = Smoke(n_dense=512, n_sparse=1024, workdir=workdir)
        if args.multi:
            with phase("multi: 4x1 and 2x2 vs one card"):
                smoke.multi()
        else:
            with phase("2 dense run_segment"):
                smoke.dense()
            with phase("3 sparse run_segment"):
                smoke.sparse()
            with phase("4 correctness vs references"):
                smoke.correctness()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"chip_smoke total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
