"""Benchmark: blocks fitted per second per chip (full event, 1080 blocks).

Runs the complete device pipeline — matched filter, Markov/deconvolution peak
search, 3x3 cluster gate, batched bounded-LM fit with retry escalation — on a
dense synthetic batch where every one of the 1080 calorimeter blocks carries
a pulse, i.e. every block is searched AND fitted (the reference's worst-case
"full event").

Baseline: the reference (mkerv/nps-waveform-analysis) publishes no throughput
numbers (BASELINE.md). The vs_baseline denominator is MEASURED at bench time
by `tools/cpu_baseline.py`: a single-thread CPU runner of the reference's
per-block algorithm (golden matched filter + TSpectrum search, then a
bounded scipy-TRF fit standing in for Minuit2 Migrad) on the same dense
batch, extrapolated x4 threads (the macro's default). Because the golden
search is a Python-loop oracle (compiled TSpectrum would be much faster),
the denominator conservatively charges the baseline for the FIT STAGE ONLY
(search treated as free) — the larger, harder-to-beat figure. The previous
documented estimate (1,200 blocks/s) is printed alongside for continuity.
Refuses to run (exit 2, no metric) when the first JAX device is not a GPU.
Prints ONE JSON line to stdout; diagnostics go to stderr.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

ESTIMATE_BLOCKS_PER_SEC = 1200.0  # round-1 documented estimate (continuity)


def main() -> int:
    import jax
    import jax.numpy as jnp

    from npswf.utils.compile_cache import setup_compile_cache
    from npswf.utils.device_info import (card_name_and_power_limit,
                                         require_gpu)
    setup_compile_cache()
    dev = require_gpu()
    print(f"bench device: {dev} ({dev.device_kind}, "
          f"{len(jax.devices())} device(s)); card: "
          f"{card_name_and_power_limit()}", file=sys.stderr)

    from npswf.core.calibration import synthetic_calibration
    from npswf.core.config import NPSConfig
    from npswf.engine.pipeline import EventBatch, make_pipeline
    from npswf.utils.synthetic import make_events

    from npswf.engine.pipeline import (make_pipeline_chain,
                                       stack_event_batches)

    cfg = NPSConfig(compute_dtype="float32")
    cal = synthetic_calibration(cfg, seed=1)
    E = 64
    K = 8   # batches per dispatch chain (executor chain_batches regime)
    rng = np.random.default_rng(11)

    truths = {}

    def mk_batch(seed):
        truth = truths.setdefault(seed, make_events(
            cfg, cal, E, occupancy=1.0, max_pulses=2,
            pileup_prob=0.25, seed=seed))
        return EventBatch(
            signal=jnp.asarray(truth.signal.astype(np.float32)),
            pres=jnp.asarray(truth.pres.astype(bool)),
            corr_time_HMS=jnp.asarray(
                rng.uniform(-2, 2, E).astype(np.float32)),
            evt=jnp.arange(E, dtype=jnp.int32),
            runnum=jnp.full(E, 3000, dtype=jnp.int32))

    batch = mk_batch(7)
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}
    pipeline = make_pipeline(cfg, calib)

    t0 = time.perf_counter()
    out = pipeline(batch)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0
    print(f"compile+first-run: {compile_s:.1f}s", file=sys.stderr)
    print(f"pulses found: {int(np.asarray(out.wfnpulse).sum())}, "
          f"fit success: {int(out.n_fit_success)}, "
          f"failure: {int(out.n_fit_failure)}", file=sys.stderr)

    # single-batch regimes (diagnostics beside the chained metric)
    _ = np.asarray(pipeline(batch).chi2)
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        _ = np.asarray(pipeline(batch).chi2)
    dt_sync = (time.perf_counter() - t0) / iters
    print(f"steady-state (sync per batch): {dt_sync * 1e3:.1f} ms/batch of "
          f"{E} events ({E / dt_sync:.1f} ev/s)", file=sys.stderr)

    iters_p = 8
    t0 = time.perf_counter()
    prev = None
    for _ in range(iters_p):
        out_i = pipeline(batch)
        if prev is not None:
            _ = np.asarray(prev.chi2)
        prev = out_i
    _ = np.asarray(prev.chi2)
    dt_single = (time.perf_counter() - t0) / iters_p
    print(f"steady-state (pipelined, 2 in flight, 1 batch/dispatch): "
          f"{dt_single * 1e3:.1f} ms/batch ({E / dt_single:.1f} ev/s)",
          file=sys.stderr)

    # Metric of record: the CHAINED pipelined regime — K distinct batches
    # scanned inside one executable per dispatch (exactly how the
    # streaming executor runs with chain_batches=K), two chains in
    # flight. Every chain's outputs are forced inside the timed window,
    # so async dispatch cannot fake completion.
    chain = make_pipeline_chain(cfg, calib)
    stacks = [stack_event_batches([mk_batch(7 + 2 * j + s)
                                   for j in range(K)]) for s in (0, 1)]
    t0 = time.perf_counter()
    co = chain(stacks[0])
    jax.block_until_ready(co.chi2)
    print(f"chain compile+first-run: {time.perf_counter() - t0:.1f}s "
          f"(K={K})", file=sys.stderr)
    print(f"chain totals: fit success {int(np.asarray(co.n_fit_success).sum())}, "
          f"failure {int(np.asarray(co.n_fit_failure).sum())}",
          file=sys.stderr)
    _ = np.asarray(chain(stacks[1]).chi2)
    n_chains = 4
    t0 = time.perf_counter()
    prev = None
    for i in range(n_chains):
        o = chain(stacks[i % 2])
        if prev is not None:
            _ = np.asarray(prev.chi2)
        prev = o
    _ = np.asarray(prev.chi2)
    dt = (time.perf_counter() - t0) / (n_chains * K)
    blocks_per_sec = E * cfg.nblocks / dt
    print(f"steady-state (chained, {K} batches/dispatch, 2 chains in "
          f"flight): {dt * 1e3:.1f} ms/batch ({E / dt:.1f} ev/s)",
          file=sys.stderr)

    # production-shape diagnostic (stderr only): realistic sparse occupancy
    # AND sparse readout presence (real events read out only the hit region)
    # in the SAME chained regime AND the same executable as the metric of
    # record (search-lane compaction would force a second chain compile
    # here; the production executor enables it via cfg.search_capacity —
    # see tools/e2e_bench.py)

    def mk_sparse(seed):
        truth_s = make_events(cfg, cal, E, occupancy=0.05, max_pulses=2,
                              seed=seed)
        return EventBatch(
            signal=jnp.asarray(truth_s.signal.astype(np.float32)),
            pres=jnp.asarray(truth_s.npulse > 0),
            corr_time_HMS=batch.corr_time_HMS, evt=batch.evt,
            runnum=batch.runnum)

    stacks_s = [stack_event_batches([mk_sparse(8 + 2 * j + s)
                                     for j in range(K)]) for s in (0, 1)]
    o_s = chain(stacks_s[0])
    jax.block_until_ready(o_s.chi2)
    assert int(np.asarray(o_s.n_search_dropped).sum()) == 0
    _ = np.asarray(chain(stacks_s[1]).chi2)
    t0 = time.perf_counter()
    prev = None
    for i in range(3):
        o = chain(stacks_s[i % 2])
        if prev is not None:
            _ = np.asarray(prev.chi2)
        prev = o
    _ = np.asarray(prev.chi2)
    dts = (time.perf_counter() - t0) / (3 * K)
    print(f"sparse (occupancy 0.05, sparse readout, chained, same "
          f"executable): {dts * 1e3:.1f} ms/batch "
          f"({E / dts:.1f} ev/s, {E * cfg.nblocks / dts:.0f} blocks scanned/s)",
          file=sys.stderr)

    # --- adversarial fit-quality diagnostics (stderr only) --------------
    # Ensembles shared with tools/solver_audit.py (the scipy-TRF failure
    # classification); see utils/synthetic.adversarial_variants for why the
    # clean-synthetic rate is not comparable to the reference's 1-2%.
    from npswf.utils.synthetic import adversarial_variants
    adv = adversarial_variants(cfg, cal, truths[7], seed=23)

    def fail_rate(sig):
        b = EventBatch(signal=jnp.asarray(sig.astype(np.float32)),
                       pres=batch.pres, corr_time_HMS=batch.corr_time_HMS,
                       evt=batch.evt, runnum=batch.runnum)
        o = pipeline(b)
        ns, nf = int(o.n_fit_success), int(o.n_fit_failure)
        return nf / max(ns + nf, 1), ns + nf

    clean_rate = (int(out.n_fit_failure) /
                  max(int(out.n_fit_success) + int(out.n_fit_failure), 1))
    r_wrong, n_wrong = fail_rate(adv["wrong_shape"])
    r_corr, n_corr = fail_rate(adv["correlated_noise"])
    r_clip, n_clip = fail_rate(adv["clipped"])
    print("fit failure rates -- clean synthetic (same model as fit): "
          f"{clean_rate:.2%}; wrong-shape: {r_wrong:.2%} ({n_wrong} fits); "
          f"correlated-noise: {r_corr:.2%} ({n_corr}); "
          f"clipped: {r_clip:.2%} ({n_clip}). The reference's 1-2% "
          "(README.md:129) is on real data; only the adversarial rows are "
          "comparable in spirit.", file=sys.stderr)

    # --- measured baseline denominator (tools/cpu_baseline.py) ----------
    # Single-thread reference-algorithm run over >=3 independent noise
    # seeds; x4 threads; search charged as FREE (conservative — the golden
    # search is a Python oracle, compiled TSpectrum would be faster, so the
    # fit-only figure is the harder denominator). The seed spread gives the
    # denominator an error bar; the denominator takes the max over seeds.
    from npswf.tools.cpu_baseline import measure_cpu_baseline_spread
    cbs = measure_cpu_baseline_spread(cfg, cal, time_budget_s=4.0,
                                      min_blocks=48)
    fit_ms = cbs["fit_ms_per_block"]
    base_fit_only = 4.0 * 1e3 / max(fit_ms["min"], 1e-9)  # fastest seed
    # denominator: the HARDEST of (measured fit-only max-over-seeds,
    # measured total max-over-seeds, the round-1 estimate) — measurement
    # validated the estimate (it is HIGHER than the measured figures on
    # this host), so keeping it in the max is purely conservative and
    # stable across bench hosts
    baseline = max(base_fit_only, cbs["blocks_per_sec_4thread"]["max"],
                   ESTIMATE_BLOCKS_PER_SEC)
    sm = cbs["search_ms_per_block"]
    tm = cbs["blocks_per_sec_4thread"]
    print(f"measured CPU baseline ({len(cbs['seeds'])} seeds): "
          f"search {sm['min']:.2f}/{sm['median']:.2f}/{sm['max']:.2f} "
          "ms/blk min/median/max (python oracle), "
          f"fit {fit_ms['min']:.2f}/{fit_ms['median']:.2f}/"
          f"{fit_ms['max']:.2f} ms/blk (scipy TRF); 4-thread total "
          f"{tm['min']:.0f}/{tm['median']:.0f}/{tm['max']:.0f} blocks/s, "
          f"fit-only (denominator) {base_fit_only:.0f} blocks/s "
          f"(round-1 estimate was {ESTIMATE_BLOCKS_PER_SEC:.0f})",
          file=sys.stderr)

    print(json.dumps({
        "metric": "blocks fitted/sec/chip (full event, 1080 blocks; "
                  "chained dispatch, 8 batches/jit-call as the executor's "
                  "chain_batches regime runs); "
                  "vs_baseline divides by the harder of a MEASURED 4-thread "
                  f"CPU reference run and the 1200 estimate ({baseline:.0f} "
                  "blocks/s; measurement: golden-algorithm search + "
                  "scipy-TRF fit at bench time — see stderr)",
        "value": round(blocks_per_sec, 1),
        "unit": "blocks/s",
        "vs_baseline": round(blocks_per_sec / baseline, 2),
    }))
    return 0


if __name__ == "__main__":
    from npswf.utils.device_info import NotOnGPU
    try:
        sys.exit(main())
    except NotOnGPU as exc:
        print(f"bench: {exc}", file=sys.stderr)
        sys.exit(2)
