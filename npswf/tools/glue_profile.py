"""Itemize the per-batch DEVICE budget by stage ablation + scan slopes.

The measurement is the **scan slope**: the pipeline runs k in {K1, K2}
times inside ONE ``lax.scan`` (per-step input scaling defeats
CSE/memoization; outputs are consumed into the carry), and the per-batch
device cost is ``(wall(K2) - wall(K1)) / (K2 - K1)`` — any fixed
per-dispatch and per-fetch cost cancels in the slope.

Stage ablation at trace time is unchanged: each variant stubs exactly
one stage with shape/dtype-identical constants (the search stub embeds
the REAL precomputed result so the fit workload is bit-identical).

Usage::

    python -m npswf.tools.glue_profile [--events 64] [--k1 2]
        [--k2 8] [--iters 4] [--cpu]

Prints a markdown table plus one JSON line (consumed for PERF.md).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager

import numpy as np

from npswf.core.config import NPSConfig
from npswf.core.calibration import synthetic_calibration


@contextmanager
def _patched(module, **repls):
    olds = {k: getattr(module, k) for k in repls}
    try:
        for k, v in repls.items():
            setattr(module, k, v)
        yield
    finally:
        for k, v in olds.items():
            setattr(module, k, v)


def scan_slope(make_consume, batch, k1: int, k2: int, iters: int) -> float:
    """Per-batch device seconds via the k-chained lax.scan slope."""
    import jax
    import jax.numpy as jnp

    def chain(k):
        def body(carry, x):
            b = batch._replace(signal=batch.signal * x)
            return carry + make_consume(b), None

        return jax.jit(lambda xs: jax.lax.scan(
            body, jnp.zeros((), jnp.float32), xs)[0])

    walls = []
    for k in (k1, k2):
        f = chain(k)
        xs = jnp.asarray(1.0 + 1e-4 * np.random.default_rng(0).random(k),
                         jnp.float32)
        jax.block_until_ready(f(xs))            # compile + warm
        best = float("inf")
        for i in range(iters):
            xs = jnp.asarray(
                1.0 + 1e-4 * np.random.default_rng(i + 1).random(k),
                jnp.float32)
            t0 = time.perf_counter()
            jax.block_until_ready(f(xs))
            best = min(best, time.perf_counter() - t0)
        walls.append(best)
    return (walls[1] - walls[0]) / (k2 - k1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=64)
    ap.add_argument("--k1", type=int, default=2)
    ap.add_argument("--k2", type=int, default=8)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp

    import npswf.engine.pipeline as pl
    from npswf.engine.pipeline import EventBatch
    from npswf.fit.lm import FitResult
    from npswf.ops.peak_search import PulseSearchResult
    from npswf.utils.synthetic import make_events

    print(f"device: {jax.devices()[0].device_kind}", file=sys.stderr)
    cfg = NPSConfig(compute_dtype="float32")
    cal = synthetic_calibration(cfg, seed=1)
    E = args.events
    truth = make_events(cfg, cal, E, occupancy=1.0, max_pulses=2,
                        pileup_prob=0.25, seed=7)
    B, P = cfg.nblocks, cfg.maxwfpulses
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(cfg).items()}
    batch = EventBatch(
        signal=jnp.asarray(truth.signal.astype(np.float32)),
        pres=jnp.asarray(truth.pres.astype(bool)),
        corr_time_HMS=jnp.zeros((E,), jnp.float32),
        evt=jnp.arange(E, dtype=jnp.int32),
        runnum=jnp.full((E,), 4001, jnp.int32))

    # ---- stage stubs ----------------------------------------------------
    # search: the REAL result, precomputed once and embedded as constants —
    # ablating the search must leave the fit's inputs (hence its iteration
    # counts) bit-identical, or the marginal is contaminated by a changed
    # fit workload. fit/diag: shape/dtype-identical constants (downstream
    # consumers are value-independent masked ops with static shapes).
    dt32 = jnp.float32
    N = E * B
    flat_sig = batch.signal.reshape(N, cfg.ntime)
    flat_present = (batch.pres
                    & jnp.asarray(cal.preswf)[None, :]).reshape(N)
    kern_flat = jnp.broadcast_to(
        calib["mfkern_rev"].astype(dt32)[None], (E, B, cfg.mfwidth)
    ).reshape(N, -1)
    mfint_flat = jnp.broadcast_to(
        calib["mfint"].astype(dt32)[None], (E, B)).reshape(N)
    from npswf.ops.peak_search import find_pulses as real_find_pulses
    ps_real = jax.tree.map(np.asarray, jax.jit(
        lambda *a: real_find_pulses(cfg, *a))(
        flat_sig, jnp.min(flat_sig, axis=1), kern_flat, mfint_flat,
        flat_present))

    def stub_search(cfg_, signal, minsignal, kern_rev, mfint, present):
        return PulseSearchResult(*(jnp.asarray(v) for v in ps_real))

    def stub_fit(cfg_, inp, model_name=""):
        n, Pb = inp.t_seed.shape
        dt = inp.y.dtype
        z = jnp.zeros((n,), dt)
        return FitResult(
            params=jnp.zeros((n, 1 + 2 * Pb), dt), chi2=z, chi2_ndf=z,
            converged=inp.active, converged_stage1=inp.active,
            n_iter=jnp.zeros((n,), jnp.int32), edm=z)

    def stub_diag(cfg_, signal):
        zb = jnp.zeros(signal.shape[:-1], signal.dtype)
        ze = jnp.zeros(signal.shape[:-2], signal.dtype)
        return {"ampl": zb, "ener": zb, "integ": zb, "bkg": zb,
                "noise": zb, "enertot": ze, "integtot": ze}

    def consume_all(out):
        s = jnp.zeros((), jnp.float32)
        for v in out:
            s = s + jnp.sum(v.astype(jnp.float32))
        return s

    MIN = {"find_pulses": stub_search, "_fit_chunked": stub_fit,
           "block_diagnostics": stub_diag}
    variants = {
        "full": ({}, cfg),
        "no_search": ({"find_pulses": stub_search}, cfg),
        "no_fit": ({"_fit_chunked": stub_fit}, cfg),
        "no_diag": ({"block_diagnostics": stub_diag}, cfg),
        "minimal": (MIN, cfg),
        # fit-internal ladder (real search/diag, fit stage knobs)
        "fit_no_stage3": ({}, cfg.replace(lm_stage3=False)),
        "fit_stage1_only": ({}, cfg.replace(lm_stage3=False,
                                            lm_max_iter_stage2=0,
                                            lm_stage2_wide=0)),
    }
    times = {}
    for name, (repls, c) in variants.items():
        with _patched(pl, **repls):
            times[name] = scan_slope(
                lambda b, c=c: consume_all(pl.process_batch(c, calib, b)),
                batch, args.k1, args.k2, args.iters) * 1e3
        print(f"[glue] {name}: {times[name]:.2f} ms/batch (scan slope)",
              file=sys.stderr)

    res = {
        "full": times["full"],
        "fit": times["full"] - times["no_fit"],
        "search": times["full"] - times["no_search"],
        "diag": times["full"] - times["no_diag"],
        "glue_direct": times["minimal"],
        "fit_stage3": times["full"] - times["fit_no_stage3"],
        "fit_stage2": times["fit_no_stage3"] - times["fit_stage1_only"],
        "events": E, "k1": args.k1, "k2": args.k2,
    }
    print("| slice | ms/batch (device, scan slope) |")
    print("|---|---|")
    for k in ("full", "fit", "search", "diag", "glue_direct",
              "fit_stage3", "fit_stage2"):
        print(f"| {k} | {res[k]:.2f} |")
    print(json.dumps({k: (round(v, 2) if isinstance(v, float) else v)
                      for k, v in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
