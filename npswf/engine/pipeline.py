"""The batched event pipeline — the device equivalent of ``analyze``.

The reference processes one event per thread through a sequential per-block
loop (ref TEST_2.C:540-1300). Here a whole event batch is one fixed-shape
jitted computation:

    signal [E, B, T] --> matched filter + peak search (all E*B lanes)
                     --> 3x3 cluster gate
                     --> fit-lane compaction (optional static capacity)
                     --> batched bounded LM fit with retry escalation
                     --> output-path resolution + time conversion
                     --> diagnostics reductions

Output-path semantics preserved from the reference:
- cluster-gate FAIL: pulses keep their raw TSpectrum values — times in BIN
  units, seed amplitudes — chi2 = -100, no timewf/amplwf/h1/h2 bookkeeping
  (the `continue` at ref :985).
- fit FAIL (both stages): times converted to ns with the seed values
  (ref :779-791), amplitudes keep seeds, chi2 = -100.
- fit OK: fitted amplitudes; t_fit*dt + corr_time_HMS - cortime - timerefacc*dt
  (ref :793-827); chi2 = chi2/ndf.
- npulse == 0 (gate passed): chi2 = -100 (ref :605-608), no pulses emitted.

timewf/amplwf pick the pulse with |time| closest to zero, first-on-tie
(ref :999-1016); h1time/h2time are filled for gate-passed pulses with final
amplitude > 20 (ref :988-997).
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from npswf.core.config import NPSConfig
from npswf.engine.diagnostics import block_diagnostics
from npswf.fit.errors import error_model
from npswf.fit.lm import FitInputs, FitResult, fit_waveforms
from npswf.ops.cluster_gate import cluster_gate
from npswf.ops.peak_search import find_pulses


class EventBatch(NamedTuple):
    """Device-side inputs for one batch of events."""
    signal: jnp.ndarray          # [E, B, T] waveforms (decoded host-side)
    pres: jnp.ndarray            # [E, B] bool — block present in the readout
    corr_time_HMS: jnp.ndarray   # [E] HMS timing correction (host-side, ref :893-911)
    evt: jnp.ndarray             # [E] global event numbers
    runnum: jnp.ndarray          # [E] run numbers
    # [E, B] per-block baseline from the DECODER (min over the nsamp samples
    # actually read, ref :884) — None only for dense synthetic batches where
    # every block carries exactly ntime samples and min-over-T is identical
    minsignal: Optional[jnp.ndarray] = None


class PipelineOutput(NamedTuple):
    """Fixed-shape per-event outputs (ragged flattening happens at write-out)."""
    wfnpulse: jnp.ndarray        # [E, B] i32
    wftime: jnp.ndarray          # [E, B, P] — ns (fit paths) or bins (gate fail)
    wfampl: jnp.ndarray          # [E, B, P]
    pulse_valid: jnp.ndarray     # [E, B, P] bool
    chi2: jnp.ndarray            # [E, B] chi2/ndf or -100
    timewf: jnp.ndarray          # [E, B] closest-to-zero pulse time (or -100)
    amplwf: jnp.ndarray          # [E, B] its amplitude (or -100)
    pedwf: jnp.ndarray           # [E, B] fitted pedestal p0 (seed value on
                                 # unfitted lanes) — persisted so diagnostics
                                 # can replay the exact fitted curve
    gate: jnp.ndarray            # [E, B] bool — cluster gate decision
    fit_converged: jnp.ndarray   # [E, B] bool
    fit_n_iter: jnp.ndarray      # [E, B] i32 — LM iterations the solver spent
                                 # on the lane (all stages; 0 = not fitted).
                                 # Determinism fingerprint: routing/layout
                                 # changes that leave results identical must
                                 # leave this identical too (tests/test_routing)
    h1time: jnp.ndarray          # [E, B, P] h1 entries (valid via h_mask)
    h2time: jnp.ndarray          # [E, B, P]
    h_mask: jnp.ndarray          # [E, B, P] bool
    ampl: jnp.ndarray            # [E, B] max sample (diagnostics)
    ener: jnp.ndarray            # [E, B]
    integ: jnp.ndarray           # [E, B]
    bkg: jnp.ndarray             # [E, B]
    noise: jnp.ndarray           # [E, B]
    enertot: jnp.ndarray         # [E]
    integtot: jnp.ndarray        # [E]
    n_fit_success: jnp.ndarray   # [] i32 — batch totals (ref atomics :61-62)
    n_fit_failure: jnp.ndarray   # [] i32
    n_fit_dropped: jnp.ndarray   # [] i32 — lanes beyond fit_capacity (no silent cap)
    n_high_pulse: jnp.ndarray    # [] i32 — lanes with npulse > maxwfpulses-2
                                 # (the reference's excessive-pulse warning,
                                 # ref TEST_2.C:209-213)
    n_search_dropped: jnp.ndarray  # [] i32 — present lanes beyond
                                   # search_capacity (no silent cap)
    search_overflow: jnp.ndarray   # [E, B] bool — present lanes that
                                   # exceeded search_capacity (npulse forced
                                   # to 0): distinguishes them from genuinely
                                   # empty blocks in the WF file. Required:
                                   # mesh out_specs assume every field is an
                                   # array (parallel/mesh.py), so a None here
                                   # would surface as a confusing shard_map
                                   # error far from the cause


def _gather_lanes(arr, sel):
    return jnp.take(arr, sel, axis=0)


def _fit_chunked(cfg: NPSConfig, inp: FitInputs, model_name: str = "spline_ref"):
    """Run the LM fit with lax.map-chunked stage 1 (bounded kernel sizes,
    per-chunk early exit) and ONE global stage-2 retry pass — per-chunk
    stage 2 would multiply the retry rounds' fixed cost by the chunk count
    (measured ~48 ms vs ~16 ms on a 64-event batch)."""
    chunk = cfg.fit_chunk if cfg.fit_chunk > 0 else 0
    return fit_waveforms(cfg, inp, model_name, stage1_chunk=chunk)


def process_batch(cfg: NPSConfig, calib: Dict[str, jnp.ndarray],
                  batch: EventBatch, block_axis: Optional[str] = None,
                  block_shards: int = 1,
                  reduce_axes: Tuple[str, ...] = ()) -> PipelineOutput:
    """Run the full pipeline on one event batch. Shapes are static in (E, B, T).

    Inside shard_map, ``block_axis``/``block_shards`` enable the halo-exchanged
    cluster stencil across calorimeter-row shards, and ``reduce_axes`` names
    the mesh axes over which the fit counters are psum-reduced (the reference's
    atomic counters, ref TEST_2.C:61-62, become one XLA collective).
    """
    signal = batch.signal
    E, B, T = signal.shape
    P = cfg.maxwfpulses
    dtype = signal.dtype
    N = E * B

    preswf = calib["preswf"]
    timeref = calib["timeref"].astype(dtype)
    cortime = calib["cortime"].astype(dtype)
    timerefacc = jnp.asarray(calib["timerefacc"], dtype)
    coeffs = calib["spline_coeffs"].astype(dtype)
    x0 = calib["spline_x0"].astype(dtype)
    kern = calib["mfkern_rev"].astype(dtype)

    # coerce to bool: integer present flags (the decoder's raw 0/1 column,
    # synthetic truth) would otherwise int-promote every downstream mask and
    # break the fit cond's branch-dtype agreement
    present = batch.pres.astype(bool) & preswf[None, :]        # [E, B]
    flat_sig = signal.reshape(N, T)
    flat_present = present.reshape(N)
    if batch.minsignal is not None:
        # the decoder's per-block minimum honors nsamp < ntime (short blocks
        # must not pull the baseline down to the zero padding, ref :854-889)
        minsignal = batch.minsignal.astype(dtype).reshape(N)
    else:
        minsignal = jnp.min(flat_sig, axis=1)                  # nsamp == T

    kern_flat = jnp.broadcast_to(kern[None], (E, B, cfg.mfwidth)).reshape(N, -1)
    mfint = calib["mfint"].astype(dtype)
    mfint_flat = jnp.broadcast_to(mfint[None], (E, B)).reshape(N)

    # ---- peak search -------------------------------------------------
    # Optionally compacted to the present lanes: production events light up
    # ~1-3% of the calorimeter, and the reference only loops over
    # pres && preswf blocks (ref :944); searching absent lanes is masked
    # dead work under XLA unless they are gathered away.
    cap_s = min(cfg.search_capacity, N) if cfg.search_capacity > 0 else 0
    n_search_dropped = jnp.asarray(0, jnp.int32)
    search_overflow = jnp.zeros((N,), bool)
    if 0 < cap_s < N:
        sel_s = jnp.argsort(~flat_present, stable=True)[:cap_s]
        ps_c = find_pulses(cfg, flat_sig[sel_s], minsignal[sel_s],
                           kern_flat[sel_s], mfint_flat[sel_s],
                           flat_present[sel_s])
        # un-permute by gather (closed-form stable-argsort position), not
        # by [N, P] scatters — see the fit-bucket un-permute below
        nm_s = jnp.sum(flat_present).astype(jnp.int32)
        pos_s = jnp.where(
            flat_present, jnp.cumsum(flat_present.astype(jnp.int32)) - 1,
            nm_s + jnp.cumsum((~flat_present).astype(jnp.int32)) - 1)
        searched = flat_present & (pos_s < cap_s)
        posc_s = jnp.minimum(pos_s, cap_s - 1)
        npulse = jnp.where(searched, jnp.take(ps_c.npulse, posc_s), 0)
        seed_t_abs = jnp.where(searched[:, None],
                               jnp.take(ps_c.times, posc_s, axis=0), 0.0)
        seed_a = jnp.where(searched[:, None],
                           jnp.take(ps_c.amps, posc_s, axis=0), 0.0)
        pulse_mask = jnp.take(ps_c.valid, posc_s, axis=0) & searched[:, None]
        # present lanes that did not get a search slot are flagged, so they
        # are distinguishable from genuinely empty blocks downstream
        search_overflow = flat_present & ~searched
        n_search_dropped = jnp.sum(search_overflow).astype(jnp.int32)
    else:
        ps = find_pulses(cfg, flat_sig, minsignal, kern_flat, mfint_flat,
                         flat_present)
        npulse = ps.npulse                                      # [N]
        seed_t_abs = ps.times                                   # [N, P] bins
        seed_a = ps.amps
        pulse_mask = ps.valid

    # ---- cluster gate ------------------------------------------------
    gate = cluster_gate(cfg, signal, timeref, timerefacc,
                        block_axis, block_shards).reshape(N)
    fit_active = flat_present & gate & (npulse > 0)

    # ---- fit-lane compaction + pulse-count bucketing ------------------
    # Lanes are compacted to a static capacity, and split by pulse count:
    # the overwhelming majority of blocks carry <= fit_small_pulses pulses
    # (ref README.md:129 quality figure), so they fit with a narrow
    # 1+2*Ps parameter vector (smaller Jacobians, 5x5 instead of 25x25
    # normal equations); rare high-pileup lanes go through the wide bucket.
    M = 1 + 2 * P
    Ps = max(1, min(cfg.fit_small_pulses, P))
    cap_all = min(cfg.fit_capacity if cfg.fit_capacity > 0 else N, N)
    small_active = fit_active & (npulse <= Ps)
    big_active = fit_active & (npulse > Ps)
    blocks_flat = jnp.tile(jnp.arange(B), E)
    ped_seed_all = jnp.mean(flat_sig[:, :cfg.ped_nsamples], axis=1)  # ref :672-676

    params = jnp.zeros((N, M), dtype)
    chi2_ndf = jnp.zeros((N,), dtype)
    converged = jnp.zeros((N,), bool)
    n_iter_lanes = jnp.zeros((N,), jnp.int32)
    fitted = jnp.zeros((N,), bool)
    n_dropped = jnp.asarray(0, jnp.int32)
    buckets = [(small_active, cap_all, Ps)]
    if P > Ps:
        if cfg.fit_capacity <= 0:
            # fit_capacity == 0 means "fit every block" (the reference fits
            # every gate-passed block unconditionally, ref :942-1020) — the
            # wide bucket must be uncapped too, or an extreme-pileup batch
            # would drop lanes the contract promises to fit
            cap_big = N
        else:
            cap_big = max(min(N, 256), cap_all // max(cfg.fit_big_frac, 1))
        # middle bucket: moderate-pileup lanes (Ps < npulse <= fit_mid_pulses)
        # fit with a medium parameter vector (M=9 at fit_mid_pulses = 4)
        # instead of the full 25-wide system. Bucket routing stays
        # result-neutral (padded params, per-lane budgets keyed on the
        # lane's own pulse count). Empty buckets cond-skip.
        Pm = min(cfg.fit_mid_pulses, P)
        if Pm > Ps:
            mid_active = big_active & (npulse <= Pm)
            big_active = big_active & (npulse > Pm)
            buckets.append((mid_active, cap_big, Pm))
        buckets.append((big_active, cap_big, P))
    model_name = cfg.model_name
    for mask, cap_b, Pb in buckets:
        one_chunk = cfg.fit_chunk <= 0 or cap_b <= cfg.fit_chunk

        def _build_inputs(sel_blocks, sel_sig, take, _Pb=Pb):
            sel_err = error_model(cfg, sel_sig)
            return FitInputs(
                y=sel_sig[:, cfg.fit_lo_bin:cfg.fit_hi_bin],
                sigma=sel_err[:, cfg.fit_lo_bin:cfg.fit_hi_bin],
                coeffs=coeffs[sel_blocks],
                x0=x0[sel_blocks],
                t_seed=take(seed_t_abs)[:, :_Pb]
                - timeref[sel_blocks][:, None],                        # ref :662
                a_seed=take(seed_a)[:, :_Pb],
                ped_seed=take(ped_seed_all),
                pulse_mask=take(pulse_mask)[:, :_Pb],
                active=take(mask),
                timeref=timeref[sel_blocks])

        # An all-inactive bucket must cost nothing at runtime: lax.cond
        # executes only the taken branch, and the compaction gathers
        # ([cap, T] signal, [cap, S, 4] spline coefficients — the expensive
        # part when the wide bucket is uncapped) sit INSIDE the cond, so an
        # empty bucket pays only the [N] argsort. Inactive-lane outputs are
        # never read (masked by `infit` below), so the skip branch returns
        # zeros (derived from its operand so the branch output carries the
        # same shard_map varying-axes type as the real fit branch).
        if cap_b >= N and one_chunk:
            # capacity covers every lane and the solver runs it as a single
            # chunk: the compaction permutation would be pure overhead (full
            # argsort + gathers of [N, T] / [N, S, 4]), so fit all lanes in
            # place with the bucket mask as `active`. (Under lax.map chunking
            # compaction stays worthwhile — front-packing lets all-inactive
            # trailing chunks exit their while_loops immediately, the big win
            # at sparse occupancy.)
            sel = None

            def _run_fit(m, _Pb=Pb):
                inp = _build_inputs(blocks_flat, flat_sig, lambda a: a)
                return _fit_chunked(cfg, inp, model_name)

            def _skip_fit(m, _Pb=Pb):
                Mb = 1 + 2 * _Pb
                z = m.astype(dtype) * 0.0
                return FitResult(
                    params=z[:, None] + jnp.zeros((1, Mb), dtype), chi2=z,
                    chi2_ndf=z, converged=z > 1.0, converged_stage1=z > 1.0,
                    n_iter=z.astype(jnp.int32), edm=z)

            fres = jax.lax.cond(jnp.any(mask), _run_fit, _skip_fit, mask)
        else:
            sel = jnp.argsort(~mask, stable=True)[:cap_b]

            def _run_fit(s, _Pb=Pb):
                inp = _build_inputs(blocks_flat[s], _gather_lanes(flat_sig, s),
                                    lambda a, s=s: _gather_lanes(a, s))
                return _fit_chunked(cfg, inp, model_name)

            def _skip_fit(s, _Pb=Pb):
                Mb = 1 + 2 * _Pb
                z = s.astype(dtype) * 0.0
                return FitResult(
                    params=z[:, None] + jnp.zeros((1, Mb), dtype), chi2=z,
                    chi2_ndf=z, converged=z > 1.0, converged_stage1=z > 1.0,
                    n_iter=z.astype(jnp.int32), edm=z)

            fres = jax.lax.cond(jnp.any(mask), _run_fit, _skip_fit, sel)
        pf = jnp.concatenate(
            [fres.params,
             jnp.zeros((fres.params.shape[0], 2 * (P - Pb)), dtype)], axis=1)
        if sel is None:
            infit = mask
            params = jnp.where(infit[:, None], pf, params)
            chi2_ndf = jnp.where(infit, fres.chi2_ndf, chi2_ndf)
            converged = converged | (fres.converged & infit)
            n_iter_lanes = jnp.where(infit, fres.n_iter, n_iter_lanes)
        else:
            # un-permute by GATHER, not scatter: lane i's slot in the
            # stable argsort(~mask) compaction has the closed form
            # pos[i] = cumsum(mask)-1 (masked) / n_masked + cumsum(~mask)-1
            # (unmasked), so fres rows come back with one [N] take per
            # output instead of an [N, M] scatter chain
            nm = jnp.sum(mask).astype(jnp.int32)
            pos = jnp.where(
                mask, jnp.cumsum(mask.astype(jnp.int32)) - 1,
                nm + jnp.cumsum((~mask).astype(jnp.int32)) - 1)
            infit = mask & (pos < cap_b)
            posc = jnp.minimum(pos, cap_b - 1)
            params = jnp.where(infit[:, None],
                               jnp.take(pf, posc, axis=0), params)
            chi2_ndf = jnp.where(infit, jnp.take(fres.chi2_ndf, posc),
                                 chi2_ndf)
            converged = converged | (jnp.take(fres.converged, posc) & infit)
            n_iter_lanes = jnp.where(infit, jnp.take(fres.n_iter, posc),
                                     n_iter_lanes)
        fitted = fitted | infit
        n_dropped = n_dropped + jnp.maximum(
            jnp.sum(mask) - cap_b, 0).astype(jnp.int32)

    # ---- output-path resolution --------------------------------------
    cortime_b = cortime[blocks_flat]                            # [N]
    corr = jnp.repeat(batch.corr_time_HMS.astype(dtype), B)     # [N]
    t_param = params[:, 1::2]                                   # [N, P] rel bins
    a_param = params[:, 2::2]
    seed_t_rel = seed_t_abs - timeref[blocks_flat][:, None]

    # fitted lanes carry solver params (seed fallback applied inside the
    # solver for failed lanes); non-fitted keep raw seeds
    t_rel = jnp.where(fitted[:, None], t_param, seed_t_rel)
    a_fin = jnp.where((fitted & converged)[:, None], a_param, seed_a)

    # fitted pedestal (solver p0, = seed on unfitted/failed lanes) — one
    # [E, B] column so the diagnostics plotter can replay the exact curve
    pedwf = jnp.where(fitted, params[:, 0], ped_seed_all)

    conv_term = (corr - cortime_b - timerefacc * cfg.dt)[:, None]
    t_ns = t_rel * cfg.dt + conv_term                           # ref :782-785, :812-815
    # gate-fail lanes keep raw bin-unit times (no conversion, ref :962-986);
    # slots beyond npulse are zeroed — they are never written out, and
    # leaving solver/seed garbage there would make outputs depend on the
    # (result-neutral) bucket routing
    wftime = jnp.where(pulse_mask,
                       jnp.where(fitted[:, None], t_ns, seed_t_abs), 0.0)
    wfampl = jnp.where(pulse_mask, a_fin, 0.0)
    chi2 = jnp.where(fitted & converged, chi2_ndf, -100.0).astype(dtype)

    # timewf/amplwf: |time| closest to zero among valid pulses, first on tie
    big = jnp.asarray(jnp.inf, dtype)
    abs_t = jnp.where(pulse_mask, jnp.abs(wftime), big)
    best = jnp.argmin(abs_t, axis=1)                            # first-min (ref :1009-1016)
    has = fitted & (npulse > 0)
    timewf = jnp.where(has, jnp.take_along_axis(wftime, best[:, None], axis=1)[:, 0], -100.0)
    amplwf = jnp.where(has, jnp.take_along_axis(wfampl, best[:, None], axis=1)[:, 0], -100.0)

    # h1/h2 entries (ref :988-997): gate-passed lanes, final amplitude > 20
    h_mask = fitted[:, None] & pulse_mask & (wfampl > cfg.amp_h12_thres)
    h1 = t_rel - timerefacc + corr[:, None] / cfg.dt            # ref :994
    h2 = wftime

    diag = block_diagnostics(cfg, signal)
    enertot, integtot = diag["enertot"], diag["integtot"]
    if block_axis is not None:
        # event totals span all blocks: reduce partial sums across row shards
        # (also needed for size-1 block axes so shard_map can infer replication)
        enertot = jax.lax.psum(enertot, block_axis)
        integtot = jax.lax.psum(integtot, block_axis)

    n_succ = jnp.sum(fitted & converged).astype(jnp.int32)
    n_fail = jnp.sum(fitted & ~converged).astype(jnp.int32)
    n_high = jnp.sum(flat_present & (npulse > P - 2)).astype(jnp.int32)
    for ax in reduce_axes:
        n_succ = jax.lax.psum(n_succ, ax)
        n_fail = jax.lax.psum(n_fail, ax)
        n_dropped = jax.lax.psum(n_dropped, ax)
        n_high = jax.lax.psum(n_high, ax)
        n_search_dropped = jax.lax.psum(n_search_dropped, ax)

    return PipelineOutput(
        wfnpulse=npulse.reshape(E, B),
        wftime=wftime.reshape(E, B, P),
        wfampl=wfampl.reshape(E, B, P),
        pulse_valid=pulse_mask.reshape(E, B, P),
        chi2=chi2.reshape(E, B),
        timewf=timewf.reshape(E, B),
        amplwf=amplwf.reshape(E, B),
        pedwf=pedwf.reshape(E, B),
        gate=gate.reshape(E, B),
        fit_converged=(fitted & converged).reshape(E, B),
        fit_n_iter=jnp.where(fitted, n_iter_lanes, 0).reshape(E, B),
        h1time=h1.reshape(E, B, P),
        h2time=h2.reshape(E, B, P),
        h_mask=h_mask.reshape(E, B, P),
        ampl=diag["ampl"], ener=diag["ener"], integ=diag["integ"],
        bkg=diag["bkg"], noise=diag["noise"],
        enertot=enertot, integtot=integtot,
        n_fit_success=n_succ,
        n_fit_failure=n_fail,
        n_fit_dropped=n_dropped,
        n_high_pulse=n_high,
        n_search_dropped=n_search_dropped,
        search_overflow=search_overflow.reshape(E, B))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _process_batch_jit(cfg: NPSConfig, calib: Dict[str, jnp.ndarray],
                       batch: EventBatch) -> PipelineOutput:
    return process_batch(cfg, calib, batch)


# ----------------------------------------------------------------------
# Device-side writer packet (downlink compaction)
# ----------------------------------------------------------------------
class WriterPacket(NamedTuple):
    """The minimal device->host payload the WF writer needs.

    PipelineOutput is ~18 MB/64-event batch, dominated by the dense
    [E, B, P] pulse tensors that the writer immediately ragged-flattens
    and by diagnostics-only fields it never reads. Packing on device cuts
    the downlink ~4x — decisive when host<->device bandwidth is the
    end-to-end bottleneck (PERF.md, end-to-end section). The ragged
    flatten (event->block->slot order, identical to
    ``writer.flatten_pulses_np``) happens on device into fixed-capacity
    buffers; ``n_wf``/``n_h`` report the true totals so the executor can
    fall back to the full output in the (pathological) overflow case.
    """
    wfnpulse: jnp.ndarray       # [E, B] i32
    wf_counts_e: jnp.ndarray    # [E] i32 — pulses per event
    wftime_flat: jnp.ndarray    # [cap]
    wfampl_flat: jnp.ndarray    # [cap]
    n_wf: jnp.ndarray           # [] i32 — true total (may exceed cap)
    h_counts_e: jnp.ndarray     # [E] i32 — h1/h2 entries per event
    h1time_flat: jnp.ndarray    # [cap]
    h2time_flat: jnp.ndarray    # [cap]
    n_h: jnp.ndarray            # [] i32
    chi2: jnp.ndarray           # [E, B]
    ampl: jnp.ndarray           # [E, B]
    amplwf: jnp.ndarray         # [E, B]
    timewf: jnp.ndarray         # [E, B]
    pedwf: jnp.ndarray          # [E, B]
    enertot: jnp.ndarray        # [E]
    integtot: jnp.ndarray       # [E]
    search_overflow: jnp.ndarray  # [E, B] bool
    n_fit_success: jnp.ndarray
    n_fit_failure: jnp.ndarray
    n_fit_dropped: jnp.ndarray
    n_high_pulse: jnp.ndarray
    n_search_dropped: jnp.ndarray


def _ragged_flatten_device(mask, arrays, cap: int):
    """Compact ``arrays[mask]`` (row-major) into [cap] buffers + true count.

    One stable multi-operand ``lax.sort`` keyed on ``~mask`` front-packs
    the masked elements in original (row-major) order; the outputs are its
    first ``cap`` slots (no scatter)."""
    v = mask.reshape(-1)
    ops = ((~v).astype(jnp.int32),) + tuple(
        jnp.where(v, a.reshape(-1), jnp.zeros((), a.dtype)) for a in arrays)
    srt = jax.lax.sort(ops, dimension=0, num_keys=1, is_stable=True)
    return tuple(s[:cap] for s in srt[1:]), jnp.sum(v.astype(jnp.int32))


def pack_for_writer(out: PipelineOutput, cap: int) -> WriterPacket:
    E, B, P = out.wftime.shape
    prefix = (jnp.arange(P, dtype=jnp.int32)[None, None, :]
              < out.wfnpulse[:, :, None])
    (wt, wa), n_wf = _ragged_flatten_device(
        prefix, (out.wftime, out.wfampl), cap)
    (h1f, h2f), n_h = _ragged_flatten_device(
        out.h_mask, (out.h1time, out.h2time), cap)
    return WriterPacket(
        wfnpulse=out.wfnpulse,
        wf_counts_e=jnp.sum(out.wfnpulse, axis=1, dtype=jnp.int32),
        wftime_flat=wt, wfampl_flat=wa, n_wf=n_wf,
        h_counts_e=jnp.sum(out.h_mask, axis=(1, 2), dtype=jnp.int32),
        h1time_flat=h1f, h2time_flat=h2f, n_h=n_h,
        chi2=out.chi2, ampl=out.ampl, amplwf=out.amplwf,
        timewf=out.timewf, pedwf=out.pedwf,
        enertot=out.enertot, integtot=out.integtot,
        search_overflow=out.search_overflow,
        n_fit_success=out.n_fit_success, n_fit_failure=out.n_fit_failure,
        n_fit_dropped=out.n_fit_dropped, n_high_pulse=out.n_high_pulse,
        n_search_dropped=out.n_search_dropped)


@functools.partial(jax.jit, static_argnames=("cap",))
def _pack_jit(out: PipelineOutput, cap: int) -> WriterPacket:
    return pack_for_writer(out, cap)


def make_writer_pack(cap: int):
    """jitted device-side packer with static flat-buffer capacity."""
    return functools.partial(_pack_jit, cap=cap)


# ----------------------------------------------------------------------
# Single-buffer packet serialization (one D2H transfer per batch)
# ----------------------------------------------------------------------
# Every fetched array pays a per-transfer latency; a WriterPacket is 22
# arrays. Serializing it into ONE f32 buffer on device makes the whole
# downlink a single transfer. Every field is exactly representable in f32:
# pulse counts <= 12, flat counts < 2^24, bools, and the f32 pipeline
# outputs themselves.

# the per-lane [E, B] packet fields, in order (subject to lane compaction)
_LANE_FIELDS = ("wfnpulse", "chi2", "ampl", "amplwf", "timewf", "pedwf",
                "search_overflow")


def _packet_layout(E: int, B: int, cap: int):
    """[(field, shape, dtype)] in dense serialization order (the sparse
    slab layout lives in ``_slab_layout``; its lane compaction uses the
    row-major order of the decoder's ``pres`` mask, which BOTH sides know,
    plus one default value per lane field — every absent lane produces
    identical outputs from its zero-filled signal)."""
    i32, f32, bl = jnp.int32, None, bool
    lane_shape = (E, B)
    lane_dt = {"wfnpulse": i32, "search_overflow": bl}
    layout = [
        ("wfnpulse", lane_shape, i32), ("wf_counts_e", (E,), i32),
        ("wftime_flat", (cap,), f32), ("wfampl_flat", (cap,), f32),
        ("n_wf", (), i32), ("h_counts_e", (E,), i32),
        ("h1time_flat", (cap,), f32), ("h2time_flat", (cap,), f32),
        ("n_h", (), i32), ("chi2", lane_shape, f32),
        ("ampl", lane_shape, f32),
        ("amplwf", lane_shape, f32), ("timewf", lane_shape, f32),
        ("pedwf", lane_shape, f32), ("enertot", (E,), f32),
        ("integtot", (E,), f32), ("search_overflow", lane_shape, bl),
        ("n_fit_success", (), i32), ("n_fit_failure", (), i32),
        ("n_fit_dropped", (), i32), ("n_high_pulse", (), i32),
        ("n_search_dropped", (), i32),
    ]
    return layout


def flatten_packet(pkt: WriterPacket) -> jnp.ndarray:
    """Serialize (on device) to one [total] f32 vector."""
    parts = [jnp.ravel(getattr(pkt, name)).astype(jnp.float32)
             for name, _, _ in _packet_layout(*pkt.wfnpulse.shape,
                                              pkt.wftime_flat.shape[0])]
    return jnp.concatenate(parts)


# ---- slab packet (sparse readout, round 4) ---------------------------
# The device-side ragged flattens (_ragged_flatten_device) cost two
# full-width [E*B*P] multi-operand sorts.
# In sparse mode the pulse-bearing lanes are few, so instead of
# flattening on device, the packet ships per-lane SLABS ([lane_cap, P]
# rows in row-major present order, one [E*B]-argsort + gathers) and the
# HOST reconstructs the exact ragged arrays (prefix masks over the
# reconstructed dense slabs — numpy boolean indexing, microseconds at
# production occupancy). Element capacity disappears entirely: only lane
# overflow (occupancy burst beyond lane_cap) forces the dense fallback.

_SLAB_FIELDS = ("wftime", "wfampl", "h1time", "h2time")


def _slab_layout(E: int, B: int, P: int, lane_cap: int):
    """[(field, shape, dtype)] for the slab packet serialization."""
    i32, f32, bl = jnp.int32, None, bool
    lane_dt = {"wfnpulse": i32, "search_overflow": bl}
    layout = [
        ("wfnpulse", (lane_cap,), i32), ("wf_counts_e", (E,), i32),
        ("wftime_slab", (lane_cap, P), f32),
        ("wfampl_slab", (lane_cap, P), f32),
        ("h1_slab", (lane_cap, P), f32),
        ("h2_slab", (lane_cap, P), f32),
        ("hmask_slab", (lane_cap, P), bl),
        ("h_counts_e", (E,), i32),
        ("chi2", (lane_cap,), f32), ("ampl", (lane_cap,), f32),
        ("amplwf", (lane_cap,), f32), ("timewf", (lane_cap,), f32),
        ("pedwf", (lane_cap,), f32),
        ("enertot", (E,), f32), ("integtot", (E,), f32),
        ("search_overflow", (lane_cap,), bl),
        ("n_fit_success", (), i32), ("n_fit_failure", (), i32),
        ("n_fit_dropped", (), i32), ("n_high_pulse", (), i32),
        ("n_search_dropped", (), i32),
    ]
    layout += [(f"default_{f}", (), lane_dt.get(f)) for f in _LANE_FIELDS]
    layout.append(("n_pres", (), i32))
    return layout


def flatten_packet_slab(out: PipelineOutput, pres: jnp.ndarray,
                        lane_cap: int) -> jnp.ndarray:
    """Serialize a PipelineOutput directly to one [total] f32 slab packet.

    ``pres`` is the decoder's present mask (EventBatch.pres as uploaded).
    No device-side ragged flatten happens; see _slab_layout."""
    E, B, P = out.wftime.shape
    v = pres.reshape(-1).astype(bool)
    sel = jnp.argsort(~v, stable=True)[:lane_cap]     # row-major pres first
    idx_abs = jnp.argmin(v)                           # first absent lane
    lane2d = {"wftime_slab": out.wftime, "wfampl_slab": out.wfampl,
              "h1_slab": out.h1time, "h2_slab": out.h2time,
              "hmask_slab": out.h_mask}
    derived = {
        "wf_counts_e": jnp.sum(out.wfnpulse, axis=1, dtype=jnp.int32),
        "h_counts_e": jnp.sum(out.h_mask, axis=(1, 2), dtype=jnp.int32),
        "n_pres": jnp.sum(v.astype(jnp.int32)),
    }
    parts = []
    for name, shape, _ in _slab_layout(E, B, P, lane_cap):
        if name in lane2d:
            val = lane2d[name].reshape(E * B, P)[sel]
        elif name in derived:
            val = derived[name]
        elif name.startswith("default_"):
            val = getattr(out, name[len("default_"):]).reshape(-1)[idx_abs]
        elif name in _LANE_FIELDS:
            val = getattr(out, name).reshape(-1)[sel]
        else:
            val = getattr(out, name)
        parts.append(jnp.ravel(val).astype(jnp.float32))
    return jnp.concatenate(parts)


def unflatten_packet_slab(buf, E: int, B: int, P: int, lane_cap: int,
                          pres) -> Tuple[WriterPacket, bool]:
    """Host-side inverse of ``flatten_packet_slab``: rebuilds the exact
    WriterPacket (including the ragged wftime/wfampl/h1/h2 flats the
    writer consumes, in the same row-major element order the device
    flatten produced). Returns (packet, lane_overflow)."""
    import numpy as np
    buf = np.asarray(buf)
    fields = {}
    off = 0
    for name, shape, dt in _slab_layout(E, B, P, lane_cap):
        n = 1
        for s in shape:
            n *= s
        val = buf[off:off + n].reshape(shape)
        if dt is not None:
            val = val.astype(dt if dt is bool else np.int32)
        fields[name] = val if shape else val[()]
        off += n
    n_pres = int(fields.pop("n_pres"))
    rows = np.flatnonzero(np.asarray(pres).astype(bool).reshape(-1))
    overflow = n_pres > lane_cap
    nr = min(rows.size, lane_cap)

    def dense_lane(f):
        default = fields.pop(f"default_{f}")
        vals = np.asarray(fields.pop(f))
        dense = np.full(E * B, default, vals.dtype)
        if not overflow:
            dense[rows] = vals[:nr]
        return dense

    wfnpulse = dense_lane("wfnpulse")
    lane_fields = {f: dense_lane(f).reshape(E, B)
                   for f in _LANE_FIELDS if f != "wfnpulse"}

    def dense_slab(name, dtype):
        slab = fields.pop(name)
        dense = np.zeros((E * B, P), dtype)
        if not overflow:
            dense[rows] = slab[:nr].astype(dtype)
        return dense

    wt = dense_slab("wftime_slab", np.float32)
    wa = dense_slab("wfampl_slab", np.float32)
    h1 = dense_slab("h1_slab", np.float32)
    h2 = dense_slab("h2_slab", np.float32)
    hm = dense_slab("hmask_slab", bool)
    prefix = np.arange(P)[None, :] < wfnpulse[:, None]
    pkt = WriterPacket(
        wfnpulse=wfnpulse.reshape(E, B),
        wf_counts_e=fields["wf_counts_e"],
        wftime_flat=wt[prefix], wfampl_flat=wa[prefix],
        n_wf=int(prefix.sum()),
        h_counts_e=fields["h_counts_e"],
        h1time_flat=h1[hm], h2time_flat=h2[hm], n_h=int(hm.sum()),
        chi2=lane_fields["chi2"], ampl=lane_fields["ampl"],
        amplwf=lane_fields["amplwf"], timewf=lane_fields["timewf"],
        pedwf=lane_fields["pedwf"],
        enertot=fields["enertot"], integtot=fields["integtot"],
        search_overflow=lane_fields["search_overflow"],
        n_fit_success=fields["n_fit_success"],
        n_fit_failure=fields["n_fit_failure"],
        n_fit_dropped=fields["n_fit_dropped"],
        n_high_pulse=fields["n_high_pulse"],
        n_search_dropped=fields["n_search_dropped"])
    return pkt, overflow


def unflatten_packet(buf, E: int, B: int, cap: int,
                     pres=None, lane_cap: int = 0, P: int = 0):
    """Host-side inverse of the packet serializations (numpy in/out).

    ``lane_cap`` == 0: inverse of ``flatten_packet`` (dense mode).
    ``lane_cap`` > 0: inverse of ``flatten_packet_slab`` — the caller
    passes the decoded ``pres`` [E, B] host mask and ``P``
    (cfg.maxwfpulses); the ragged flats are rebuilt host-side.

    Returns ``(packet, lane_overflow)``: ``lane_overflow`` is True when
    the batch had more present lanes than ``lane_cap`` (the packet is
    then unusable — the executor falls back to the dense fetch of the
    full PipelineOutput)."""
    if lane_cap > 0:
        return unflatten_packet_slab(buf, E, B, P, lane_cap, pres)
    import numpy as np
    buf = np.asarray(buf)
    fields = {}
    off = 0
    for name, shape, dt in _packet_layout(E, B, cap):
        n = 1
        for s in shape:
            n *= s
        v = buf[off:off + n].reshape(shape)
        if dt is not None:
            v = v.astype(dt if dt is bool else np.int32)
        fields[name] = v if shape else v[()]
        off += n
    return WriterPacket(**fields), False


@functools.partial(jax.jit, static_argnames=("cfg", "cap", "lane_cap"))
def _packed_jit(cfg: NPSConfig, calib: Dict[str, jnp.ndarray],
                batch: EventBatch, cap: int, lane_cap: int = 0):
    out = process_batch(cfg, calib, batch)
    if lane_cap > 0:
        # slab mode: no device-side ragged flatten at all (the two
        # full-width sorts were ~30 ms/batch — PERF.md round 4)
        return flatten_packet_slab(out, batch.pres, lane_cap)
    return flatten_packet(pack_for_writer(out, cap))


def make_pipeline_packed(cfg: NPSConfig, calib: Dict[str, jnp.ndarray],
                         cap: int, lane_cap: int = 0):
    """One jit: process_batch + writer packing + single-buffer serialization.

    Returns ``fn(batch) -> flat_packet [total] f32`` — ONE device output
    buffer, fetched in one transfer (the full PipelineOutput would be ~25
    more output buffers per batch); callers needing the dense output for the
    rare capacity-overflow fallback re-run the batch through
    ``make_pipeline`` instead (costs one extra batch, only on overflow).
    With ``lane_cap`` > 0 the [E, B] lane fields ride present-lane
    compacted (sparse readout: the downlink shrinks ~7x at production
    occupancy). Jit-cached process-wide on (cfg, shapes, caps) like
    ``make_pipeline``.
    """
    return functools.partial(_packed_jit, cfg, calib, cap=cap,
                             lane_cap=lane_cap)


# ----------------------------------------------------------------------
# Chained dispatch: k batches per jit call
# ----------------------------------------------------------------------
# Scanning k batches inside ONE executable amortizes the per-dispatch and
# per-fetch fixed cost k-fold: the executor uploads k decoded batches,
# dispatches once, and fetches one stacked result. Whether that gains
# anything on a locally attached GPU is an open A/B (k=1 vs k=8). Results
# are bit-identical to k separate dispatches (the scan body IS
# process_batch; lane results never depend on batch neighbors).

@functools.partial(jax.jit, static_argnames=("cfg",))
def _process_chain_jit(cfg: NPSConfig, calib: Dict[str, jnp.ndarray],
                       batch_stack: EventBatch) -> PipelineOutput:
    def body(carry, b):
        return carry, process_batch(cfg, calib, b)

    _, outs = jax.lax.scan(body, 0, batch_stack)
    return outs


def make_pipeline_chain(cfg: NPSConfig, calib: Dict[str, jnp.ndarray]):
    """jit pipeline over a stacked EventBatch (leading k axis on every
    field); returns a PipelineOutput with a leading k axis."""
    return functools.partial(_process_chain_jit, cfg, calib)


@functools.partial(jax.jit, static_argnames=("cfg", "cap", "lane_cap"))
def _packed_chain_jit(cfg: NPSConfig, calib: Dict[str, jnp.ndarray],
                      batch_stack: EventBatch, cap: int, lane_cap: int = 0):
    def body(carry, b):
        out = process_batch(cfg, calib, b)
        if lane_cap > 0:
            return carry, flatten_packet_slab(out, b.pres, lane_cap)
        return carry, flatten_packet(pack_for_writer(out, cap))

    _, flats = jax.lax.scan(body, 0, batch_stack)
    return flats                                    # [k, total]


def make_pipeline_packed_chain(cfg: NPSConfig, calib: Dict[str, jnp.ndarray],
                               cap: int, lane_cap: int = 0):
    """Chained variant of make_pipeline_packed: k batches -> one [k, total]
    packet stack, ONE dispatch + ONE fetch for the whole chain."""
    return functools.partial(_packed_chain_jit, cfg, calib, cap=cap,
                             lane_cap=lane_cap)


def stack_event_batches(batches) -> EventBatch:
    """Stack device EventBatches along a new leading axis (scan operand)."""
    if batches[0].minsignal is None:
        assert all(b.minsignal is None for b in batches)
        parts = [jnp.stack([getattr(b, f) for b in batches])
                 for f in ("signal", "pres", "corr_time_HMS", "evt", "runnum")]
        return EventBatch(*parts, minsignal=None)
    return jax.tree.map(lambda *xs: jnp.stack(xs), *batches)


def make_pipeline(cfg: NPSConfig, calib: Dict[str, jnp.ndarray],
                  donate: bool = False):
    """jit-compiled pipeline closure over static config + calibration.

    Compilation is cached process-wide on (config, shapes): NPSConfig is a
    frozen dataclass and participates in the jit cache key as a static
    argument, so repeated make_pipeline calls reuse the same executable.
    """
    del donate  # calibration is shared across batches; nothing safe to donate
    return functools.partial(_process_batch_jit, cfg, calib)
