"""Batched bounded Levenberg-Marquardt solver.

Batched replacement for the per-block ROOT::Fit::Fitter + Minuit2 Migrad
minimization (ref TEST_2.C:691-791). All (event x block) fit lanes are solved
simultaneously as one fixed-shape computation:

- objective: binned chi^2 over bins [fit_lo_bin, fit_hi_bin) with the
  reference's Poisson-ish error model (ref :680-688, 946-955),
- box constraints via the Minuit-style sin transform
  p = mid + half*sin(u) (Migrad's internal bounded-parameter mapping), so the
  internal problem is unconstrained,
- normal-equation LM steps with Marquardt damping and Jacobi scaling, run
  under ``lax.while_loop`` until every active lane converges or the iteration
  budget is spent,
- two-stage retry escalation: lanes that fail stage 1 are re-solved from the
  original seeds with a bigger budget (Migrad strategy 1/1000 -> 2/5000,
  ref :701-703, 765-767); still-failed lanes keep their seed parameters and
  are flagged (chi2 = -100 fallback applied by the engine, ref :774-791).

Parameters are laid out as the reference's TF1 vector:
p = [pedestal, t_0, A_0, t_1, A_1, ...], padded to 1 + 2*maxwfpulses with
masked slots (ref TEST_2.C:361, 656-677).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from npswf.core.config import NPSConfig
from npswf.fit.linalg import cholesky_solve
from npswf.models.waveform import WaveformModel, get_model


class FitInputs(NamedTuple):
    y: jnp.ndarray            # [N, K] data in the fit window
    sigma: jnp.ndarray        # [N, K] errors (err model applied upstream)
    coeffs: jnp.ndarray       # [N, S, 4] per-lane spline coefficients
    x0: jnp.ndarray           # [N] spline first knot
    t_seed: jnp.ndarray       # [N, P] seed times (relative to timeref)
    a_seed: jnp.ndarray       # [N, P] seed amplitudes
    ped_seed: jnp.ndarray     # [N] pedestal seed (mean of first 20 samples)
    pulse_mask: jnp.ndarray   # [N, P] bool — pulse slot active
    active: jnp.ndarray       # [N] bool — lane has >=1 pulse and passed gates
    # [N] block reference time (optional): time parameters are relative to it
    # (ref :662); models needing the absolute frame (e.g. gaussian) read it
    # as aux["timeref"]. None => zeros (absolute-frame fits).
    timeref: Optional[jnp.ndarray] = None


class FitResult(NamedTuple):
    params: jnp.ndarray       # [N, M] fitted physical parameters
    chi2: jnp.ndarray         # [N] total chi^2 (not yet / ndf)
    chi2_ndf: jnp.ndarray     # [N] chi^2 / ndf
    converged: jnp.ndarray    # [N] bool — fit succeeded (possibly on retry)
    converged_stage1: jnp.ndarray  # [N] bool — succeeded without retry
    n_iter: jnp.ndarray       # [N] iterations consumed
    edm: jnp.ndarray          # [N] final expected-distance-to-minimum proxy


# ----------------------------------------------------------------------
# Bound transform (Minuit-style)
# ----------------------------------------------------------------------
def _interleave(first: jnp.ndarray, t: jnp.ndarray, a: jnp.ndarray) -> jnp.ndarray:
    """[N],[N,P],[N,P] -> [N, 1+2P] in the reference's (ped, t0, A0, ...)
    layout, built with stack+reshape (no strided scatter)."""
    inter = jnp.stack([t, a], axis=-1).reshape(t.shape[0], -1)
    return jnp.concatenate([first[:, None], inter], axis=1)


def _bounds(cfg: NPSConfig, inp: FitInputs) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(lo, hi) [N, M] in the reference's layout (ref TEST_2.C:664-670)."""
    N, P = inp.t_seed.shape
    dt_lim = jnp.asarray(cfg.time_limit, inp.y.dtype)
    a_lo = inp.a_seed * cfg.amp_lo_frac
    a_hi = inp.a_seed * cfg.amp_hi_frac
    ped = jnp.full((N,), cfg.ped_limit, inp.y.dtype)
    # negative-amplitude seeds cannot occur (|raw - min|), but keep lo<=hi
    lo = _interleave(-ped, inp.t_seed - dt_lim, jnp.minimum(a_lo, a_hi))
    hi = _interleave(ped, inp.t_seed + dt_lim, jnp.maximum(a_lo, a_hi))
    return lo, hi


def _seed_params(cfg: NPSConfig, inp: FitInputs) -> jnp.ndarray:
    return _interleave(jnp.clip(inp.ped_seed, -cfg.ped_limit, cfg.ped_limit),
                       inp.t_seed, inp.a_seed)


def _to_internal(p, lo, hi, param_mask):
    mid = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    safe_half = jnp.where(half > 0, half, 1.0)
    s = jnp.clip((p - mid) / safe_half, -1.0, 1.0)
    u = jnp.arcsin(s)
    return jnp.where(param_mask & (half > 0), u, 0.0)


def _to_physical(u, lo, hi, p_seed, param_mask):
    mid = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    p = mid + half * jnp.sin(u)
    return jnp.where(param_mask & (half > 0), p, p_seed)


def _dp_du(u, lo, hi, param_mask):
    half = 0.5 * (hi - lo)
    d = half * jnp.cos(u)
    return jnp.where(param_mask & (half > 0), d, 0.0)


# |sin(u)| above this counts as "parameter on its bound" for the KKT
# convergence mask (1 - 5e-4 of the half-range from the box edge)
_SAT_THRESH = 0.9995


# ----------------------------------------------------------------------
# Core LM loop
# ----------------------------------------------------------------------
def lm_solve(cfg: NPSConfig, model: WaveformModel, inp: FitInputs,
             u0: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray,
             p_seed: jnp.ndarray, param_mask: jnp.ndarray,
             active: jnp.ndarray, max_iter: int, lam0: float,
             iter_budget: Optional[jnp.ndarray] = None):
    """Run LM from internal params u0 on ``active`` lanes.

    ``max_iter`` is the static loop cap; ``iter_budget`` [N] (optional)
    gives each lane its own (<= max_iter) budget — a lane that exhausts its
    budget freezes as not-converged while deeper-budget lanes continue.
    ``lam0`` may be a scalar or a per-lane [N] array — the latter lets a
    caller CONTINUE a frozen solve exactly (the trajectory of an LM lane
    is fully determined by (u, lambda, remaining budget); A/g are pure
    functions of u and are recomputed identically at re-entry).
    Returns (u, chi2, converged, n_iter, edm, lam).
    """
    dtype = inp.y.dtype
    N, M = u0.shape
    xgrid = jnp.arange(cfg.fit_lo_bin, cfg.fit_hi_bin, dtype=dtype)
    w = 1.0 / inp.sigma                                   # [N, K]
    base_aux = {"coeffs": inp.coeffs, "x0": inp.x0,
                "timeref": (inp.timeref if inp.timeref is not None
                            else jnp.zeros_like(inp.x0))}
    # generic model-aux channel: static per-model scalars from the config
    # broadcast per lane (e.g. the gaussian family's width)
    for k, v in cfg.model_aux:
        base_aux[k] = jnp.full(inp.x0.shape, v, dtype)
    aux = model.prepare_aux(cfg, base_aux)
    eye = jnp.eye(M, dtype=dtype)

    # HIGHEST: an fp32 dot may otherwise run with TF32 operands (about 3
    # significant digits), enough to flip LM accept/convergence decisions
    hi_prec = jax.lax.Precision.HIGHEST

    def system(u):
        p = _to_physical(u, lo, hi, p_seed, param_mask)
        f, Jp = model.eval_and_jac(cfg, p, aux, xgrid, inp.pulse_mask)
        r = (inp.y - f) * w                               # [N, K]
        Ju = Jp * _dp_du(u, lo, hi, param_mask)[:, None, :] * w[:, :, None]
        A = jnp.einsum("nki,nkj->nij", Ju, Ju, precision=hi_prec,
                       preferred_element_type=dtype)      # [N, M, M]
        g = jnp.einsum("nki,nk->ni", Ju, r, precision=hi_prec,
                       preferred_element_type=dtype)      # [N, M]
        chi2 = jnp.sum(r * r, axis=1)
        return A, g, chi2

    def solve_damped(A, g, lam):
        diag = jnp.diagonal(A, axis1=1, axis2=2)
        scale = jnp.where(diag > 1e-30, jnp.sqrt(diag), 1.0)   # Jacobi precond
        As = A / (scale[:, :, None] * scale[:, None, :])
        gs = g / scale
        # dead columns (fixed/masked params) -> identity rows
        dead = diag <= 1e-30
        As = jnp.where(dead[:, :, None] | dead[:, None, :], 0.0, As)
        # Marquardt damping on the scaled system: diagonal becomes (1 + lam)
        damped = As * (1.0 - eye[None]) + eye[None] * (1.0 + lam[:, None, None])
        gs = jnp.where(dead, 0.0, gs)
        delta_s = cholesky_solve(damped, gs)
        delta = delta_s / scale
        return jnp.where(dead, 0.0, delta)

    eps = float(jnp.finfo(dtype).eps)
    ftol_eff = max(cfg.lm_ftol, 100.0 * eps)
    gtol_eff = max(cfg.lm_gtol, 100.0 * eps)

    def gcrit_of(A, g, chi2, u):
        # MINPACK-style scaled-gradient criterion, independent of lambda:
        # max_j |g_j| / (||J_j|| * ||r||) <= gtol  => at a (local) minimum —
        # over the KKT-free components only. At an ACTIVE bound the sin
        # transform gives dp/du -> 0, but the cos factor cancels between
        # g_j and sqrt(diag_j), so the scaled gradient of a bound-pinned
        # parameter never decays even when the constrained optimum is
        # reached (Migrad certifies such fits; without this mask every
        # bound-active lane burned its full budget and was flagged failed
        # — the dominant "LM stuck" class in tools/solver_audit.py).
        # KKT: a component is excluded iff the parameter sits on its bound
        # AND the descent direction points outward (chi2 would only
        # improve by leaving the feasible box).
        diag = jnp.diagonal(A, axis1=1, axis2=2)
        dead = diag <= 1e-30
        sinu = jnp.sin(u)
        push = g * _dp_du(u, lo, hi, param_mask)   # >0: descent raises p
        kkt_active = ((sinu > _SAT_THRESH) & (push > 0)) | \
                     ((sinu < -_SAT_THRESH) & (push < 0))
        skip = dead | kkt_active
        denom = jnp.sqrt(jnp.where(dead, 1.0, diag)) * \
            jnp.sqrt(jnp.maximum(chi2, eps))[:, None]
        return jnp.max(jnp.where(skip, 0.0, jnp.abs(g)) / denom, axis=1)

    # The normal equations of the CURRENT point ride in the carry, so each
    # iteration costs exactly one model evaluation (at the trial point):
    # accept -> the trial's system becomes current; reject -> keep the cache
    # and only lambda changes.
    if iter_budget is None:
        iter_budget = jnp.full((N,), max_iter, jnp.int32)
    A0, g0, chi2_0 = system(u0)
    zero = chi2_0 * 0.0  # varying-derived init keeps shard_map types stable
    state = dict(
        u=u0, A=A0, g=g0,
        chi2=jnp.where(active, chi2_0, 0.0),
        lam=zero + lam0,
        done=~active | (iter_budget <= 0),
        conv=active & jnp.zeros((N,), bool),
        n_iter=zero.astype(jnp.int32),
        edm=zero + jnp.inf,
        it=jnp.asarray(0, jnp.int32),
    )

    def cond(s):
        return (s["it"] < max_iter) & ~jnp.all(s["done"])

    def one_step(s):
        gcrit = gcrit_of(s["A"], s["g"], s["chi2"], s["u"])
        conv_g = gcrit < gtol_eff

        delta = solve_damped(s["A"], s["g"], s["lam"])
        u_try = s["u"] + delta
        A_t, g_t, chi2_try = system(u_try)
        good = jnp.isfinite(chi2_try) & (chi2_try < s["chi2"])
        step = good & ~s["done"] & ~conv_g
        u_new = jnp.where(step[:, None], u_try, s["u"])
        A_new = jnp.where(step[:, None, None], A_t, s["A"])
        g_new = jnp.where(step[:, None], g_t, s["g"])
        chi2_new = jnp.where(step, chi2_try, s["chi2"])
        lam_new = jnp.where(step, s["lam"] / cfg.lm_lambda_down,
                            s["lam"] * cfg.lm_lambda_up)
        lam_new = jnp.clip(lam_new, cfg.lm_lambda_min, cfg.lm_lambda_max)
        rel_impr = (s["chi2"] - chi2_new) / jnp.maximum(s["chi2"], 1.0)
        conv_f = step & (rel_impr < ftol_eff)
        conv = ~s["done"] & (conv_g | conv_f)
        n_iter = jnp.where(s["done"], s["n_iter"], s["n_iter"] + 1)
        # a lane that exhausts its own budget freezes (not converged)
        done_new = s["done"] | conv | (n_iter >= iter_budget)
        return dict(u=u_new, A=A_new, g=g_new, chi2=chi2_new,
                    lam=jnp.where(s["done"], s["lam"], lam_new),
                    done=done_new, conv=s["conv"] | conv, n_iter=n_iter,
                    edm=jnp.where(s["done"], s["edm"], gcrit),
                    it=s["it"] + 1)

    out = jax.lax.while_loop(cond, one_step, state)
    converged = out["conv"] & active
    return (out["u"], out["chi2"], converged, out["n_iter"], out["edm"],
            out["lam"])


# ----------------------------------------------------------------------
# Public entry: two-stage escalated fit
# ----------------------------------------------------------------------
def _prepare(cfg: NPSConfig, inp: FitInputs):
    """Bounds, seeds, param mask, internal start point, per-lane budgets."""
    N, P = inp.t_seed.shape
    lo, hi = _bounds(cfg, inp)
    p_seed = _seed_params(cfg, inp)
    pm = jnp.concatenate(
        [jnp.ones((N, 1), bool),
         jnp.repeat(inp.pulse_mask, 2, axis=1)], axis=1)   # [N, M] param mask
    u0 = _to_internal(p_seed, lo, hi, pm)
    # per-LANE iteration budgets keyed on the lane's own pulse count:
    # high-pileup (many-param) systems converge slower and get the wide
    # budgets. Keying on the lane (not the routing bucket) keeps fit-lane
    # routing result-neutral.
    npul = jnp.sum(inp.pulse_mask, axis=1)
    wide = npul > cfg.lm_wide_pulses
    s1_budget = jnp.where(wide, cfg.lm_stage1_wide,
                          cfg.lm_max_iter_stage1).astype(jnp.int32)
    s2_budget = jnp.where(wide, cfg.lm_stage2_wide,
                          cfg.lm_max_iter_stage2).astype(jnp.int32)
    return lo, hi, p_seed, pm, u0, s1_budget, s2_budget


def fit_waveforms(cfg: NPSConfig, inp: FitInputs,
                  model_name: str = "", stage1_chunk: int = 0) -> FitResult:
    """Two-stage escalated batched fit.

    ``stage1_chunk`` > 0 runs stage 1 in lax.map chunks of that size while
    stage 2 stays ONE global pass over all failed lanes — chunking bounds
    compiled kernel sizes without multiplying the fixed cost of the
    stage-2 retry rounds by the chunk count. Results are lane-identical
    either way (the LM update is row-wise).
    """
    model = get_model(model_name or cfg.model_name)
    N, P = inp.t_seed.shape
    dtype = inp.y.dtype
    lo, hi, p_seed, pm, u0, s1_budget, s2_budget = _prepare(cfg, inp)
    s1_cap = max(cfg.lm_max_iter_stage1, cfg.lm_stage1_wide)
    s2_cap = max(cfg.lm_max_iter_stage2, cfg.lm_stage2_wide)

    # stage 1 runs with a cap/budget clipped to the tier size when the
    # tiered layout is on (lm_stage1_tier > 0): a short full-width pass,
    # then a compacted continuation of the unconverged lanes below.
    tier = int(cfg.lm_stage1_tier)
    tiered = 0 < tier < s1_cap
    s1_run_cap = min(tier, s1_cap) if tiered else s1_cap
    s1_run_budget = (jnp.minimum(s1_budget, tier).astype(jnp.int32)
                     if tiered else s1_budget)

    if stage1_chunk > 0 and N > stage1_chunk:
        u1, chi2_1, conv1, it1, edm1, lam1 = _stage1_chunked(
            cfg, model, inp, u0, lo, hi, p_seed, pm, s1_run_cap,
            s1_run_budget, stage1_chunk)
    else:
        u1, chi2_1, conv1, it1, edm1, lam1 = lm_solve(
            cfg, model, inp, u0, lo, hi, p_seed, pm, inp.active,
            s1_run_cap, cfg.lm_lambda_init, s1_run_budget)

    def _compact_pass(mask, start_u, lam0, budgets, cap, denom):
        """Solve ``mask`` lanes compacted: gathered to the front via a
        stable argsort, run in static-size chunks under a while_loop until
        EVERY masked lane has been solved — no silent cap; an empty mask
        runs zero chunks. ``denom``: chunk = N/denom — every pass pays at
        least ONE chunk of full depth, so the chunk width must track the
        pass's typical lane mass. ``lam0``/``budgets`` are per-lane [N]
        (continuations carry each lane's own lambda and remaining budget).
        The final chunk clamps to [N - n2, N): overlapped lanes are
        re-solved deterministically to the same values or inactive.
        Returns full-width (u, chi2, conv, it, edm); rows are meaningful
        only where ``mask``."""
        n2 = max(min(N, 128), N // denom)
        order2 = jnp.argsort(~mask, stable=True)     # masked lanes first
        n_masked = jnp.sum(mask).astype(jnp.int32)

        def pass_cond(c):
            return c[0] < n_masked

        def pass_body(c):
            start, u2, chi2_2, conv2, it2, edm2 = c
            idx = jax.lax.dynamic_slice(order2, (start,), (n2,))

            def take(x):
                return jnp.take(x, idx, axis=0)

            inp2 = FitInputs(
                y=take(inp.y), sigma=take(inp.sigma),
                coeffs=take(inp.coeffs), x0=take(inp.x0),
                t_seed=take(inp.t_seed), a_seed=take(inp.a_seed),
                ped_seed=take(inp.ped_seed),
                pulse_mask=take(inp.pulse_mask), active=take(mask),
                timeref=None if inp.timeref is None else take(inp.timeref))
            u2c, chi2_2c, conv2c, it2c, edm2c, _ = lm_solve(
                cfg, model, inp2, take(start_u), take(lo), take(hi),
                take(p_seed), take(pm), take(mask),
                cap, take(lam0), take(budgets))
            return (start + jnp.asarray(n2, jnp.int32),
                    u2.at[idx].set(u2c), chi2_2.at[idx].set(chi2_2c),
                    conv2.at[idx].set(conv2c), it2.at[idx].set(it2c),
                    edm2.at[idx].set(edm2c))

        _, u2, chi2_2, conv2, it2, edm2 = jax.lax.while_loop(
            pass_cond, pass_body,
            (jnp.asarray(0, jnp.int32), jnp.zeros_like(u1),
             jnp.zeros_like(chi2_1), jnp.zeros_like(conv1),
             jnp.zeros_like(it1), jnp.zeros_like(edm1)))
        return u2, chi2_2, conv2, it2, edm2

    # tiered stage-1 continuation: lanes still unconverged after the
    # ``tier``-iteration full-width pass carry their (u, lambda, remaining
    # budget) into a COMPACTED solve — the LM trajectory, and therefore
    # every result, is identical to the monolithic run (A/g are pure
    # functions of u; the carried cache is recomputed identically at
    # re-entry, up to last-ulp XLA codegen differences across chunk
    # widths — see the tier-equivalence test). Median stage-1
    # convergence is 4 iterations while the
    # budget is 10+ (PERF.md): without the tier the straggler ~12% force
    # every full-width chunk to the whole budget; with it the tail runs at
    # ~1/8 width. Under lax.cond so an all-converged batch pays nothing.
    if tiered:
        cont = inp.active & ~conv1 & (s1_budget > it1)

        def _run_cont(args):
            cont_m, u1_, chi2_1_, conv1_, it1_, edm1_, lam1_ = args
            uc, chi2c, convc, itc, edmc = _compact_pass(
                cont_m, u1_, lam1_, (s1_budget - it1_).astype(jnp.int32),
                s1_cap - tier, 8)
            return (jnp.where(cont_m[:, None], uc, u1_),
                    jnp.where(cont_m, chi2c, chi2_1_),
                    conv1_ | (cont_m & convc),
                    it1_ + jnp.where(cont_m, itc, 0),
                    jnp.where(cont_m, edmc, edm1_))

        def _skip_cont(args):
            _, u1_, chi2_1_, conv1_, it1_, edm1_, _ = args
            return u1_, chi2_1_, conv1_, it1_, edm1_

        u1, chi2_1, conv1, it1, edm1 = jax.lax.cond(
            jnp.any(cont), _run_cont, _skip_cont,
            (cont, u1, chi2_1, conv1, it1, edm1, lam1))

    # stage 2: restart failed lanes from the seeds with a bigger budget
    # (Migrad strategy escalation, ref TEST_2.C:765-767). Two layouts with
    # identical results (the LM update is row-wise, so a lane's solution
    # does not depend on its batch neighbors):
    # - "masked": one full-width solve with only failed lanes active.
    #   Sequential depth <= lm_max_iter_stage2 regardless of failure count;
    #   right choice when iterations are launch/latency-bound.
    # - "compact": failed lanes gathered to the front, re-solved in
    #   static-size chunks under a while_loop until EVERY failed lane has
    #   been retried — the reference retries all failures (ref :761-773),
    #   so there is no silent cap. A clean batch runs zero chunks.
    failed1 = inp.active & ~conv1

    def _retry_pass(start_u, mask, lam0, denom):
        """One restart pass over ``mask`` lanes from ``start_u``.

        masked layout: one full-width solve (sequential depth <= s2_cap
        regardless of failure count). compact layout: _compact_pass
        chunks. ``denom``: stage 2 carries the ~10% of lanes the
        10-iteration stage-1 budget leaves; stage 3 carries the <1% still
        failed after stage 2 — a narrower chunk measured 4x cheaper there
        and identical results."""
        lam0_arr = jnp.full((N,), lam0, dtype)
        if cfg.lm_stage2_mode == "masked":
            u2, chi2_2, conv2, it2, _, _ = lm_solve(
                cfg, model, inp, start_u, lo, hi, p_seed, pm, mask,
                s2_cap, lam0_arr, s2_budget)
            return u2, chi2_2, conv2, it2
        u2, chi2_2, conv2, it2, _ = _compact_pass(
            mask, start_u, lam0_arr, s2_budget, s2_cap, denom)
        return u2, chi2_2, conv2, it2

    # Each retry stage rides under lax.cond(any(mask), ...) so a batch with
    # nothing to retry pays NOTHING for the stage — not even the [N] argsort
    # / pull-back trig / merge selects that used to run unconditionally
    # (measured ~12 ms/batch for stage 3 on a clean dense batch even though
    # its while_loop ran zero chunks). Same pattern as the pipeline's empty
    # fit buckets (engine/pipeline.py). Skip-branch outputs are derived from
    # the operands so shard_map varying-axes types agree across branches;
    # they are never read (the merges mask on `mask & convN`, all-False on
    # the skip path).
    def _cond_retry(mask, start_u, lam0, denom):
        def _run(args):
            m, su = args
            return _retry_pass(su, m, lam0, denom)

        def _skip(args):
            m, su = args
            z = su[:, 0] * 0.0
            return (jnp.zeros_like(su), z, m & (z > 1.0),
                    z.astype(jnp.int32))

        return jax.lax.cond(jnp.any(mask), _run, _skip, (mask, start_u))

    # stage 2: restart failed lanes from the seeds with a bigger budget
    # (Migrad strategy escalation, ref TEST_2.C:765-767)
    u2, chi2_2, conv2, it2 = _cond_retry(failed1, u0,
                                         cfg.lm_lambda_init * 10.0, 16)

    # stage 3 (bound-escape): the sin transform sticks at active bounds —
    # once |sin(u)| saturates, cos(u) -> 0 collapses the effective step
    # and the lane can no longer walk back into the interior even when a
    # better minimum exists there (tools/solver_audit.py measured scipy-
    # TRF reaching 20-35% lower chi2 on exactly these lanes). Restart the
    # still-failed lanes from the STAGE-1 END STATE with saturated
    # components pulled back to sin(u) = +-m, one rung per magnitude in
    # cfg.lm_stage3_pullbacks (0.8 near-bound, then 0.5 deeper-interior
    # for lanes the first rung cannot rescue); converged-lane results
    # from earlier stages are never revisited, so stages 1-2 outputs are
    # unchanged. On the adversarial ensembles the first rung alone cuts
    # the failure rate ~5x (wrong-shape 12.4% -> 1.5%; SOLVER_AUDIT.md).
    if cfg.lm_stage3:
        def _skip3(args):
            _, _, u2_, chi2_2_, conv2_, it2_ = args
            return u2_, chi2_2_, conv2_, it2_

        for pullback in cfg.lm_stage3_pullbacks:
            failed2 = failed1 & ~conv2

            def _run3(args, _pb=float(pullback)):
                f2, u1_, u2_, chi2_2_, conv2_, it2_ = args
                sinu1 = jnp.sin(u1_)
                sat = jnp.abs(sinu1) > 0.95
                u_pb = jnp.where(sat & pm,
                                 jnp.arcsin(_pb * jnp.sign(sinu1)), u1_)
                u3, chi2_3, conv3, it3 = _retry_pass(u_pb, f2,
                                                     cfg.lm_lambda_init, 64)
                use3 = f2 & conv3
                return (jnp.where(use3[:, None], u3, u2_),
                        jnp.where(use3, chi2_3, chi2_2_),
                        conv2_ | use3,
                        it2_ + jnp.where(f2, it3, 0))

            u2, chi2_2, conv2, it2 = jax.lax.cond(
                jnp.any(failed2), _run3, _skip3,
                (failed2, u1, u2, chi2_2, conv2, it2))

    return _combine(cfg, inp, u0, u1, chi2_1, conv1, it1, edm1,
                    failed1, u2, chi2_2, conv2, it2, lo, hi, p_seed, pm)


def _stage1_chunked(cfg: NPSConfig, model: WaveformModel, inp: FitInputs,
                    u0, lo, hi, p_seed, pm, s1_cap: int, s1_budget,
                    chunk: int):
    """Stage 1 via lax.map over fixed-size lane chunks.

    Each chunk's while_loop exits as soon as its own lanes converge (the
    reason to chunk at all: bounded kernel sizes + early exit for
    all-inactive chunks when lanes are front-packed by occupancy).
    """
    N = u0.shape[0]
    nc = -(-N // chunk)
    pad = nc * chunk - N

    def pad0(x, value=0):
        if x is None:
            return None
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=value)

    def chunked(x):
        return None if x is None else x.reshape((nc, chunk) + x.shape[1:])

    inp_p = FitInputs(*[chunked(pad0(v, 1 if name == "sigma" else 0))
                        for name, v in zip(FitInputs._fields, inp)])
    carry = tuple(chunked(pad0(v)) for v in
                  (u0, lo, hi, p_seed, pm, inp.active, s1_budget))

    def one(args):
        ic, (u0c, loc, hic, psc, pmc, actc, bc) = args
        return lm_solve(cfg, model, ic, u0c, loc, hic, psc, pmc, actc,
                        s1_cap, cfg.lm_lambda_init, bc)

    res = jax.lax.map(one, (inp_p, carry))
    return tuple(v.reshape((nc * chunk,) + v.shape[2:])[:N] for v in res)


def _combine(cfg, inp, u0, u1, chi2_1, conv1, it1, edm1,
             failed1, u2, chi2_2, conv2, it2, lo, hi, p_seed, pm) -> FitResult:
    """Merge stage-1 and stage-2 results into the public FitResult."""
    dtype = inp.y.dtype
    use2 = failed1 & conv2
    u = jnp.where(use2[:, None], u2, u1)
    chi2 = jnp.where(use2, chi2_2, chi2_1)
    converged = conv1 | (failed1 & conv2)
    params = _to_physical(u, lo, hi, p_seed, pm)
    # still-failed lanes report their seed parameters (ref :774-791 fallback)
    params = jnp.where((inp.active & ~converged)[:, None], p_seed, params)
    nfree = 1 + 2 * jnp.sum(inp.pulse_mask, axis=1)
    ndf = jnp.maximum(inp.y.shape[1] - nfree, 1).astype(dtype)
    return FitResult(params=params, chi2=chi2, chi2_ndf=chi2 / ndf,
                     converged=converged, converged_stage1=conv1,
                     n_iter=it1 + it2,
                     edm=edm1)
