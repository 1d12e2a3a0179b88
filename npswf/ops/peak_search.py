"""Vectorized Markov-smoothed peak search (TSpectrum::Search parity).

Batched replacement for the mutex-serialized ``TSpectrum::Search`` call at
ref TEST_2.C:186-188 — the one global serialization point in the reference.
Here the search runs as a fixed-shape batched computation over all
(event x block) lanes at once.

Algorithm (SearchHighRes semantics for sigma=2, "nobackground,nodraw",
threshold=0.02, deconIterations=3, markov on, averWindow=3):

1. extend the T-bin spectrum by shift = int(7*sigma+0.5) bins each side
   (left: straight-line extrapolation of the first int(2*sigma+0.5) samples
   with non-positive slope, clamped at 0; right: constant),
2. Markov smoothing: w[i+1] = w[i] * sp_i/sm_i with transition weights
   exp((y_j - y_i)/sqrt(y_j + y_i)) over an averWindow neighborhood, then
   rescale to the original area. Computed here in log space with
   max-subtraction (exactly scale-invariant) so fp32 cannot overflow,
3. Gold deconvolution against an integer-quantized Gaussian response
   (three multiplicative iterations with the reference's stale-value
   buffering), circular shift by the response maximum,
4. accept local maxima above 0.02 * max(decon) whose pre-smoothing value
   also exceeds 0.02 * max(source); 3-bin centroid position,
5. top-``max_peaks`` by source amplitude, ties by detection order
   (= TSpectrum's insertion sort).

``find_pulses`` wraps the search with the matched filter and the reference's
acceptance gates (ref TEST_2.C:192-207).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from npswf.core.config import NPSConfig
from npswf.ops.matched_filter import matched_filter


@functools.lru_cache(maxsize=8)
def _static_response(sigma: float, size_ext: int):
    """Quantized Gaussian response, its area/extent/argmax and autocorrelation."""
    resp = np.zeros(size_ext)
    area = 0.0
    lh_gold = -1
    posit = 0
    mx = 0.0
    for i in range(size_ext):
        lda = (i - 3.0 * sigma) ** 2 / (2.0 * sigma * sigma)
        q = float(int(1000.0 * math.exp(-lda)))
        if q != 0.0:
            lh_gold = i + 1
        resp[i] = q
        area += q
        if q > mx:
            mx = q
            posit = i
    L = lh_gold - 1
    bvec = np.zeros(2 * L + 1)
    for lag in range(-L, L + 1):
        jmin = 0 if lag >= 0 else -lag
        jmax = min(L, L - lag)
        bvec[lag + L] = sum(resp[j] * resp[lag + j] for j in range(jmin, jmax + 1))
    return resp[:lh_gold], area, lh_gold, posit, bvec


def tspectrum_search(cfg: NPSConfig, src: jnp.ndarray,
                     aux: jnp.ndarray = None, aux_offset: int = 0):
    """Batched peak search over ``src`` [N, T].

    Returns (pos_x [N,P], pos_y [N,P], valid [N,P]) with P = cfg.maxwfpulses,
    ordered by descending source amplitude. pos_x follows the Search() bin
    convention (k + 0.5); invalid slots hold zeros.

    ``aux`` [N, T] (optional): a sibling spectrum sampled per peak at bin
    clip(round(centroid) + aux_offset, 0, T-1), carried through the ordering
    sort and returned as a fourth output [N, P] — gather-free (the target
    bin is always within +-1 of the local max plus the static offset, so
    shifted slices + selects cover it). Used by find_pulses to read the
    RAW-signal seed amplitude without a [N, P] gather (ref TEST_2.C:198-200).
    """
    dtype = src.dtype
    N, ssize = src.shape
    sigma = cfg.spec_sigma
    P = cfg.maxwfpulses
    shift = int(7.0 * sigma + 0.5)
    size_ext = ssize + 2 * shift

    resp_np, area, lh_gold, posit, bvec_np = _static_response(sigma, size_ext)
    L = lh_gold - 1
    resp = jnp.asarray(resp_np, dtype)
    bvec = jnp.asarray(bvec_np, dtype)

    # ---- 1. extension -------------------------------------------------
    kfit = int(2.0 * sigma + 0.5)
    if kfit >= 2:
        i_arr = np.arange(kfit, dtype=np.float64)
        # python floats (weak types): numpy scalars would promote the whole
        # search to f64 when x64 is enabled, silently changing the compute
        # dtype of every downstream op
        m0, m1, m2 = float(kfit), float(i_arr.sum()), float((i_arr ** 2).sum())
        det = m0 * m2 - m1 * m1
        l0 = jnp.sum(src[:, :kfit], axis=1)
        l1 = jnp.sum(src[:, :kfit] * jnp.asarray(i_arr, dtype), axis=1)
        l1low = jnp.where(det != 0.0, (-l0 * m1 + l1 * m0) / det, 0.0)
        l1low = jnp.minimum(l1low, 0.0)
    else:
        l1low = jnp.zeros((N,), dtype)
    left_off = jnp.asarray(np.arange(shift) - shift, dtype)          # [shift]
    left = jnp.maximum(src[:, :1] + l1low[:, None] * left_off, 0.0)  # [N, shift]
    right = jnp.maximum(src[:, -1:], 0.0) * jnp.ones((1, shift), dtype)
    ext = jnp.concatenate([left, src, right], axis=1)                # [N, size_ext]
    ext_orig = ext

    # ---- 2. Markov smoothing (log-space, scale-invariant) -------------
    maxch = jnp.max(ext, axis=1, keepdims=True)                      # [N, 1]
    plocha = jnp.sum(ext, axis=1, keepdims=True)
    safe_maxch = jnp.where(maxch > 0, maxch, 1.0)
    y = ext / safe_maxch                                             # [N, size_ext]
    nip = y[:, :-1]                                                  # [N, size_ext-1]
    nim = y[:, 1:]
    sp = jnp.zeros_like(nip)
    sm = jnp.zeros_like(nip)
    xmax = size_ext - 1
    for l in range(1, cfg.spec_aver_window + 1):
        # neighbor lookups y[min(i+l, xmax)] / y[max(i-l+1, 0)] as pure
        # slices + edge-column broadcast instead of index-array gathers
        a_f = jnp.concatenate(
            [y[:, l:xmax], jnp.broadcast_to(y[:, xmax:xmax + 1], (N, l))],
            axis=1)
        denom_f = jnp.where(a_f + nip <= 0.0, 1.0, jnp.sqrt(a_f + nip))
        sp = sp + jnp.exp((a_f - nip) / denom_f)
        a_b = jnp.concatenate(
            [jnp.broadcast_to(y[:, :1], (N, l - 1)), y[:, :xmax - l + 1]],
            axis=1)
        denom_b = jnp.where(a_b + nim <= 0.0, 1.0, jnp.sqrt(a_b + nim))
        sm = sm + jnp.exp((a_b - nim) / denom_b)
    logr = jnp.log(sp) - jnp.log(sm)
    logw = jnp.concatenate([jnp.zeros((N, 1), dtype), jnp.cumsum(logr, axis=1)], axis=1)
    w = jnp.exp(logw - jnp.max(logw, axis=1, keepdims=True))
    smoothed = w / jnp.sum(w, axis=1, keepdims=True) * plocha        # [N, size_ext]

    # ---- 3. Gold deconvolution ---------------------------------------
    src_abs = jnp.abs(smoothed)
    padded = jnp.pad(src_abs, ((0, 0), (L, 0)))
    pvec = jnp.zeros_like(src_abs)
    for j in range(lh_gold):
        pvec = pvec + resp[j] * padded[:, j:j + size_ext]

    def _den(x):
        xp = jnp.pad(x, ((0, 0), (L, L)))
        d = jnp.zeros_like(x)
        for j in range(2 * L + 1):
            d = d + bvec[j] * xp[:, j:j + size_ext]
        return d

    x = jnp.ones((N, size_ext), dtype)
    prev = jnp.zeros((N, size_ext), dtype)
    for _ in range(cfg.spec_decon_iterations):
        den = _den(x)
        cond = (jnp.abs(pvec) > 1e-5) & (jnp.abs(x) > 1e-5)
        factor = jnp.where((den != 0.0) & (pvec != 0.0), pvec / jnp.where(den == 0, 1.0, den), 0.0)
        xnew = jnp.where(cond, factor * x, prev)
        prev = xnew
        x = xnew
    idx = np.arange(size_ext)
    in_range = (idx >= shift) & (idx < ssize + shift) & (idx < size_ext - L)
    # decon[i] = area * x[i + L - posit] on the valid range: the response
    # argmax shift (+posit) and the padding realignment (-L) compose into
    # one circular roll
    decon = jnp.where(jnp.asarray(in_range),
                      area * jnp.roll(x, posit - L, axis=1), 0.0)
    maximum_decon = jnp.max(decon, axis=1, keepdims=True)
    maximum = jnp.max(jnp.where(jnp.asarray(in_range), ext_orig, -jnp.inf),
                      axis=1, keepdims=True)

    # ---- 4. accept + centroid ----------------------------------------
    # ROOT's Search() forwards 100*threshold into SearchHighRes, whose
    # acceptance is working_space[i] > threshold*maximum_decon/100 — i.e.
    # specthres * max(decon), with NO min(1, .) clamp (that round-1 clamp
    # wrongly admitted peaks at 1% of the decon max for specthres=0.02).
    rel = cfg.specthres
    is_lmax = jnp.zeros((N, size_ext), bool)
    is_lmax = is_lmax.at[:, 1:-1].set(
        (decon[:, 1:-1] > decon[:, :-2]) & (decon[:, 1:-1] > decon[:, 2:]))
    accept = (is_lmax & jnp.asarray(in_range)
              & (decon > rel * maximum_decon)
              & (ext_orig > cfg.specthres * maximum)
              & (maxch > 0))
    dl = jnp.pad(decon, ((0, 0), (1, 1)))
    num = ((jnp.asarray(idx - 1 - shift, dtype)) * dl[:, :-2]
           + (jnp.asarray(idx - shift, dtype)) * dl[:, 1:-1]
           + (jnp.asarray(idx + 1 - shift, dtype)) * dl[:, 2:])
    den3 = dl[:, :-2] + dl[:, 1:-1] + dl[:, 2:]
    a = num / jnp.where(den3 == 0, 1.0, den3)
    a = jnp.clip(a, 0.0, float(ssize - 1))

    # ---- 5. top-P by source amplitude --------------------------------
    # The source amplitude at the centroid bin, src[clip(floor(a))], is
    # needed as the ordering key. A take_along_axis here would be a
    # full-width per-element gather. But the 3-bin centroid a always
    # lies within +-1 of its local-max bin j (nonnegative decon weights),
    # and the edge clip keeps the target in {j-1, j, j+1} too, so the
    # gather is exactly reproduced by three static shifted slices + selects.
    # (Slots where that window argument fails have accept == False and are
    # masked to -inf below, so their key value is irrelevant.)
    j_idx = jnp.asarray(idx, jnp.int32)

    def _window_select(arr, target_sample, cands):
        """arr[clip-target] via static shifted slices: target_sample + shift
        is guaranteed to lie in {j + c for c in cands} at every slot whose
        value is consumed (accept-masked otherwise)."""
        pad_arr = jnp.pad(arr, ((0, 0), (shift, size_ext - ssize - shift)))
        k_val = target_sample + shift                    # ext-frame target
        out = pad_arr                                     # c == 0 default
        for c in cands:
            if c == 0:
                continue
            if c < 0:
                sh = jnp.pad(pad_arr, ((0, 0), (-c, 0)))[:, :c]   # arr[j+c]
            else:
                sh = jnp.pad(pad_arr, ((0, 0), (0, c)))[:, c:]
            out = jnp.where(k_val == j_idx + c, sh, out)
        return out

    a_int = jnp.clip(jnp.floor(a).astype(jnp.int32), 0, ssize - 1)
    key = _window_select(src, a_int, (-1, 0, 1))
    # pos_y's value at the ROUNDED centroid, computed full-width the same
    # way so the final per-slot extraction needs no gather either
    k_round = jnp.clip(jnp.floor(a + 0.5).astype(jnp.int32), 0, ssize - 1)
    pos_y_full = _window_select(src, k_round, (-1, 0, 1))

    neg_inf = jnp.asarray(-jnp.inf, dtype)
    keys_masked = jnp.where(accept, key, neg_inf)
    # one stable multi-operand sort carries (a, pos_y[, aux]) along with the
    # key: descending amplitude, ties in scan order — identical ordering to
    # top_k + per-slot gathers, without the [N, P] gathers
    operands = [-keys_masked, a, pos_y_full]
    if aux is not None:
        tgt = jnp.clip(k_round + aux_offset, 0, ssize - 1)
        # unclipped targets live in {j + aux_offset +- 1}; the edge clip can
        # only pull them back toward the local max (c -> 0), so the reachable
        # set is every c between min(0, o-1) and max(0, o+1)
        cands = tuple(range(min(0, aux_offset - 1),
                            max(0, aux_offset + 1) + 1))
        operands.append(_window_select(aux.astype(dtype), tgt, cands))
    # accepted peaks only exist on the in_range window [shift, shift+T):
    # sorting just those columns is exact (outside slots are -inf-masked
    # anyway) and trims ~20% off the multi-operand sort
    operands = [op[:, shift:shift + ssize] for op in operands]
    srt = jax.lax.sort(tuple(operands), dimension=1, num_keys=1)
    sort_neg, a_srt, y_srt = srt[0], srt[1], srt[2]
    valid = sort_neg[:, :P] < jnp.asarray(jnp.inf, dtype)             # [N, P]
    a_sel = a_srt[:, :P]
    k_sel = jnp.floor(a_sel + 0.5)
    pos_x = jnp.where(valid, k_sel + 0.5, 0.0)
    pos_y = jnp.where(valid, y_srt[:, :P], 0.0)
    if aux is not None:
        return pos_x, pos_y, valid, jnp.where(valid, srt[3][:, :P], 0.0)
    return pos_x, pos_y, valid


class PulseSearchResult(NamedTuple):
    npulse: jnp.ndarray   # [N] int32 — accepted pulse count
    times: jnp.ndarray    # [N, P] — xpos in sample units (bin - 2 shift applied)
    amps: jnp.ndarray     # [N, P] — |raw[round(xpos)] - minsignal| seed amplitude
    valid: jnp.ndarray    # [N, P] bool — slot validity (compacted to the front)
    mf: jnp.ndarray       # [N, T] — matched-filter output (diagnostics)


def find_pulses(cfg: NPSConfig, signal: jnp.ndarray, minsignal: jnp.ndarray,
                kern_rev: jnp.ndarray, mfint: jnp.ndarray,
                present: jnp.ndarray) -> PulseSearchResult:
    """FindPulsesMF parity over flat lanes.

    Args:
      signal:    [N, T] waveforms (lane = event x block).
      minsignal: [N] per-lane baseline.
      kern_rev:  [N, W] per-lane reversed UNnormalized kernel.
      mfint:     [N] per-lane kernel normalization (per-tap divisor, ref :161).
      present:   [N] bool — pres && preswf gate (ref :139-143, 944).
    """
    T = cfg.ntime
    mf = matched_filter(cfg, signal[:, None, :], minsignal[:, None],
                        kern_rev[:, None, :], mfint[:, None])[:, 0, :]
    # The reference stores the filter into a float32-binned TH1F (ref :173-179);
    # quantize identically before the search.
    mf_search = mf.astype(jnp.float32).astype(mf.dtype)
    # seed amplitude reads the RAW signal at floor(xpos + 0.5) =
    # floor(k_round + 0.5 - 2 + 0.5) = k_round - 1 (ref :194-200); carried
    # through the search's ordering sort instead of a [N, P] gather
    pos_x, pos_y, valid, raw = tspectrum_search(
        cfg, mf_search, aux=signal, aux_offset=-1)
    xpos = pos_x - 2.0                                   # -2 bin shift (ref :194)
    gate = (valid
            & (xpos > max(cfg.mfstart, 0))
            & (xpos < min(cfg.mfend, T - 1))
            & (pos_y > cfg.mfthres)
            & present[:, None])
    amp = jnp.abs(raw - minsignal[:, None])
    # stable compaction: accepted slots first, original (amplitude-desc)
    # order — one multi-operand stable sort instead of argsort + three
    # take_along_axis gathers
    _, times_c, amps_c, valid_i = jax.lax.sort(
        ((~gate).astype(jnp.int32), jnp.where(gate, xpos, 0.0),
         jnp.where(gate, amp, 0.0), gate.astype(jnp.int32)),
        dimension=1, num_keys=1)
    valid_c = valid_i.astype(bool)
    npulse = jnp.sum(gate, axis=1).astype(jnp.int32)
    return PulseSearchResult(npulse=npulse, times=times_c, amps=amps_c,
                             valid=valid_c, mf=mf)
