"""Scalar numpy fp64 oracle of the reference pipeline semantics.

This module is the behavioral specification the batched JAX ops are tested
against. Each function is a faithful re-expression (NOT a copy) of the
corresponding reference routine, cited by file:line into /root/reference:

- ``matched_filter_golden``   <- FindPulsesMF matched-filter loop, TEST_2.C:145-171
- ``tspectrum_search_golden`` <- ROOT TSpectrum::Search / SearchHighRes semantics
                                 as invoked at TEST_2.C:187-188 (sigma=2,
                                 "nobackground,nodraw", threshold=0.02):
                                 mirror-extension, Markov smoothing
                                 (averWindow=3), Gold deconvolution of an
                                 integer-quantized Gaussian response
                                 (3 iterations), local-max + dual-threshold
                                 accept, 3-bin centroid, amplitude-descending
                                 insertion order
- ``find_pulses_golden``      <- peak gating + seed amplitudes, TEST_2.C:192-207
- ``cluster_gate_golden``     <- PassClusterThreshold, TEST_2.C:218-278
- ``decode_event_golden``     <- raw-stream unpack, TEST_2.C:854-889
- ``hms_correction_golden``   <- HMS timing + best-Samp* selection, TEST_2.C:893-939

These run in float64 scalar loops; they are oracles, not production code.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from npswf.core.config import NPSConfig


# ----------------------------------------------------------------------
# Matched filter (ref TEST_2.C:145-171)
# ----------------------------------------------------------------------
def matched_filter_golden(cfg: NPSConfig, sig: np.ndarray, minsignal: float,
                          kern_rev: np.ndarray, mfint: float) -> np.ndarray:
    """11-tap normalized cross-correlation with running-min subtraction.

    ``kern_rev`` is the reversed UNnormalized kernel (see
    CalibrationBundle.mfkern_rev); mf[it] = sum_j ((sig[it+j-mfright] - min)
    * kern_rev[j]) / mfint — the division happens PER TAP, exactly the
    macro's accumulation order (ref :158-161; :158 uses mfright, and
    NPSConfig enforces mfleft == mfright, without which the reference reads
    out of bounds), evaluated for it in [mfleft, ntime-mfright); then the
    window minimum is subtracted over the same range (ref :167-171).
    """
    T, W, R = cfg.ntime, cfg.mfwidth, cfg.mfright
    mf = np.zeros(T)
    lo, hi = cfg.mfleft, T - cfg.mfright
    for it in range(lo, hi):
        acc = 0.0
        for jt in range(W):
            acc += ((sig[it + jt - R] - minsignal) * kern_rev[jt]) / mfint
        mf[it] = acc
    mfmin = mf[lo:hi].min() if hi > lo else 0.0
    mf[lo:hi] -= mfmin
    return mf


# ----------------------------------------------------------------------
# TSpectrum::Search semantics (ref call site TEST_2.C:187-188)
# ----------------------------------------------------------------------
def _gaussian_response(sigma: float, size_ext: int):
    """Integer-quantized Gaussian response used by Gold deconvolution."""
    resp = np.zeros(size_ext)
    area = 0.0
    lh_gold = -1
    posit = 0
    maximum = 0.0
    for i in range(size_ext):
        lda = (i - 3.0 * sigma) ** 2 / (2.0 * sigma * sigma)
        q = float(int(1000.0 * math.exp(-lda)))  # truncation toward zero
        if q != 0.0:
            lh_gold = i + 1
        resp[i] = q
        area += q
        if q > maximum:
            maximum = q
            posit = i
    return resp, area, lh_gold, posit


def tspectrum_search_golden(source: np.ndarray, sigma: float = 2.0,
                            threshold_frac: float = 0.02, max_peaks: int = 12,
                            decon_iterations: int = 3, aver_window: int = 3
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """High-resolution peak search, "nobackground" path, Markov smoothing on.

    ``source`` is the histogram contents (the reference stores the matched
    filter into a float32-binned TH1F at TEST_2.C:173-179, so callers should
    pass float32-rounded values). Returns (pos_x, pos_y) in the Search()
    output convention: pos_x = bin centers (k + 0.5 with k the integer sample
    index), pos_y = source[k], ordered by descending source amplitude
    (TSpectrum insertion order).
    """
    src = np.asarray(source, dtype=np.float64)
    ssize = src.shape[0]
    threshold = 100.0 * threshold_frac  # percent, as Search passes it on
    shift = int(7.0 * sigma + 0.5)
    size_ext = ssize + 2 * shift

    # Low-edge slope estimate for the left extension (straight-line fit of
    # the first k = int(2*sigma+0.5) samples; positive slopes clamped to 0).
    k = int(2.0 * sigma + 0.5)
    l1low = 0.0
    if k >= 2:
        m0 = m1 = m2 = l0 = l1 = 0.0
        for i in range(k):
            a, b = float(i), src[i]
            m0 += 1.0
            m1 += a
            m2 += a * a
            l0 += b
            l1 += a * b
        det = m0 * m2 - m1 * m1
        l1low = (-l0 * m1 + l1 * m0) / det if det != 0.0 else 0.0
        if l1low > 0.0:
            l1low = 0.0

    ext = np.zeros(size_ext)
    for i in range(size_ext):
        if i < shift:
            v = src[0] + l1low * (i - shift)
            ext[i] = max(v, 0.0)
        elif i >= ssize + shift:
            ext[i] = max(src[ssize - 1], 0.0)
        else:
            ext[i] = src[i - shift]
    ext_orig = ext.copy()  # pre-smoothing spectrum, used for thresholds/sort

    # --- Markov smoothing (averWindow) ---
    maxch = ext.max()
    plocha = ext.sum()
    if maxch == 0.0:
        return np.zeros(0), np.zeros(0)
    w = np.zeros(size_ext)
    w[0] = 1.0
    nom = 1.0
    xmax = size_ext - 1
    for i in range(xmax):
        nip = ext[i] / maxch
        nim = ext[i + 1] / maxch
        sp = sm = 0.0
        for l in range(1, aver_window + 1):
            a = ext[min(i + l, xmax)] / maxch
            b = a - nip
            a = 1.0 if (a + nip) <= 0.0 else math.sqrt(a + nip)
            sp += math.exp(b / a)
            a = ext[max(i - l + 1, 0)] / maxch
            b = a - nim
            a = 1.0 if (a + nim) <= 0.0 else math.sqrt(a + nim)
            sm += math.exp(b / a)
        w[i + 1] = sp * w[i] / sm
        nom += w[i + 1]
    smoothed = (w / nom) * plocha

    # --- Gold deconvolution with the quantized Gaussian response ---
    resp, area, lh_gold, posit = _gaussian_response(sigma, size_ext)
    L = lh_gold - 1
    src_abs = np.abs(smoothed)

    # autocorrelation of the response (vector b), lags -L..L
    bvec = np.zeros(2 * L + 1)
    for lag in range(-L, L + 1):
        jmin = 0 if lag >= 0 else -lag
        jmax = min(L, L - lag)
        acc = 0.0
        for j in range(jmin, jmax + 1):
            acc += resp[j] * resp[lag + j]
        bvec[lag + L] = acc

    # correlation of response with the smoothed spectrum (vector p),
    # offsets -L .. size_ext+L-1
    pvec = np.zeros(size_ext + 2 * L)
    for off in range(-L, size_ext + L):
        acc = 0.0
        for j in range(L + 1):
            kk = off + j
            if 0 <= kk < size_ext:
                acc += resp[j] * src_abs[kk]
        pvec[off + L] = acc

    x = np.ones(size_ext)
    prev = np.zeros(size_ext)  # stale-value buffer (working_space[3*size_ext+..])
    for _ in range(decon_iterations):
        xnew = prev.copy()
        for i in range(size_ext):
            num = pvec[i]  # p at offset (i - L), stored with +L bias
            if abs(num) > 1e-5 and abs(x[i]) > 1e-5:
                jmin = -min(L, i)
                jmax = min(L, size_ext - 1 - i)
                den = 0.0
                for j in range(jmin, jmax + 1):
                    den += bvec[j + L] * x[i + j]
                factor = num / den if (den != 0.0 and num != 0.0) else 0.0
                xnew[i] = factor * x[i]
        prev = xnew.copy()
        x = xnew
    # circular shift by the response maximum position
    shifted = np.zeros(size_ext)
    for i in range(size_ext):
        shifted[(i + posit) % size_ext] = x[i]
    decon = np.zeros(size_ext)
    maximum_decon = 0.0
    maximum = 0.0
    for i in range(size_ext - L):
        if shift <= i < ssize + shift:
            decon[i] = area * shifted[i + L]
            maximum_decon = max(maximum_decon, decon[i])
            maximum = max(maximum, ext_orig[i])

    # SearchHighRes accepts at threshold*maximum_decon/100 (threshold is in
    # percent here, = 100*Search's fraction); no min(1, .) clamp.
    rel = threshold / 100.0

    # --- local-max accept + 3-bin centroid + amplitude-descending insert ---
    positions: list = []  # centroid positions a, kept sorted by ext_orig key desc
    for i in range(1, size_ext - 1):
        if not (decon[i] > decon[i - 1] and decon[i] > decon[i + 1]):
            continue
        if not (shift <= i < ssize + shift):
            continue
        if not (decon[i] > rel * maximum_decon
                and ext_orig[i] > threshold * maximum / 100.0):
            continue
        num = den = 0.0
        for j in range(i - 1, i + 2):
            num += (j - shift) * decon[j]
            den += decon[j]
        a = num / den
        a = min(max(a, 0.0), ssize - 1.0)
        key = ext_orig[shift + int(a)]
        # stable descending insertion (ties keep detection order), capped
        ins = len(positions)
        for jj, (k2, _) in enumerate(positions):
            if key > k2:
                ins = jj
                break
        positions.insert(ins, (key, a))
        if len(positions) > max_peaks:
            positions.pop()

    pos_x = np.array([math.floor(a + 0.5) + 0.5 for _, a in positions])
    pos_y = np.array([src[int(math.floor(a + 0.5))] for _, a in positions])
    return pos_x, pos_y


# ----------------------------------------------------------------------
# Peak gating + seeds (ref TEST_2.C:192-207)
# ----------------------------------------------------------------------
def find_pulses_golden(cfg: NPSConfig, sig: np.ndarray, minsignal: float,
                       kern_rev: np.ndarray, mfint: float, present: bool
                       ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Matched filter -> TSpectrum -> gates; returns (npulse, times, amps).

    Times are xpos = (TSpectrum bin center) - 2.0 in sample units (the -2 bin
    shift quirk, ref :194); amps are |raw[round(xpos)] - minsignal|.
    Output order is TSpectrum's amplitude-descending order.
    """
    if not present:
        return 0, np.zeros(0), np.zeros(0)
    mf = matched_filter_golden(cfg, sig, minsignal, kern_rev, mfint)
    mf32 = mf.astype(np.float32).astype(np.float64)  # TH1F float32 bins (ref :173-179)
    pos_x, pos_y = tspectrum_search_golden(
        mf32, sigma=cfg.spec_sigma, threshold_frac=cfg.specthres,
        max_peaks=cfg.maxwfpulses, decon_iterations=cfg.spec_decon_iterations,
        aver_window=cfg.spec_aver_window)
    times, amps = [], []
    for xp, yp in zip(pos_x, pos_y):
        x = xp - 2.0
        if x > max(cfg.mfstart, 0) and x < min(cfg.mfend, cfg.ntime - 1) and yp > cfg.mfthres:
            # C++ std::round = half away from zero (x is positive here);
            # Python's round() is banker's rounding and would differ.
            ti = int(math.floor(x + 0.5))
            amps.append(abs(sig[ti] - minsignal))
            times.append(x)
            if len(times) >= cfg.maxwfpulses:
                break
    return len(times), np.array(times), np.array(amps)


# ----------------------------------------------------------------------
# 3x3 cluster trigger gate (ref TEST_2.C:218-278)
# ----------------------------------------------------------------------
def cluster_gate_golden(cfg: NPSConfig, signal: np.ndarray, pres: np.ndarray,
                        bn: int, timeref_bin: float, timerefacc: float) -> bool:
    """Pass iff (max 3x3-sum in the +-coinc_width window) - (global min) > thres.

    ``signal`` is [nblocks, ntime]; neighbors use the row-major 36x30 grid with
    row = bn / ncol, col = bn % ncol (ref :234-235); absent neighbors excluded.
    NOTE (parity): the reference checks ``nr < nlin`` for a row index derived
    by dividing by ncol (ref :254) — rows range over [0, nlin).
    """
    center = timeref_bin + timerefacc
    row, col = bn // cfg.ncol, bn % cfg.ncol
    d8 = [(0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)]
    gmin, wmax = 1e6, -1e6
    for it in range(cfg.ntime):
        s = signal[bn, it]
        for dr, dc in d8:
            nr, nc = row + dr, col + dc
            if nr < 0 or nr >= cfg.nlin or nc < 0 or nc >= cfg.ncol:
                continue
            nb = nr * cfg.ncol + nc
            if pres[nb] == 1:
                s += signal[nb, it]
        gmin = min(gmin, s)
        if abs(float(it) - center) < cfg.coinc_width:
            wmax = max(wmax, s)
    return (wmax - gmin) > cfg.trig_thres


# ----------------------------------------------------------------------
# Raw-stream decode (ref TEST_2.C:854-889)
# ----------------------------------------------------------------------
def decode_event_golden(cfg: NPSConfig, stream: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Unpack the [blk, nsamp, s0..s(nsamp-1)]* stream.

    Returns (signal[nblocks, ntime], pres[nslots], minsignal[nblocks], bad).
    Slots 2000/2001 remap to 1080/1081 (scintillators) and are flagged present
    but carry no samples into ``signal`` (ref :862-865, 881-886). ``bad`` is
    -1 for a clean decode, the offending slot id when a slot outside
    [0, nslots) aborts the decode (ref :867-872), -2 when an nsamp runs past
    the event's stream (truncated/corrupt event; samples are clamped, never
    read out of range), and -3 when the whole stream exceeds ndata_max and
    the event is skipped (ref :830-836). Samples past ntime are dropped
    (matching the native decoder's clamp; the reference's fixed
    signal[bloc*ntime + it] write would corrupt neighbors there — UB we
    define away).
    """
    B, T = cfg.nblocks, cfg.ntime
    signal = np.zeros((B, T))
    pres = np.zeros(cfg.nslots, dtype=np.int32)
    minsignal = np.full(B, 1e6)
    ns = 0
    n = stream.shape[0]
    bad = -1
    if n > cfg.ndata_max:                        # Ndata guard (ref :830-836)
        return signal, pres, minsignal, -3
    while ns + 2 <= n:
        bloc = int(stream[ns]); ns += 1
        nsamp = int(stream[ns]); ns += 1
        if bloc == cfg.scint_slot_a:
            bloc = 1080
        if bloc == cfg.scint_slot_b:
            bloc = 1081
        if bloc < 0 or bloc > cfg.nslots - 0.5:
            bad = bloc
            break
        pres[bloc] = 1
        if ns + nsamp > n:
            bad = -2
        lim = min(nsamp, T, n - ns)
        if 0 <= bloc < B:
            for it in range(lim):
                signal[bloc, it] = stream[ns + it]
                minsignal[bloc] = min(minsignal[bloc], signal[bloc, it])
        ns += nsamp
    return signal, pres, minsignal, bad


# ----------------------------------------------------------------------
# HMS timing correction + best-Samp* selection (ref TEST_2.C:893-939)
# ----------------------------------------------------------------------
def hms_correction_golden(cfg: NPSConfig, tdcoffset: np.ndarray,
                          timemean2: np.ndarray, adc_counter: np.ndarray,
                          pulse_time: np.ndarray, pulse_time_raw: np.ndarray,
                          pulse_amp: np.ndarray, pulse_int: np.ndarray,
                          pulse_ped: np.ndarray):
    """corr_time_HMS from the first hit; per-block best-pulse selection.

    Best pulse = the hit whose SampPulseTime is closest to timemean2[block]
    (first hit wins ties by strict >, ref :928-937).
    Returns (corr_time_HMS, Sampampl, Samptime, Sampener, Sampped, Npulse).
    """
    B = cfg.nblocks
    corr = 0.0
    sampampl = np.full(B, -100.0)
    samptime = np.full(B, -100.0)
    sampener = np.full(B, -100.0)
    sampped = np.full(B, -100.0)
    npulse = np.zeros(B)
    for i in range(adc_counter.shape[0]):
        c = int(adc_counter[i])
        if c == cfg.scint_slot_a:
            c = 1080
        if c == cfg.scint_slot_b:
            c = 1081
        if i == 0:
            # NOTE (parity): the reference indexes tdcoffset[1080/1081] for
            # scintillator hits, reading past the array (UB, ref :903); we
            # treat out-of-range offsets as 0.
            off = tdcoffset[c] if 0 <= c < B else 0.0
            corr = pulse_time[i] - pulse_time_raw[i] / 16.0 - off
        if 0 <= c < B:
            npulse[c] += 1
            take = npulse[c] == 1
            if npulse[c] > 1:
                take = (abs(samptime[c] - timemean2[c])
                        > abs(pulse_time[i] - timemean2[c]))
            if take:
                sampampl[c] = pulse_amp[i]
                samptime[c] = pulse_time[i]
                sampener[c] = pulse_int[i]
                sampped[c] = pulse_ped[i]
    return corr, sampampl, samptime, sampener, sampped, npulse


# ----------------------------------------------------------------------
# Derived diagnostics (ref TEST_2.C:1026-1112)
# ----------------------------------------------------------------------
def diagnostics_golden(cfg: NPSConfig, signal: np.ndarray):
    """Scalar port of the post-fit diagnostics loop for one event.

    signal [nblocks, ntime]; returns dict of per-block arrays + totals,
    mirroring the reference's exact accumulation order (ener subtracts the
    bkg SUM scaled by window ratio before bkg becomes the mean, :1061-1063;
    widths use the overwrite-scan semantics, :1083-1107).
    """
    B, T = signal.shape
    binmin, binmax = 30, 109
    ener = np.zeros(B)
    integ = np.zeros(B)
    bkg = np.zeros(B)
    noise = np.zeros(B)
    sigmax = np.full(B, -100.0)
    tmax = np.zeros(B)
    ampl = np.full(B, -100.0)
    enertot = 0.0
    integtot = 0.0
    nwin = binmax - binmin - 1
    for i in range(B):
        for it in range(T):
            v = signal[i, it]
            integ[i] += v
            integtot += v
            if binmin < it < binmax:
                ener[i] += v
                enertot += v
            else:
                bkg[i] += v
            if v > sigmax[i]:
                tmax[i] = it
                sigmax[i] = v
                ampl[i] = v
        ener[i] -= bkg[i] * nwin / (T - nwin)
        bkg[i] = bkg[i] / (T - nwin)
        for it in range(T):
            if not (binmin < it < binmax):
                noise[i] += (signal[i, it] - bkg[i]) ** 2 / (T - nwin)
        noise[i] = math.sqrt(noise[i])
    return {"ener": ener, "integ": integ, "bkg": bkg, "noise": noise,
            "sigmax": sigmax, "time": tmax, "ampl": ampl,
            "enertot": enertot, "integtot": integtot}
