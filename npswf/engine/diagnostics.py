"""Derived per-block diagnostics.

Batched equivalent of the post-fit diagnostics loop in ``analyze``
(ref TEST_2.C:1026-1112): integrals/energies in the (binmin, binmax) window,
background mean and RMS noise, pulse maximum (first-occurrence argmax, ref
:1051-1057 strict >), 50%/90% widths with the reference's overwrite-scan
semantics (max = LAST qualifying bin right of the max, min = FIRST qualifying
bin left of it, ref :1083-1107), and the event totals enertot/integtot.

All quantities are computed for every block regardless of presence, exactly
as the reference's unconditional block loop does.
"""
from __future__ import annotations

from typing import Dict

import jax.numpy as jnp

from npswf.core.config import NPSConfig

BINMIN = 30   # cosmic-pulse window (ref :1029-1030)
BINMAX = 109


def block_diagnostics(cfg: NPSConfig, signal: jnp.ndarray) -> Dict[str, jnp.ndarray]:
    """signal [..., B, T] -> dict of [..., B] diagnostics (+ [...] totals)."""
    import numpy as np
    T = cfg.ntime
    it = jnp.asarray(np.arange(T))
    in_win = jnp.asarray((np.arange(T) > BINMIN) & (np.arange(T) < BINMAX))  # 78 bins
    nwin = int(((np.arange(T) > BINMIN) & (np.arange(T) < BINMAX)).sum())
    nbkg = T - nwin

    integ = jnp.sum(signal, axis=-1)
    ener_raw = jnp.sum(jnp.where(in_win, signal, 0.0), axis=-1)
    bkg_sum = jnp.sum(jnp.where(~in_win, signal, 0.0), axis=-1)
    # ener -= bkg_sum * nwin / nbkg, THEN bkg becomes the mean (ref :1061-1063)
    ener = ener_raw - bkg_sum * nwin / nbkg
    bkg = bkg_sum / nbkg
    noise = jnp.sqrt(jnp.sum(jnp.where(
        ~in_win, (signal - bkg[..., None]) ** 2, 0.0), axis=-1) / nbkg)

    # pulse maximum: strict > scan keeps the FIRST occurrence (ref :1051-1057)
    tmax = jnp.argmax(signal, axis=-1)                     # first max
    sigmax = jnp.max(signal, axis=-1)
    ampl = sigmax
    ampl2 = ampl - bkg

    rel = signal - bkg[..., None]
    c50 = rel >= ampl2[..., None] * 0.5
    c90 = rel >= ampl2[..., None] * 0.1
    itb = jnp.broadcast_to(it, signal.shape)
    right_m = itb >= tmax[..., None]
    left_m = itb <= tmax[..., None]
    # defaults when no bin qualifies (ref :1078-1081)
    max50 = jnp.max(jnp.where(right_m & c50, itb, 0), axis=-1)
    max90 = jnp.max(jnp.where(right_m & c90, itb, 50), axis=-1)
    min50 = jnp.min(jnp.where(left_m & c50, itb, 100), axis=-1)
    min90 = jnp.min(jnp.where(left_m & c90, itb, 100), axis=-1)
    larg50 = (max50 - min50).astype(signal.dtype)
    larg90 = (max90 - min90).astype(signal.dtype)

    return {
        "integ": integ, "ener": ener, "bkg": bkg, "noise": noise,
        "sigmax": sigmax, "ampl": ampl, "ampl2": ampl2,
        "time": tmax.astype(signal.dtype),
        "larg50": larg50, "larg90": larg90,
        "enertot": jnp.sum(ener_raw, axis=-1),
        "integtot": jnp.sum(integ, axis=-1),
    }
