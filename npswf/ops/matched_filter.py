"""Batched matched filter.

Batched replacement for the per-block correlation loop in FindPulsesMF
(ref TEST_2.C:145-171): an 11-tap normalized cross-correlation of each
block's waveform against its reversed reference kernel, with the baseline
(per-block signal minimum) subtracted per tap and the window minimum
subtracted afterwards so the filter output is non-negative.

Shapes: signal [..., B, T], kern_rev [B, W] (reversed, NOT normalized — see
CalibrationBundle.mfkern_rev), mfint [B]. The correlation is expressed as W
shifted multiply-add-divides in ascending tap order — acc += (delta*kern)/
mfint per tap, the reference's exact floating-point accumulation order
(ref :158-161), so fp64 runs are bit-equal to the macro's arithmetic; XLA
fuses the stack into a single vectorized loop over the batch.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from npswf.core.config import NPSConfig


def matched_filter(cfg: NPSConfig, signal: jnp.ndarray, minsignal: jnp.ndarray,
                   kern_rev: jnp.ndarray, mfint: jnp.ndarray) -> jnp.ndarray:
    """mf[..., b, it] for it in [mfleft, T-mfright); zero outside the window.

    Args:
      signal:    [..., B, T] raw waveforms.
      minsignal: [..., B] per-block minimum (baseline).
      kern_rev:  [B, W] reversed unnormalized kernel.
      mfint:     [B] kernel normalization (divided per tap, ref :161).
    Returns:
      [..., B, T] matched-filter output, window-min subtracted (ref :167-171).
    """
    T, W, R = cfg.ntime, cfg.mfwidth, cfg.mfright
    lo, hi = cfg.mfleft, T - cfg.mfright
    n = hi - lo
    delta = signal - minsignal[..., None]            # [..., B, T]
    inv = mfint[..., :, None]                        # [B, 1] divisor per tap
    acc = jnp.zeros(signal.shape[:-1] + (n,), signal.dtype)
    for jt in range(W):
        # window position it in [lo, hi) reads sample it + jt - mfright
        # (ref TEST_2.C:158 — mfright, not mfleft; identical under the
        # mfleft == mfright symmetry NPSConfig enforces). Per-tap divide by
        # mfint matches the macro's rounding exactly (ref :161).
        acc = acc + (delta[..., jt + lo - R: jt + lo - R + n]
                     * kern_rev[..., :, jt:jt + 1]) / inv
    mfmin = jnp.min(acc, axis=-1, keepdims=True)
    acc = acc - mfmin
    pad_lo = jnp.zeros(signal.shape[:-1] + (lo,), signal.dtype)
    pad_hi = jnp.zeros(signal.shape[:-1] + (T - hi,), signal.dtype)
    return jnp.concatenate([pad_lo, acc, pad_hi], axis=-1)
