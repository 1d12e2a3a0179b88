"""Batched natural-cubic-spline evaluation with the model support gate.

Batched replacement for the per-fit ``ROOT::Math::Interpolator``
construction + Eval calls (ref TEST_2.C:612-635): coefficients are
precomputed once per block on the host (core.calibration), and evaluation is
a segment gather + Horner step, with analytic first derivative for the fit
Jacobian (replacing Minuit2's numerical gradients).

Knots are the reference waveform's time axis, assumed uniform with unit
spacing (load_calibration validates np.diff(xs) == 1 per block and rejects
files that violate it); the model support gate
``spline_gate_lo < dt0 < ntime-1`` (ref :629-632) zeroes contributions
outside the pulse support.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from npswf.core.config import NPSConfig

# spline_mode="auto" per platform: the gather on the CPU, and on the H100,
# where it measured 3.7x faster than the one-hot product in the fit
# (PERF.md). A platform not listed takes the gather.
_AUTO_SPLINE_MODE = {"cpu": "gather", "gpu": "gather"}


def spline_mode(cfg: NPSConfig, platform: Optional[str] = None) -> str:
    """Resolved segment-selection mode ("gather" or "onehot") for
    ``platform`` (default: JAX's default backend). Both modes select the
    same coefficients exactly; the choice is speed only."""
    if cfg.spline_mode != "auto":
        return cfg.spline_mode
    if platform is None:
        platform = jax.default_backend()
    return _AUTO_SPLINE_MODE.get(platform, "gather")


def spline_eval(cfg: NPSConfig, coeffs: jnp.ndarray, x0: jnp.ndarray,
                t: jnp.ndarray) -> jnp.ndarray:
    """Evaluate s(t) (no gate). coeffs [..., S, 4], x0 [...], t [..., K]."""
    nseg = coeffs.shape[-2]
    rel = t - x0[..., None]
    idx = jnp.clip(jnp.floor(rel).astype(jnp.int32), 0, nseg - 1)
    u = rel - idx.astype(t.dtype)
    c4 = jnp.take_along_axis(coeffs, idx[..., None], axis=-2)  # one gather
    a, b, c, d = c4[..., 0], c4[..., 1], c4[..., 2], c4[..., 3]
    return ((d * u + c) * u + b) * u + a


def spline_eval_grad(cfg: NPSConfig, coeffs: jnp.ndarray, x0: jnp.ndarray,
                     t: jnp.ndarray):
    """(s(t), s'(t)) with the support gate applied; zero outside.

    The gate matches ref TEST_2.C:629: contribute iff
    spline_gate_lo < t < ntime - 1.

    Segment-coefficient selection strategy is ``spline_mode(cfg)``:
      - "gather": one take_along_axis;
      - "onehot": one-hot segment matmul — numerically EXACT (each row has
        a single 1.0; products by 1.0 and sums of zeros are exact), so both
        modes select identical coefficients. The compiled programs around
        them may still fuse differently, so fp32 fit outputs can differ in
        their last bits.
    """
    nseg = coeffs.shape[-2]
    rel = t - x0[..., None]
    idx = jnp.clip(jnp.floor(rel).astype(jnp.int32), 0, nseg - 1)
    u = rel - idx.astype(t.dtype)
    mode = spline_mode(cfg)
    # one-hot materializes [..., Q, S]; only worthwhile for narrow Q
    # (the small fit bucket) — wide-Q lanes fall back to the gather.
    if mode == "onehot" and t.shape[-1] <= 384:
        oh = jax.nn.one_hot(idx, nseg, dtype=t.dtype)               # [..., Q, S]
        # HIGHEST precision is required for exactness: a reduced-precision
        # matmul (bf16 or TF32 operands) would round the coefficients
        c4 = jnp.einsum("...qs,...sf->...qf", oh, coeffs,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=t.dtype)             # [..., Q, 4]
    else:
        c4 = jnp.take_along_axis(coeffs, idx[..., None], axis=-2)   # one gather
    a, b, c, d = c4[..., 0], c4[..., 1], c4[..., 2], c4[..., 3]
    val = ((d * u + c) * u + b) * u + a
    dval = (3.0 * d * u + 2.0 * c) * u + b
    gate = (t > cfg.spline_gate_lo) & (t < cfg.ntime - 1)
    zero = jnp.zeros_like(val)
    return jnp.where(gate, val, zero), jnp.where(gate, dval, zero)
