"""Per-sample error model for the chi^2 fit.

Reference semantics (TEST_2.C:946-955): e = sqrt(|y| * 4.096 / 2) / 4.096,
with any e < 1 replaced by the y=1 floor value (~0.349 counts). Note the
reference computes errors from ALL samples of the block but only bins
[fit_lo_bin, fit_hi_bin) enter the fit (ref :681-688).
"""
from __future__ import annotations

import jax.numpy as jnp

from npswf.core.config import NPSConfig


def error_model(cfg: NPSConfig, y: jnp.ndarray) -> jnp.ndarray:
    s = cfg.err_scale
    e = jnp.sqrt(jnp.abs(y * s / 2.0)) / s
    floor = jnp.sqrt(jnp.abs(cfg.err_floor_input * s / 2.0)) / s
    return jnp.where(e < 1.0, floor, e)
