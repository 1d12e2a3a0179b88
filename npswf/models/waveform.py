"""Waveform model family.

The reference hardcodes a single model inside its fit lambda
(ref TEST_2.C:621-635):

    f(x; p) = p0 + sum_n A_n * ref(x - t_n),   contribute iff 1 < x - t_n < 109

with ref() the block's cubic-spline-interpolated reference waveform. Here the
model is a pluggable family: each model provides batched evaluation and an
analytic Jacobian with respect to the physical parameter vector
``p = [ped, t_0, A_0, t_1, A_1, ...]`` (the reference's parameter layout,
ref TEST_2.C:660-665), so alternative pulse shapes can reuse the same LM
solver. Time parameters are relative to the block's reference time
(ref :662: seed = wftime - timeref).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import jax.numpy as jnp

from npswf.core.config import NPSConfig
from npswf.ops.spline import spline_eval_grad


class WaveformModel:
    """Protocol: batched model evaluation + analytic Jacobian."""

    name: str = "base"

    def prepare_aux(self, cfg: NPSConfig,
                    aux: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
        """One-time per-solve transformation of the aux tensors (e.g.
        coefficient-plane padding); called outside the LM loop."""
        return aux

    def eval_and_jac(self, cfg: NPSConfig, params: jnp.ndarray,
                     aux: Dict[str, jnp.ndarray], xgrid: jnp.ndarray,
                     pulse_mask: jnp.ndarray
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """params [N, M] -> (f [N, K], J [N, K, M])."""
        raise NotImplementedError


class SplineRefModel(WaveformModel):
    """Pedestal + sum of spline-interpolated reference pulses (the reference
    model, TEST_2.C:621-635). ``aux`` carries per-lane spline coefficient
    tensors: ``coeffs`` [N, S, 4] and ``x0`` [N]."""

    name = "spline_ref"

    def eval_and_jac(self, cfg, params, aux, xgrid, pulse_mask):
        coeffs, x0 = aux["coeffs"], aux["x0"]
        N, M = params.shape
        P = (M - 1) // 2
        K = xgrid.shape[0]
        ped = params[:, 0]
        tpar = params[:, 1::2]                          # [N, P]
        apar = params[:, 2::2]                          # [N, P]
        # arg[n, p, k] = x_k - t_{n,p}
        arg = xgrid[None, None, :] - tpar[:, :, None]   # [N, P, K]
        val, dval = spline_eval_grad(cfg, coeffs, x0, arg.reshape(N, P * K))
        val = val.reshape(N, P, K)
        dval = dval.reshape(N, P, K)
        act = pulse_mask[:, :, None].astype(params.dtype)
        f = ped[:, None] + jnp.sum(act * apar[:, :, None] * val, axis=1)  # [N, K]
        # d f / d t_p = -A_p * ref'(x - t_p); d f / d A_p = ref(x - t_p).
        # Columns are interleaved (t_0, A_0, t_1, A_1, ...) via stack+reshape
        # (no strided .at[::2].set scatter).
        Jt = (-act * apar[:, :, None] * dval).transpose(0, 2, 1)  # [N, K, P]
        Ja = (act * val).transpose(0, 2, 1)
        inter = jnp.stack([Jt, Ja], axis=-1).reshape(N, K, 2 * P)
        J = jnp.concatenate(
            [jnp.ones((N, K, 1), params.dtype), inter], axis=-1)
        return f, J


class GaussianPulseModel(WaveformModel):
    """Alternative pulse family: pedestal + sum of Gaussians of fixed width.

    Demonstrates the pluggable-model contract (the reference supports only
    the spline template; users wanting a different shape had to edit the TF1
    lambda, ref TEST_2.C:621-635). ``aux['width']`` [N] sets the per-lane
    sigma (bins)."""

    name = "gaussian"

    def eval_and_jac(self, cfg, params, aux, xgrid, pulse_mask):
        N, M = params.shape
        P = (M - 1) // 2
        w = aux["width"][:, None, None]                 # [N,1,1]
        # time parameters are relative to the block reference time when the
        # engine provides one (FitInputs.timeref; zero in direct solver use)
        center = aux.get("timeref")
        c = 0.0 if center is None else center[:, None, None]
        ped = params[:, 0]
        tpar = params[:, 1::2][:, :, None] + c          # [N,P,1] absolute
        apar = params[:, 2::2][:, :, None]
        act = pulse_mask[:, :, None].astype(params.dtype)
        z = (xgrid[None, None, :] - tpar) / w           # [N,P,K]
        val = jnp.exp(-0.5 * z * z)
        dval = val * z / w                              # d/dt exp(-(x-t)^2/2w^2)
        f = ped[:, None] + jnp.sum(act * apar * val, axis=1)
        Jt = (act * apar * dval).transpose(0, 2, 1)
        Ja = (act * val).transpose(0, 2, 1)
        inter = jnp.stack([Jt, Ja], axis=-1).reshape(N, xgrid.shape[0], 2 * P)
        J = jnp.concatenate(
            [jnp.ones((N, xgrid.shape[0], 1), params.dtype), inter], axis=-1)
        return f, J


class BiexpPulseModel(WaveformModel):
    """PMT-style pulse family: normalized difference of two exponentials.

    s(v) = N * (exp(-v/tau_d) - exp(-v/tau_r)) for v > 0, else 0, with
    v measured from the pulse ONSET; the parameterization is peak-aligned
    (t_n is the pulse PEAK time, like the gaussian family's center), and
    N normalizes the peak to 1 so amplitudes keep their meaning across
    families. ``aux['tau_r']``/``aux['tau_d']`` [N] are the rise/decay
    constants in bins (tau_d > tau_r)."""

    name = "biexp"

    def eval_and_jac(self, cfg, params, aux, xgrid, pulse_mask):
        N, M = params.shape
        K = xgrid.shape[0]
        tr = aux["tau_r"][:, None, None]                # [N,1,1]
        td = aux["tau_d"][:, None, None]
        center = aux.get("timeref")
        c = 0.0 if center is None else center[:, None, None]
        ped = params[:, 0]
        tpar = params[:, 1::2][:, :, None] + c          # [N,P,1] absolute peak
        apar = params[:, 2::2][:, :, None]
        act = pulse_mask[:, :, None].astype(params.dtype)
        # peak sits ustar after onset; normalize the peak value to 1
        ustar = jnp.log(td / tr) * tr * td / (td - tr)
        norm = 1.0 / (jnp.exp(-ustar / td) - jnp.exp(-ustar / tr))
        v = xgrid[None, None, :] - tpar + ustar         # time since onset
        pos = v > 0
        vs = jnp.where(pos, v, 0.0)                     # exp-safe gating
        ed = jnp.exp(-vs / td)
        er = jnp.exp(-vs / tr)
        val = jnp.where(pos, norm * (ed - er), 0.0)
        dvdv = jnp.where(pos, norm * (er / tr - ed / td), 0.0)  # d val / dv
        f = ped[:, None] + jnp.sum(act * apar * val, axis=1)
        # v = x - t + ustar, so d f/d t = -A * dval/dv
        Jt = (-act * apar * dvdv).transpose(0, 2, 1)
        Ja = (act * val).transpose(0, 2, 1)
        inter = jnp.stack([Jt, Ja], axis=-1).reshape(N, K, 2 * (M - 1) // 2)
        J = jnp.concatenate(
            [jnp.ones((N, K, 1), params.dtype), inter], axis=-1)
        return f, J


_REGISTRY: Dict[str, WaveformModel] = {}


def register_model(model: WaveformModel) -> WaveformModel:
    _REGISTRY[model.name] = model
    return model


def get_model(name: str) -> WaveformModel:
    return _REGISTRY[name]


register_model(SplineRefModel())
register_model(GaussianPulseModel())
register_model(BiexpPulseModel())
