"""Device-mesh sharding of the event pipeline.

Multi-device replacement for the reference's thread runtime
(``ROOT::EnableImplicitMT`` + RDataFrame event buckets, ref TEST_2.C:313,
345): the event batch is sharded over a ``jax.sharding.Mesh`` with two axes:

- ``data``  — events (pure data parallelism; events are independent, so no
  communication is needed — the reference's only parallel strategy),
- ``block`` — calorimeter rows (tensor/spatial parallelism over the 36x30
  grid). The matched filter, peak search, and fits are block-local; the one
  cross-block computation, the 3x3 cluster stencil, exchanges single-row
  halos between neighboring shards with ``lax.ppermute`` (NVLink on a
  multi-GPU host; every card reaches every other at the same rate, so the
  mesh shape follows the algorithm, not a torus).

The fit success/failure counters — the only cross-event state in the whole
pipeline (the reference's atomics, TEST_2.C:61-62) — are psum-reduced across
the mesh.

The pipeline runs under ``shard_map`` so every collective is explicit; there
is no pipeline or expert parallelism because the workload has no sequential
stages or experts to shard (see SURVEY.md section 2).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from npswf.core.config import NPSConfig
from npswf.engine.pipeline import EventBatch, PipelineOutput, process_batch


def make_mesh(cfg: NPSConfig, n_data: Optional[int] = None, n_block: int = 1,
              devices=None) -> Mesh:
    """Mesh over (data, block). ``n_block`` must divide nlin (row bands)."""
    devices = list(jax.devices()) if devices is None else list(devices)
    if n_data is None:
        n_data = len(devices) // n_block
    need = n_data * n_block
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    if cfg.nlin % n_block != 0:
        raise ValueError(f"n_block={n_block} must divide nlin={cfg.nlin}")
    dev = np.asarray(devices[:need]).reshape(n_data, n_block)
    return Mesh(dev, (cfg.mesh_data_axis, cfg.mesh_block_axis))


# per-block calibration tensors sharded along the block axis
_BLOCK_SHARDED = ("timeref", "preswf", "mfkern_rev", "mfint", "tdcoffset",
                  "cortime", "timemean2", "spline_coeffs", "spline_x0")


def _calib_specs(cfg: NPSConfig, calib: Dict[str, jnp.ndarray]):
    specs = {}
    for k, v in calib.items():
        if k in _BLOCK_SHARDED:
            specs[k] = P(cfg.mesh_block_axis, *([None] * (v.ndim - 1)))
        else:
            specs[k] = P()
    return specs


def _batch_specs(cfg: NPSConfig) -> EventBatch:
    d, b = cfg.mesh_data_axis, cfg.mesh_block_axis
    return EventBatch(signal=P(d, b, None), pres=P(d, b),
                      corr_time_HMS=P(d), evt=P(d), runnum=P(d),
                      minsignal=P(d, b))


def _output_specs(cfg: NPSConfig) -> PipelineOutput:
    d, b = cfg.mesh_data_axis, cfg.mesh_block_axis
    eb = P(d, b)
    ebp = P(d, b, None)
    e = P(d)
    return PipelineOutput(
        wfnpulse=eb, wftime=ebp, wfampl=ebp, pulse_valid=ebp, chi2=eb,
        timewf=eb, amplwf=eb, pedwf=eb, gate=eb, fit_converged=eb,
        fit_n_iter=eb,
        h1time=ebp, h2time=ebp, h_mask=ebp,
        ampl=eb, ener=eb, integ=eb, bkg=eb, noise=eb,
        enertot=e, integtot=e,
        n_fit_success=P(), n_fit_failure=P(), n_fit_dropped=P(),
        n_high_pulse=P(), n_search_dropped=P(), search_overflow=eb)


def shard_calibration(cfg: NPSConfig, calib: Dict[str, jnp.ndarray],
                      mesh: Mesh) -> Dict[str, jnp.ndarray]:
    specs = _calib_specs(cfg, calib)
    return {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, specs[k]))
            for k, v in calib.items()}


def shard_event_batch(cfg: NPSConfig, batch: EventBatch, mesh: Mesh) -> EventBatch:
    if batch.minsignal is None:  # dense batch: min over all T samples
        batch = batch._replace(minsignal=jnp.min(batch.signal, axis=-1))
    specs = _batch_specs(cfg)
    return EventBatch(*[jax.device_put(jnp.asarray(v), NamedSharding(mesh, s))
                        for v, s in zip(batch, specs)])


def make_sharded_pipeline(cfg: NPSConfig, calib: Dict[str, jnp.ndarray],
                          mesh: Mesh):
    """jit(shard_map(pipeline)) over the mesh; takes a (sharded) EventBatch."""
    n_block = mesh.shape[cfg.mesh_block_axis]
    calib_specs = _calib_specs(cfg, calib)
    axes = tuple(mesh.axis_names)

    def body(calib_local, batch_local):
        return process_batch(cfg, calib_local, batch_local,
                             block_axis=cfg.mesh_block_axis,
                             block_shards=n_block,
                             reduce_axes=axes)

    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(calib_specs, _batch_specs(cfg)),
        out_specs=_output_specs(cfg))
    jitted = jax.jit(mapped)
    return lambda batch: jitted(calib, batch)
