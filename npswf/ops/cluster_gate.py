"""Batched 3x3 cluster trigger gate.

Batched replacement for PassClusterThreshold (ref TEST_2.C:218-278): for
each block, sum the waveforms of the block and its 8 grid neighbors at every
time bin (absent blocks contribute zero — their waveforms are zero-filled,
matching the reference's pres-gated accumulation), then pass iff the maximum
of that sum inside the +-coinc_width coincidence window around
(timeref + timerefacc) minus the global minimum exceeds trig_thres.

Instead of a per-block loop, the whole event batch is reshaped onto the
nlin x ncol calorimeter grid and the 9-point stencil is computed with eight
shifted adds (in the reference's accumulation order, for fp parity).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from npswf.core.config import NPSConfig

# neighbor order as in ref TEST_2.C:247-248 (dR, dC)
_NEIGHBORS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))


def cluster_sums(cfg: NPSConfig, signal: jnp.ndarray,
                 block_axis: Optional[str] = None,
                 block_shards: int = 1) -> jnp.ndarray:
    """3x3 neighborhood sums. signal [..., B, T] -> [..., B, T].

    When the calorimeter rows are sharded across a mesh axis (``block_axis``
    inside shard_map), the one-row halos are exchanged with
    ``lax.ppermute`` over ICI — devices at the grid edges receive zeros,
    matching the zero contribution of out-of-grid neighbors.
    """
    lead = signal.shape[:-2]
    T = cfg.ntime
    nrows = signal.shape[-2] // cfg.ncol   # local rows (nlin / block_shards)
    grid = signal.reshape(lead + (nrows, cfg.ncol, T))
    if block_axis is None or block_shards <= 1:
        padded = jnp.pad(grid, [(0, 0)] * len(lead) + [(1, 1), (1, 1), (0, 0)])
    else:
        fwd = [(i, i + 1) for i in range(block_shards - 1)]
        bwd = [(i + 1, i) for i in range(block_shards - 1)]
        # my last row -> next shard's top halo; my first row -> previous
        # shard's bottom halo; edge shards receive zeros from ppermute.
        top = jax.lax.ppermute(grid[..., -1:, :, :], block_axis, fwd)
        bottom = jax.lax.ppermute(grid[..., :1, :, :], block_axis, bwd)
        rows = jnp.concatenate([top, grid, bottom], axis=-3)
        padded = jnp.pad(rows, [(0, 0)] * len(lead) + [(0, 0), (1, 1), (0, 0)])
    acc = grid
    for dr, dc in _NEIGHBORS:
        acc = acc + padded[..., 1 + dr:1 + dr + nrows,
                           1 + dc:1 + dc + cfg.ncol, :]
    return acc.reshape(lead + (nrows * cfg.ncol, T))


def cluster_gate(cfg: NPSConfig, signal: jnp.ndarray, timeref: jnp.ndarray,
                 timerefacc, block_axis: Optional[str] = None,
                 block_shards: int = 1) -> jnp.ndarray:
    """Gate decision per block. signal [..., B, T] -> bool [..., B].

    ``timeref`` [B] is the per-block reference-max bin; the coincidence window
    is |it - (timeref + timerefacc)| < coinc_width (ref :231-232, 267).
    """
    s33 = cluster_sums(cfg, signal, block_axis, block_shards)
    center = timeref + timerefacc                              # [B]
    it = jnp.arange(cfg.ntime, dtype=signal.dtype)
    in_window = jnp.abs(it[None, :] - center[:, None]) < cfg.coinc_width  # [B, T]
    gmin = jnp.min(s33, axis=-1)
    big = jnp.asarray(1e6, signal.dtype)
    wmax = jnp.max(jnp.where(in_window, s33, -big), axis=-1)
    # reference inits maxInWindow = -1e6 and never guards an empty window
    # (ref :239, 269-272); with coinc_width=20 the window is never empty.
    return (wmax - gmin) > cfg.trig_thres
