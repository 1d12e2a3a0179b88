"""Batched small-matrix linear algebra for the LM solver.

The damped, Jacobi-scaled normal equations are symmetric positive definite by
construction (unit diagonal + lambda), so we use an unrolled outer-product
Cholesky with forward/back substitution: every step is a plain batched
vector op over [N, M] / [N, M, M] arrays, compile time linear
in M, no pivoting needed.
"""
from __future__ import annotations

import jax.numpy as jnp


def cholesky_solve(A: jnp.ndarray, b: jnp.ndarray,
                   eps: float = 1e-30) -> jnp.ndarray:
    """Solve A x = b for SPD A. A [N, M, M], b [N, M] -> x [N, M]."""
    N, M, _ = A.shape
    dtype = A.dtype
    idx = jnp.arange(M)

    # outer-product Cholesky: A = L L^T
    L = jnp.zeros_like(A)
    S = A
    for j in range(M):
        d = jnp.sqrt(jnp.maximum(S[:, j, j], eps))
        col = S[:, :, j] / d[:, None]
        col = jnp.where(idx[None, :] >= j, col, jnp.zeros((), dtype))
        L = L.at[:, :, j].set(col)          # static-index update-slice
        S = S - col[:, :, None] * col[:, None, :]

    # forward substitution L y = b (y[k>=i] are zero when row i is computed)
    y = jnp.zeros_like(b)
    for i in range(M):
        yi = (b[:, i] - jnp.sum(L[:, i, :] * y, axis=-1)) / L[:, i, i]
        y = y.at[:, i].set(yi)

    # back substitution L^T x = y
    x = jnp.zeros_like(b)
    for i in range(M - 1, -1, -1):
        xi = (y[:, i] - jnp.sum(L[:, :, i] * x, axis=-1)) / L[:, i, i]
        x = x.at[:, i].set(xi)
    return x
