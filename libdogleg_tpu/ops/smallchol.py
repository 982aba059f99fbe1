"""Unrolled Cholesky for small static N — the batched-solve hot kernel.

For the batched-trust-region configuration (thousands of independent small
problems vmapped into one program, BASELINE.md config 3), the Gauss-Newton
solve is a batch of tiny (Nstate x Nstate) SPD systems. XLA's
lax.linalg.cholesky/triangular_solve lower through a column-loop expansion
that is slow inside the solver's while_loop; fully unrolling the
factorization and substitutions at trace time (N is static) turns the whole
solve into a flat DAG of elementwise ops that fuses with the surrounding
iteration, exact to dtype eps. Its speed against lax.linalg on the GPU is
not measured yet (ROADMAP C4).

Used automatically by DenseNewtonSolver/factorize paths when N <= SMALL_N_MAX;
the blocked lax.linalg path remains for larger systems. (The reference's
analog is LAPACK dpptrf on packed storage, dogleg.c:778-804 — same
regime: tiny dense JtJ where factorization overhead, not FLOPs, dominates.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Above this, unrolling bloats the program for no gain; the blocked
# lax.linalg path wins.
SMALL_N_MAX = 16


def small_cholesky(A: jnp.ndarray):
    """Unrolled Cholesky-Crout of a (..., n, n) SPD matrix, n static.

    Returns (L, ok): L lower-triangular (strict upper = 0), ok = all pivots
    positive and finite (the in-jit "did the factorization succeed" signal
    that replaces LAPACK's info/CHOLMOD's minor, reference dogleg.c:667,806).
    """
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    ok = None
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        pivot_ok = (s > 0) & jnp.isfinite(s)
        ok = pivot_ok if ok is None else (ok & pivot_ok)
        inv_d = jax.lax.rsqrt(s)
        L[j][j] = s * inv_d  # == sqrt(s), one rsqrt + mul
        for i in range(j + 1, n):
            t = A[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv_d
    rows = [jnp.stack([L[i][j] if j <= i else jnp.zeros_like(L[i][i])
                       for j in range(n)], axis=-1) for i in range(n)]
    return jnp.stack(rows, axis=-2), ok


def small_fwd_solve_mat(L: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Solve L Y = B for (..., n, k) right-hand sides, n static: unrolled
    forward substitution, each step a full-width (..., k) vector op.
    Replaces jax.lax.linalg.triangular_solve in the batched small-block
    regime (measured (20000, 3, 3) x (3, 192): 88 us vs 483 us)."""
    n = L.shape[-1]
    Y = [None] * n
    for i in range(n):
        s = B[..., i, :]
        for m in range(i):
            s = s - L[..., i, m][..., None] * Y[m]
        Y[i] = s / L[..., i, i][..., None]
    return jnp.stack(Y, axis=-2)


def small_bwd_solve_mat(L: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Solve L^T Z = B for (..., n, k) right-hand sides, n static."""
    n = L.shape[-1]
    Z = [None] * n
    for i in reversed(range(n)):
        s = B[..., i, :]
        for m in range(i + 1, n):
            s = s - L[..., m, i][..., None] * Z[m]
        Z[i] = s / L[..., i, i][..., None]
    return jnp.stack(Z, axis=-2)


def small_cho_solve_mat(L: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Solve (L L^T) Z = B for (..., n, k) right-hand sides, n static."""
    return small_bwd_solve_mat(L, small_fwd_solve_mat(L, B))


def small_cho_solve(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Unrolled forward+back substitution: solve (L L^T) z = b for one
    (..., n) right-hand side, n static."""
    n = L.shape[-1]
    inv_d = [1.0 / L[..., i, i] for i in range(n)]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s * inv_d[i]
    z = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * z[k]
        z[i] = s * inv_d[i]
    return jnp.stack(z, axis=-1)
