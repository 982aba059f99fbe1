"""Large-N dense Cholesky: recursive blocked right-looking, GEMM-dominant.

This replaces XLA's lax.linalg.cholesky for large n; whether it beats
cuSOLVER on the GPU is not measured (ROADMAP A6). ops/blockchol.py covers
the BATCHED mid-size regime but is trace-time-unrolled (compile cost grows ~n^2/256), capping it
at n<=256. This module covers single/small-batch LARGE n by restructuring
so ~97% of the flops are large HIGHEST-precision GEMMs:

  outer loop (static, n/256 panels of width 256):
    1. factor the diagonal block      — _chol_fori: a fori_loop over
       16-wide sub-panels (compile-size O(1) in n; the trailing update
       inside runs full-width with masked rows, trading ~6x flops on 3%
       of the work for a non-unrolled loop body)
    2. invert it (lower-triangular)   — _tri_inv: static recursion, all
       GEMMs except unrolled 16x16 leaves; turns the panel trsm into a
       GEMM (the cuBLAS/MAGMA trick)
    3. panel = W[rest, kk] @ inv(Lkk)^T          (GEMM)
    4. trailing update W[rest, rest] -= P @ P^T  (GEMM)

The reference's analog is LAPACK dpotrf's blocked right-looking algorithm
(reference dogleg.c:778-804 calls dpotrf_); this is that algorithm
re-shaped so the trailing updates — which carry (1 - (panel/n)^2) of the
n^3/3 flops — run as large matrix products.

Numerics: all contractions run at Precision.HIGHEST (true-f32 multiplies);
the explicit triangular inverse costs a modest constant-factor in backward
error vs substitution (standard for GPU BLAS trsm) and composes with
the compensated iterative refinement in ops/newton (refine_iters) when
tighter solves are needed.

Failure contract matches smallchol/blockchol: returns (L, ok) where ok is
the all-pivots-positive-and-finite flag (the in-jit dpotrf info signal,
reference dogleg.c:667,806) used by the lambda-escalation retry loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from libdogleg_tpu.ops import smallchol
from libdogleg_tpu.ops.blockchol import _pad_to_block, _trsm_right_lt

_HI = jax.lax.Precision.HIGHEST

SUB = 16      # fori sub-panel width (matches smallchol's unroll sweet spot)
PANEL = 256   # outer panel width: trailing GEMMs carry >=97% of flops


def _chol_fori(W: jnp.ndarray):
    """Cholesky of (..., p, p) with p a multiple of SUB, via a fori_loop
    over SUB-wide panels. Compile size is independent of p (one loop
    body); runtime trailing updates run full-width with rows above the
    panel masked to zero — extra flops, but all GEMM, and p is only ever
    the small diagonal block of the outer factorization."""
    p = W.shape[-1]
    nb = p // SUB
    idx = jnp.arange(p)

    def body(k, carry):
        W, L, ok = carry
        j0 = k * SUB
        col = jax.lax.dynamic_slice_in_dim(W, j0, SUB, axis=-1)
        D = jax.lax.dynamic_slice_in_dim(col, j0, SUB, axis=-2)
        Lkk, okk = smallchol.small_cholesky(D)
        X = _trsm_right_lt(col, Lkk)            # all p rows; only rows
        below = (idx >= j0 + SUB)[:, None]      # below the panel are real
        Xm = jnp.where(below, X, 0)
        W = W - jnp.matmul(Xm, jnp.swapaxes(Xm, -1, -2), precision=_HI)
        Lcol = jax.lax.dynamic_update_slice_in_dim(Xm, Lkk, j0, axis=-2)
        L = jax.lax.dynamic_update_slice_in_dim(L, Lcol, j0, axis=-1)
        return W, L, ok & okk

    ok0 = jnp.ones(W.shape[:-2], bool)
    _, L, ok = jax.lax.fori_loop(0, nb, body, (W, jnp.zeros_like(W), ok0))
    return L, ok


def _tri_inv_leaf(L: jnp.ndarray) -> jnp.ndarray:
    """Unrolled inverse of a (..., m, m) lower-triangular block, m <= SUB:
    rows built front-to-back, each a vector op over the row axis."""
    m = L.shape[-1]
    eye = jnp.eye(m, dtype=L.dtype)
    rows = []
    for i in range(m):
        r = eye[i]
        for k in range(i):
            r = r - L[..., i, k][..., None] * rows[k]
        rows.append(r / L[..., i, i][..., None])
    return jnp.stack(rows, axis=-2)


def _tri_inv(L: jnp.ndarray) -> jnp.ndarray:
    """inv(L) for lower-triangular (..., m, m), m a multiple of SUB.
    Static recursion: inv([[A,0],[C,B]]) = [[Ai,0],[-Bi C Ai, Bi]] — the
    off-diagonal blocks are GEMMs, leaves unrolled."""
    m = L.shape[-1]
    if m <= SUB:
        return _tri_inv_leaf(L)
    h = SUB * max(1, (m // 2) // SUB)
    Ai = _tri_inv(L[..., :h, :h])
    Bi = _tri_inv(L[..., h:, h:])
    Ci = -jnp.matmul(jnp.matmul(Bi, L[..., h:, :h], precision=_HI),
                     Ai, precision=_HI)
    top = jnp.concatenate(
        [Ai, jnp.zeros(Ai.shape[:-2] + (h, m - h), L.dtype)], axis=-1)
    bot = jnp.concatenate([Ci, Bi], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def large_cholesky(A: jnp.ndarray, panel: int = PANEL):
    """Cholesky of (..., n, n) SPD with n static and large (>256 is where
    this beats both lax.linalg and blockchol). Returns (L, ok), the
    blockchol/smallchol contract. n is padded to a multiple of SUB with an
    identity diagonal extension (exact).

    The outer panel loop is a static Python loop, so the trailing
    submatrix SHRINKS each iteration instead of being updated in place:
    an in-place `.at[rest, rest].add` form would re-write the full (n, n)
    W and L every panel; here each panel touches only the remaining
    (n-j0)^2 block and the factor columns are assembled once at the end.
    Each diagonal block is factored by the fori_loop sub-panel form and
    inverted by the recursive triangular inverse.
    """
    n = A.shape[-1]
    W, npad = _pad_to_block(A, n, SUB)
    batch = W.shape[:-2]
    ok = None
    cols = []
    for j0 in range(0, npad, panel):
        pw = min(panel, npad - j0)
        Lkk, okk = _chol_fori(W[..., :pw, :pw])
        ok = okk if ok is None else ok & okk
        parts = [jnp.zeros(batch + (j0, pw), A.dtype), Lkk] if j0 \
            else [Lkk]
        if j0 + pw < npad:
            Tinv = _tri_inv(Lkk)
            P = jnp.matmul(W[..., pw:, :pw],
                           jnp.swapaxes(Tinv, -1, -2), precision=_HI)
            W = W[..., pw:, pw:] - jnp.matmul(
                P, jnp.swapaxes(P, -1, -2), precision=_HI)
            parts.append(P)
        cols.append(jnp.concatenate(parts, axis=-2)
                    if len(parts) > 1 else parts[0])
    L = jnp.concatenate(cols, axis=-1) if len(cols) > 1 else cols[0]
    return L[..., :n, :n], ok
