"""Blocked Cholesky for mid-size static N — the batched 17..256 regime.

XLA's lax.linalg.cholesky lowering is tuned for LARGE single factorizations;
for a BATCH of mid-size SPD systems (the multi-camera-calibration regime,
Nstate 64-128, thousands of instances) it was measured slow on the
accelerator this library was first built for; on the GPU it lowers to
cuSOLVER and the comparison is not measured yet (ROADMAP A5). The unrolled smallchol flat-DAG approach
(ops/smallchol.py) can't stretch there either: unrolling n=128 emits ~350k
scalar slots.

This module composes the two regimes: a right-looking BLOCKED factorization
with static 16-wide panels — unrolled 16x16 diagonal Cholesky and unrolled
16-column triangular solves (flat elementwise DAGs, batch-friendly), with
the O(n^3) panel/trailing updates done as batched matmuls. Everything is a static
Python loop over n/16 stages, so the whole factorization stays one fusable
jit region with no data-dependent control flow (SURVEY.md section 7 design
stance).

The reference's analog is LAPACK dpotrf's blocked right-looking algorithm
(reference dogleg.c:778-804 calls dpotrf_/dpptrf_); this is that algorithm
re-shaped for batched matmuls and trace-time unrolling.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from libdogleg_tpu.ops import smallchol

BLOCK = 16
# Above this, XLA's blocked lax.linalg lowering wins (single large
# factorizations; the batch dimension is no longer the interesting axis).
BLOCKED_N_MAX = 256

_HI = jax.lax.Precision.HIGHEST


def _pad_to_block(A: jnp.ndarray, n: int, b: int):
    """Pad (..., n, n) SPD to the next multiple of b with an identity
    diagonal block: [[A, 0], [0, I]] factors as [[L, 0], [0, I]]."""
    npad = (-n) % b
    if npad == 0:
        return A, n
    eye = jnp.eye(npad, dtype=A.dtype)
    pad_shape = A.shape[:-2]
    top = jnp.concatenate(
        [A, jnp.zeros(pad_shape + (n, npad), A.dtype)], axis=-1)
    bot = jnp.concatenate(
        [jnp.zeros(pad_shape + (npad, n), A.dtype),
         jnp.broadcast_to(eye, pad_shape + (npad, npad))], axis=-1)
    return jnp.concatenate([top, bot], axis=-2), n + npad


def _trsm_right_lt(P: jnp.ndarray, Lkk: jnp.ndarray) -> jnp.ndarray:
    """Solve X @ Lkk^T = P for X, Lkk (..., b, b) lower-triangular, P
    (..., r, b). Unrolled over the b columns (b static, small)."""
    b = Lkk.shape[-1]
    inv_d = [1.0 / Lkk[..., j, j] for j in range(b)]
    X = [None] * b
    for j in range(b):
        s = P[..., :, j]
        for m in range(j):
            # note: Lkk[..., j, m] then [..., None] — fusing the newaxis
            # into the integer indexing lowers as a >2-D gather
            s = s - X[m] * Lkk[..., j, m][..., None]
        X[j] = s * inv_d[j][..., None]
    return jnp.stack(X, axis=-1)


def blocked_cholesky(A: jnp.ndarray, block: int = BLOCK):
    """Cholesky of a (..., n, n) SPD matrix, n static (padded internally to
    a multiple of `block`). Returns (L, ok) with L lower-triangular and ok
    the all-pivots-positive flag, same contract as smallchol.small_cholesky
    (the in-jit dpotrf info / CHOLMOD minor signal, reference
    dogleg.c:667,806)."""
    n = A.shape[-1]
    b = block
    if n <= b:
        return smallchol.small_cholesky(A)
    W, npad = _pad_to_block(A, n, b)
    nb = npad // b
    L = jnp.zeros_like(W)
    ok = None
    for k in range(nb):
        kk = slice(k * b, (k + 1) * b)
        rest = slice((k + 1) * b, npad)
        Lkk, okk = smallchol.small_cholesky(W[..., kk, kk])
        ok = okk if ok is None else ok & okk
        L = L.at[..., kk, kk].set(Lkk)
        if k < nb - 1:
            Pl = _trsm_right_lt(W[..., rest, kk], Lkk)
            L = L.at[..., rest, kk].set(Pl)
            # trailing Schur update as a matmul; HIGHEST precision keeps the
            # f32 factor at lax.linalg accuracy (bf16 multiplies would not)
            W = W.at[..., rest, rest].add(
                -jnp.matmul(Pl, jnp.swapaxes(Pl, -1, -2), precision=_HI))
    return L[..., :n, :n], ok


def _fwd_block(Lkk, s):
    """Unrolled forward substitution: y with Lkk y = s, (..., b)."""
    b = Lkk.shape[-1]
    y = [None] * b
    for i in range(b):
        t = s[..., i]
        for m in range(i):
            t = t - Lkk[..., i, m] * y[m]
        y[i] = t / Lkk[..., i, i]
    return jnp.stack(y, axis=-1)


def _bwd_block(Lkk, s):
    """Unrolled backward substitution: z with Lkk^T z = s, (..., b)."""
    b = Lkk.shape[-1]
    z = [None] * b
    for i in reversed(range(b)):
        t = s[..., i]
        for m in range(i + 1, b):
            t = t - Lkk[..., m, i] * z[m]
        z[i] = t / Lkk[..., i, i]
    return jnp.stack(z, axis=-1)


def blocked_cho_solve(L: jnp.ndarray, rhs: jnp.ndarray,
                      block: int = BLOCK) -> jnp.ndarray:
    """Solve (L L^T) z = rhs for one (..., n) right-hand side given the
    blocked factor L from blocked_cholesky. Static block recursion: batched
    matvec panels + unrolled 16-substitutions (the dpptrs_/cholmod_solve
    step, reference dogleg.c:853-897, in the batch-friendly shape)."""
    n = L.shape[-1]
    b = block
    if n <= b:
        return smallchol.small_cho_solve(L, rhs)
    npad = ((-n) % b)
    if npad:
        L, _ = _pad_to_block(L, n, b)  # identity diagonal extension
        rhs = jnp.concatenate(
            [rhs, jnp.zeros(rhs.shape[:-1] + (npad,), rhs.dtype)], axis=-1)
    nfull = n + npad
    nb = nfull // b
    # forward: L y = rhs
    y = []
    for k in range(nb):
        kk = slice(k * b, (k + 1) * b)
        s = rhs[..., kk]
        for j in range(k):
            s = s - jnp.einsum('...ij,...j->...i', L[..., kk, j*b:(j+1)*b],
                               y[j], precision=_HI)
        y.append(_fwd_block(L[..., kk, kk], s))
    # backward: L^T z = y
    z = [None] * nb
    for k in reversed(range(nb)):
        kk = slice(k * b, (k + 1) * b)
        s = y[k]
        for j in range(k + 1, nb):
            s = s - jnp.einsum('...ji,...j->...i', L[..., j*b:(j+1)*b, kk],
                               z[j], precision=_HI)
        z[k] = _bwd_block(L[..., kk, kk], s)
    out = jnp.concatenate(z, axis=-1)
    return out[..., :n]
