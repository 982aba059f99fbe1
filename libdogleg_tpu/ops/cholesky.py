"""JtJ factorization with permanent escalating-lambda singularity handling.

The reference factors JtJ with CHOLMOD (sparse, reference dogleg.c:649-677) or
LAPACK dpptrf/dpotrf (dense, dogleg.c:699-816). On a singular JtJ it adds
lambda*I to the diagonal, starting at 1e-10 and multiplying by 10 per repeated
failure; lambda is *permanent* for the remainder of the solve (reference
dogleg.c:137-138, dogleg.h:197-201).

Inside jit a Cholesky cannot "fail" with an error code, so failure is detected
numerically: jnp.linalg.cholesky of a non-SPD matrix yields NaNs (and a
singular-but-factorizable matrix yields a non-positive diagonal). The
escalation runs as a bounded lax.while_loop, preserving the reference's
semantics: same initial lambda, same x10 schedule, same permanence.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from libdogleg_tpu.ops import smallchol


class Factorization(NamedTuple):
    L: jnp.ndarray        # (Nstate, Nstate) lower-triangular Cholesky factor
    lam: jnp.ndarray      # scalar: the (possibly escalated) permanent lambda
    ok: jnp.ndarray       # scalar bool: factorization succeeded


def _try_factor(JtJ: jnp.ndarray, lam: jnp.ndarray):
    n = JtJ.shape[-1]
    damped = JtJ + lam * jnp.eye(n, dtype=JtJ.dtype)
    if n <= smallchol.SMALL_N_MAX:
        # Unrolled flat-DAG factorization: ~3x faster than the blocked
        # lax.linalg lowering for tiny systems inside the solver loop.
        L, ok = smallchol.small_cholesky(damped)
        return L, jnp.all(ok)
    L = jnp.linalg.cholesky(damped)
    diag = jnp.diagonal(L, axis1=-2, axis2=-1)
    ok = jnp.all(jnp.isfinite(L)) & jnp.all(diag > 0)
    return L, ok


def escalating_lambda(try_factor, lam, dtype, *,
                      lambda_initial: float = 1e-10,
                      lambda_max_tries: int = 60,
                      trace_once: bool = False):
    """The reference's permanent escalating-lambda loop, shared by every
    factorization backend (dense, block-sparse, supernodal, Schur): try the
    current lambda; while singular, lambda <- lambda_initial if zero else
    lambda*10, and retry (reference dogleg.c:670-676, 811-815). Bounded at
    lambda_max_tries escalations; ok=False if still singular (the reference
    ASSERT-exits on non-finite lambda, dogleg.c:673 — a batched device solve
    flags the element as failed instead).

    try_factor(lam) -> (state_pytree, ok). Returns (state, lam, ok).

    trace_once moves the first (usually only) factorization INSIDE the
    while_loop body so it is traced once instead of twice. That halves
    compile time — minutes for large supernodal factorizations — but costs
    runtime on tiny dense factors: the while_loop boundary blocks XLA from
    fusing the factorization into the surrounding solver iteration
    (measured +60% on the batched small-N hot path). Large/sparse backends
    pass True; the dense path keeps False.
    """
    lam = jnp.asarray(lam, dtype)

    def escalate(lam):
        return jnp.where(lam == 0.0, jnp.asarray(lambda_initial, dtype),
                         lam * 10.0)

    if trace_once:
        state_shape = jax.eval_shape(try_factor, lam)[0]
        state0 = jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), state_shape)

        def body(carry):
            lam, _, _, tries = carry
            # tries == -1 marks the first pass: lam as given, unescalated
            lam = jnp.where(tries < 0, lam, escalate(lam))
            state, ok = try_factor(lam)
            return (lam, state, ok, tries + 1)

        lam, state, ok, _ = jax.lax.while_loop(
            lambda c: (c[3] < 0) | ((~c[2]) & (c[3] < lambda_max_tries)),
            body,
            (lam, state0, jnp.asarray(False), jnp.asarray(-1, jnp.int32)),
        )
        return state, lam, ok

    state0, ok0 = try_factor(lam)

    def body(carry):
        lam, _, _, tries = carry
        lam = escalate(lam)
        state, ok = try_factor(lam)
        return (lam, state, ok, tries + 1)

    lam, state, ok, _ = jax.lax.while_loop(
        lambda c: (~c[2]) & (c[3] < lambda_max_tries),
        body,
        (lam, state0, ok0, jnp.asarray(0, jnp.int32)),
    )
    return state, lam, ok


def factorize_jtj(JtJ: jnp.ndarray,
                  lam: jnp.ndarray,
                  *,
                  lambda_initial: float = 1e-10,
                  lambda_max_tries: int = 60) -> Factorization:
    """Cholesky-factorize JtJ + lam*I, escalating lam on singularity
    (mirrors reference dogleg_computeJtJfactorization, dogleg.c:634-820)."""
    L, lam, ok = escalating_lambda(
        lambda lm: _try_factor(JtJ, lm), lam, JtJ.dtype,
        lambda_initial=lambda_initial, lambda_max_tries=lambda_max_tries)
    return Factorization(L=L, lam=lam, ok=ok)


def cholesky_solve(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve (L L^T) z = b given the lower Cholesky factor L.

    The reference's cholmod_solve(CHOLMOD_A, ...) / dpptrs_ step (reference
    dogleg.c:853-897). b may be (Nstate,) or (Nstate, k).
    """
    if b.ndim == 1 and L.shape[-1] <= smallchol.SMALL_N_MAX:
        return smallchol.small_cho_solve(L, b)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    y = jax.lax.linalg.triangular_solve(L, b, left_side=True, lower=True,
                                        transpose_a=False)
    z = jax.lax.linalg.triangular_solve(L, y, left_side=True, lower=True,
                                        transpose_a=True)
    return z[:, 0] if squeeze else z


def gauss_newton_step(L: jnp.ndarray, Jt_x: jnp.ndarray):
    """Solve JtJ * u = Jt_x and negate: the Gauss-Newton update (reference
    compute_updateGN, dogleg.c:822-908). Returns (step, norm2_step)."""
    step = -cholesky_solve(L, Jt_x)
    return step, jnp.dot(step, step)
