"""Large-N dense Cholesky (ops/largechol): the GEMM-dominant blocked
factorization used in place of XLA's lax.linalg lowering for
single/small-batch large matrices (reference
dogleg.c:778-804's dpotrf path at the sizes where its blocked algorithm
matters)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libdogleg_tpu.ops.largechol import _tri_inv, large_cholesky


def _spd(n, rng, batch=()):
    A = rng.normal(size=batch + (n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


@pytest.mark.parametrize("n", [192, 320, 528])
def test_large_cholesky_matches_lax(n):
    """Parity with lax.linalg.cholesky in f64, incl. non-multiples of the
    256 panel (320 = 256+64, 528 = 2x256+16). Sizes kept moderate: each
    instance is a fresh large unrolled-outer-loop program, and the CPU
    test process compiles ~200 programs across the suite — n=1040 here
    pushed the in-process XLA CPU compiler into a flaky segfault on full
    suite runs (crashes in backend_compile_and_load only when the whole
    suite's programs precede it; either half of the suite alone is
    fine)."""
    rng = np.random.default_rng(0)
    A = jnp.asarray(_spd(n, rng))
    L, ok = jax.jit(large_cholesky)(A)
    assert bool(ok)
    L_ref = np.linalg.cholesky(np.asarray(A))
    np.testing.assert_allclose(np.asarray(L), L_ref, rtol=1e-10,
                               atol=1e-10 * n)
    # strictly lower: no garbage above the diagonal
    assert np.allclose(np.triu(np.asarray(L), 1), 0.0)


def test_large_cholesky_batched():
    rng = np.random.default_rng(1)
    A = jnp.asarray(_spd(384, rng, batch=(3,)))
    L, ok = jax.jit(large_cholesky)(A)
    assert ok.shape == (3,) and bool(np.all(np.asarray(ok)))
    np.testing.assert_allclose(np.asarray(L),
                               np.linalg.cholesky(np.asarray(A)),
                               rtol=1e-10, atol=1e-7)


def test_large_cholesky_failure_flag():
    """Indefinite input -> ok=False (the dpotrf info signal the
    lambda-escalation loop keys on, reference dogleg.c:667,806)."""
    rng = np.random.default_rng(2)
    A = np.asarray(_spd(320, rng))
    A[300, 300] = -5.0 * A[300, 300]
    _, ok = jax.jit(large_cholesky)(jnp.asarray(A))
    assert not bool(ok)


def test_tri_inv():
    rng = np.random.default_rng(3)
    L = np.linalg.cholesky(_spd(320, rng))
    X = _tri_inv(jnp.asarray(L))
    np.testing.assert_allclose(np.asarray(X) @ L, np.eye(320),
                               atol=1e-9)


def test_newton_solver_dispatches_large():
    """BlockedDenseNewtonSolver above BLOCKED_N_MAX rides large_cholesky
    (no trace-time unrolling explosion) and still produces the correct GN
    step + refinement."""
    from libdogleg_tpu.ops.newton import (BlockedDenseNewtonSolver,
                                          DenseNewtonSolver)
    rng = np.random.default_rng(4)
    n = 320
    JtJ = jnp.asarray(_spd(n, rng))
    b = jnp.asarray(rng.normal(size=n))
    lam = jnp.asarray(0.0, JtJ.dtype)
    r = BlockedDenseNewtonSolver().gauss_newton(
        JtJ, b, lam, lambda_initial=1e-10, lambda_max_tries=10)
    r_ref = DenseNewtonSolver().gauss_newton(
        JtJ, b, lam, lambda_initial=1e-10, lambda_max_tries=10)
    assert bool(r.ok)
    np.testing.assert_allclose(np.asarray(r.step), np.asarray(r_ref.step),
                               rtol=1e-8, atol=1e-10)
    r2 = BlockedDenseNewtonSolver(refine_iters=1).gauss_newton(
        JtJ, b, lam, lambda_initial=1e-10, lambda_max_tries=10)
    np.testing.assert_allclose(np.asarray(r2.step),
                               np.asarray(r_ref.step), rtol=1e-8,
                               atol=1e-10)
