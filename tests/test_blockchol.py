"""Blocked-panel Cholesky (ops/blockchol.py) and its Newton strategy.

Correctness is asserted in f64 against numpy on non-multiple-of-16 sizes
(padding path) and batches; the end-to-end check requires the
BlockedDenseNewtonSolver trajectory to agree with the default
DenseNewtonSolver (same math, different factorization algorithm). Shapes
are kept small: the unrolled flat-DAG compile cost grows with Nstate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libdogleg_tpu.ops.blockchol import blocked_cho_solve, blocked_cholesky


@pytest.mark.parametrize("n,batch", [(20, ()), (33, (5,))])
def test_blocked_cholesky_matches_numpy(n, batch):
    rng = np.random.default_rng(0)
    A = rng.normal(size=batch + (n, n))
    S = np.einsum('...ij,...kj->...ik', A, A) + n * np.eye(n)
    L, ok = jax.jit(blocked_cholesky)(jnp.asarray(S))
    assert bool(jnp.all(ok))
    np.testing.assert_allclose(np.asarray(L), np.linalg.cholesky(S),
                               rtol=1e-10, atol=1e-10)
    b = rng.normal(size=batch + (n,))
    z = jax.jit(blocked_cho_solve)(L, jnp.asarray(b))
    zref = np.linalg.solve(S, b[..., None])[..., 0]
    np.testing.assert_allclose(np.asarray(z), zref, rtol=1e-9, atol=1e-9)


def test_blocked_cholesky_flags_singular():
    S = jnp.asarray(np.diag(np.r_[np.ones(10), 0.0, np.ones(9)]))
    _, ok = jax.jit(blocked_cholesky)(S)
    assert not bool(jnp.all(ok))


def test_blocked_newton_solver_matches_dense():
    """Same trajectory as the default DenseNewtonSolver on a mid-size dense
    problem (f64: the factorizations agree to rounding, so every
    accept/reject decision and the converged state must match)."""
    from libdogleg_tpu import DenseProblem, DoglegParameters, optimize
    from libdogleg_tpu.ops.newton import (BlockedDenseNewtonSolver,
                                          DenseNewtonSolver)

    rng = np.random.default_rng(3)
    nstate, nmeas = 20, 80
    A = jnp.asarray(rng.normal(size=(nmeas, nstate)))
    B = jnp.asarray(rng.normal(size=(nstate, nstate)) * 0.5)
    C = jnp.asarray(rng.normal(size=(nmeas, nstate)) * 0.3)
    p_true = rng.normal(size=nstate)
    d = jnp.asarray(np.asarray(A) @ np.tanh(np.asarray(B) @ p_true)
                    + np.asarray(C) @ p_true + rng.normal(size=nmeas) * 0.05)
    p0 = jnp.asarray(rng.normal(size=nstate))

    def f(p):
        t = jnp.tanh(B @ p)
        return A @ t + C @ p - d, A @ (((1.0 - t * t)[:, None]) * B) + C

    prob = DenseProblem(f=f)
    prm = DoglegParameters()
    r_blk = jax.jit(lambda q: optimize(
        prob, q, prm, newton_solver=BlockedDenseNewtonSolver()))(p0)
    r_ref = jax.jit(lambda q: optimize(
        prob, q, prm, newton_solver=DenseNewtonSolver()))(p0)
    assert int(r_blk.step_count) == int(r_ref.step_count)
    assert int(r_blk.n_attempts) == int(r_ref.n_attempts)
    np.testing.assert_allclose(np.asarray(r_blk.p), np.asarray(r_ref.p),
                               rtol=1e-9, atol=1e-9)


def test_auto_newton_selection():
    """batched_optimize auto-selects the blocked strategy exactly for dense
    square JtJ with 17 <= Nstate <= AUTO_BLOCKED_MAX_N AND a real batch
    (>= AUTO_BLOCKED_MIN_BATCH): small batches must not pay blockchol's
    long unrolled compile, larger Nstate stays explicit opt-in."""
    from libdogleg_tpu.ops import dense as dops
    from libdogleg_tpu.ops.newton import BlockedDenseNewtonSolver
    from libdogleg_tpu.parallel.batched import (AUTO_BLOCKED_MIN_BATCH,
                                                _auto_newton)
    from libdogleg_tpu.solver import Products

    def make_products(nmeas, nstate):
        def products(p, data):
            J = data
            x = J @ p
            return Products(norm2_x=dops.norm2(x), Jt_x=dops.jt_dot(J, x),
                            JtJ=dops.build_jtj(J))
        return products

    big = AUTO_BLOCKED_MIN_BATCH
    for nstate, expect in [(8, False), (16, False), (17, True), (64, True),
                           (128, True), (129, False), (256, False)]:
        data = jnp.zeros((big, nstate, nstate))
        p0s = jnp.zeros((big, nstate))
        ns = _auto_newton(make_products(nstate, nstate), p0s, data)
        assert isinstance(ns, BlockedDenseNewtonSolver) == expect, nstate

    # below the batch gate: never auto-selected, regardless of Nstate
    data = jnp.zeros((big - 1, 64, 64))
    p0s = jnp.zeros((big - 1, 64))
    assert _auto_newton(make_products(64, 64), p0s, data) is None


def test_blocked_cholesky_batched_f32():
    """A float32 batch at a width that is one block: the factor agrees
    with numpy's float64 factor to float32 accuracy."""
    rng = np.random.default_rng(5)
    B, n = 8, 32
    A = rng.normal(size=(B, n, n))
    S = jnp.asarray((np.einsum('bij,bkj->bik', A, A)
                     + n * np.eye(n)).astype(np.float32))
    L, ok = blocked_cholesky(S)
    assert bool(jnp.all(ok))
    Lref = np.linalg.cholesky(np.asarray(S, np.float64))
    np.testing.assert_allclose(np.asarray(L, np.float64), Lref,
                               rtol=2e-4, atol=2e-4)
