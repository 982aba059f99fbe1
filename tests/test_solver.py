"""End-to-end solver tests: the reference's integration-test problem in all
solve modes (reference sample.c + check.sh), with its exact pass criteria —
convergence within 8 accepted steps and per-parameter recovery within 5e-2
(sample.c:365, 443-457) — plus solver-behavior tests the reference lacks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import libdogleg_tpu.sample_problem as sp
from libdogleg_tpu import (DoglegParameters, StopReason, optimize,
                           solve_products)
from libdogleg_tpu.solver import Products


@pytest.fixture(scope="module")
def measurements():
    return sp.simulate(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def p0():
    return sp.initial_state(jax.random.PRNGKey(1))


# The four reference test-mode configurations (check.sh:11-15): sparse,
# dense, dense-products x {packed-upper, unpacked} — packed collapses to one
# products mode here (packed storage is converted at the API edge) — plus the
# autodiff mode the reference can't do.
MODES = {
    "sparse": sp.make_sparse_problem,
    "dense": sp.make_dense_problem,
    "products": sp.make_products_problem,
    "residual_autodiff": sp.make_residual_problem,
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sample_problem_converges_all_modes(measurements, p0, mode):
    problem = MODES[mode](measurements)
    prm = DoglegParameters(max_iterations=8)  # sample.c:365
    result = jax.jit(
        lambda q: optimize(problem, q, prm))(p0)

    assert int(result.reason) in (int(StopReason.GRADIENT_CONVERGED),
                                  int(StopReason.SMALL_STEP))
    assert int(result.step_count) <= 8
    err = np.abs(np.asarray(result.p) - sp.P_TRUE)
    assert np.all(err < 5e-2), f"parameter errors {err}"  # sample.c:446
    assert float(result.norm2_x) >= 0.0


def test_modes_agree_on_solution(measurements, p0):
    sols = {}
    for mode, make in MODES.items():
        r = optimize(make(measurements), p0, DoglegParameters())
        sols[mode] = np.asarray(r.p)
    base = sols["dense"]
    for mode, p in sols.items():
        np.testing.assert_allclose(p, base, rtol=1e-6, atol=1e-8,
                                   err_msg=f"mode {mode} diverges from dense")


def test_already_converged_initial_point(measurements):
    """If the initial gradient already meets the threshold, return
    immediately with 0 steps (reference dogleg.c:1364-1371)."""
    problem = sp.make_dense_problem(measurements)
    r_full = optimize(problem, sp.initial_state(jax.random.PRNGKey(1)))
    # Solve to optimum, then restart at it: gradient is below threshold.
    prm = DoglegParameters(Jt_x_threshold=1e-4)
    r2 = optimize(problem, r_full.p, prm)
    assert int(r2.step_count) == 0
    assert int(r2.reason) == int(StopReason.GRADIENT_CONVERGED)


def test_max_iterations_counts_accepted_steps_only(measurements, p0):
    problem = sp.make_dense_problem(measurements)
    prm = DoglegParameters(max_iterations=2)
    r = optimize(problem, p0, prm)
    assert int(r.step_count) <= 2
    if int(r.reason) == int(StopReason.MAX_ITERATIONS):
        assert int(r.step_count) == 2


def test_linear_problem_converges_in_one_gn_step():
    """A linear least-squares problem must be solved by a single full
    Gauss-Newton step (the local model is exact, rho == 1)."""
    rng = np.random.default_rng(11)
    A = jnp.asarray(rng.normal(size=(20, 4)))
    b = jnp.asarray(rng.normal(size=(20,)))

    def products(p):
        x = A @ p - b
        return Products(norm2_x=x @ x, Jt_x=A.T @ x, JtJ=A.T @ A)

    # trustregion0 default (1e3) comfortably contains the GN step
    r = solve_products(products, jnp.zeros(4, jnp.float64))
    expect = np.linalg.lstsq(np.asarray(A), np.asarray(b), rcond=None)[0]
    np.testing.assert_allclose(np.asarray(r.p), expect, rtol=1e-8)
    assert int(r.step_count) <= 2  # one GN step (+1 if a tiny cleanup step)


def test_rank_deficient_problem_engages_lambda():
    """A rank-deficient Jacobian must trigger the permanent escalating-lambda
    path (reference dogleg.c:137-138, 670-676) and still make progress."""
    rng = np.random.default_rng(12)
    A = jnp.asarray(rng.normal(size=(30, 3)))
    # 4th column exactly zero: JtJ has an exactly-zero pivot, so the
    # factorization must fail and engage lambda (a duplicated column would
    # leave the failure to rounding luck, as it does for LAPACK dpptrf).
    A = jnp.concatenate([A, jnp.zeros((30, 1))], axis=1)
    b = jnp.asarray(rng.normal(size=(30,)))

    def products(p):
        x = A @ p - b
        return Products(norm2_x=x @ x, Jt_x=A.T @ x, JtJ=A.T @ A)

    r = solve_products(products, jnp.zeros(4, jnp.float64))
    assert float(r.lam) > 0.0
    # Residual should reach the lstsq optimum even though p is non-unique.
    expect = np.linalg.lstsq(np.asarray(A), np.asarray(b), rcond=None)[0]
    res_opt = np.linalg.norm(np.asarray(A) @ expect - np.asarray(b)) ** 2
    assert float(r.norm2_x) <= res_opt * (1 + 1e-6) + 1e-9


def test_all_rejects_terminates_small_trustregion():
    """If every step is rejected, the region shrinks geometrically until it
    crosses trustregion_threshold and the solver gives up — checked only on
    the reject path (reference dogleg.c:1460-1466). Adversarial products
    function: the claimed gradient points uphill (the solver must trust the
    user's Jacobian, exactly as the reference does), so every trial point
    increases the cost and rho < 0."""
    def products(p):
        norm2_x = p[0] * p[0] + 1.0
        return Products(norm2_x=norm2_x,
                        Jt_x=jnp.stack([-p[0]]),     # wrong sign: uphill
                        JtJ=jnp.ones((1, 1), p.dtype))

    prm = DoglegParameters(update_threshold=1e-12)
    r = solve_products(products, jnp.asarray([1.0], jnp.float64), prm)
    assert int(r.reason) == int(StopReason.SMALL_TRUSTREGION)
    assert int(r.step_count) == 0
    np.testing.assert_allclose(np.asarray(r.p), [1.0])  # never moved
    assert float(r.trustregion) < prm.trustregion_threshold


def test_nan_residuals_hit_attempt_cap_not_hang():
    """NaN trial costs would hang the reference's retry loop (NaN rho fails
    every comparison at dogleg.c:1324-1354); the solver must terminate
    via the attempt cap."""
    def products(p):
        # Clean inside |p0 - 1| <= 0.5, NaN outside; the (deliberately
        # misleading) products send every trial point into the NaN zone.
        bad = jnp.where(jnp.abs(p[0] - 1.0) > 0.5, jnp.nan, 0.0)
        norm2_x = (p[0] - 1.0) ** 2 + bad
        return Products(norm2_x=norm2_x,
                        Jt_x=jnp.stack([0.01 * (p[0] - 1.0)]),
                        JtJ=jnp.full((1, 1), 1e-4, p.dtype))

    prm = DoglegParameters(max_iterations=5, max_attempts=20)
    r = solve_products(products, jnp.asarray([1.3], jnp.float64), prm)
    assert int(r.reason) == int(StopReason.STALLED)
    assert int(r.n_attempts) == 20


def test_vmapped_batch_of_solves(measurements):
    """Batched independent solves: each element terminates at its own
    stopping point (SURVEY.md section 2.2, DP row)."""
    problem = sp.make_dense_problem(measurements)
    keys = jax.random.split(jax.random.PRNGKey(7), 16)
    p0s = jax.vmap(sp.initial_state)(keys)

    batched = jax.jit(jax.vmap(lambda q: optimize(problem, q)))
    r = batched(p0s)
    assert r.p.shape == (16, sp.NSTATE)
    errs = np.abs(np.asarray(r.p) - sp.P_TRUE[None, :])
    assert np.all(errs < 5e-2)
    reasons = np.asarray(r.reason)
    assert np.all((reasons == int(StopReason.GRADIENT_CONVERGED))
                  | (reasons == int(StopReason.SMALL_STEP)))


def test_result_gradient_is_small_at_solution(measurements, p0):
    problem = sp.make_dense_problem(measurements)
    r = optimize(problem, p0)
    # At the optimum of this well-conditioned problem the gradient's inf-norm
    # should be at/below threshold scale.
    assert float(jnp.max(jnp.abs(r.Jt_x))) < 1e-6


def test_factorization_failure_is_terminal():
    """A JtJ that can never factor (NaN) exhausts the lambda escalation and
    surfaces as FACTORIZATION_FAILED instead of hanging (the reference
    ASSERT-exits the process at dogleg.c:673)."""
    def products(p):
        return Products(norm2_x=jnp.dot(p, p) + 1.0,
                        Jt_x=p + 1.0,
                        JtJ=jnp.full((2, 2), jnp.nan))

    r = solve_products(products, jnp.zeros(2),
                       DoglegParameters(lambda_max_tries=5))
    assert int(r.reason) == int(StopReason.FACTORIZATION_FAILED)
