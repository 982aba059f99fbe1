"""Mixed-precision iterative refinement of the GN solve (ops/newton._refine).

The reference's numeric contract is C doubles end-to-end with 1e-8
termination thresholds (reference dogleg.c:125-127); device runs are
f32, and on a GPU an f32 matmul at default precision runs in TF32.
refine_iters is the route back: each pass
solves a DOUBLE-f32 COMPENSATED residual (ops/compensated.py — a plain
working-precision residual cannot see the error it is correcting) against
the already-computed f32 factor. These tests quantify that it works —
refined f32 solves land orders of magnitude closer to the f64 solution of
the stored system — and that it composes with every strategy and the full
driver.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libdogleg_tpu import DoglegParameters
from libdogleg_tpu.ops.newton import (DenseNewtonSolver, SchurJtJ,
                                      SchurNewtonSolver,
                                      SparseNewtonSolver, schur_to_dense)


def _ill_conditioned(n, cond, rng):
    """SPD matrix with the given condition number (log-spaced spectrum)."""
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    d = np.logspace(0, np.log10(cond), n)
    return (Q * d) @ Q.T


def _err(u, u64):
    return float(np.linalg.norm(np.asarray(u, np.float64) - u64)
                 / np.linalg.norm(u64))


def test_dense_refinement_tightens_f32_solve():
    rng = np.random.default_rng(0)
    n, cond = 64, 1e5
    JtJ = jnp.asarray(_ill_conditioned(n, cond, rng), jnp.float32)
    b = jnp.asarray(rng.normal(size=n), jnp.float32)
    lam = jnp.asarray(0.0, jnp.float32)
    # the oracle is the exact solution OF THE STORED f32 SYSTEM (cast up
    # to f64): rounding A itself costs ~cond*eps32 relative error that no
    # solver can recover — refinement's claim is reaching the exact
    # solution of the system it was handed
    u64 = np.linalg.solve(np.asarray(JtJ, np.float64),
                          np.asarray(b, np.float64))

    def solve(iters):
        r = DenseNewtonSolver(refine_iters=iters).gauss_newton(
            JtJ, b, lam, lambda_initial=1e-10, lambda_max_tries=10)
        assert bool(r.ok)
        return -np.asarray(r.step, np.float64)

    e0, e2 = _err(solve(0), u64), _err(solve(2), u64)
    # f32 factor on cond=1e5 loses ~5 digits; two refinement passes with
    # the compensated residual must recover to near the f32
    # representation floor (orders of magnitude, not a constant factor)
    assert e2 < e0 * 1e-2, (e0, e2)
    assert e2 < 1e-6, e2


def test_schur_refinement_tightens_f32_solve():
    # a genuinely PD, genuinely ill-conditioned arrow system: JtJ = J^T J
    # for a BA-shaped J (each measurement row touches the camera columns
    # and ONE point's columns), with shuffled logspace column scaling so
    # cond(JtJ) = cond(J)^2 ~ 1e5 through real cross-column mixing
    rng = np.random.default_rng(1)
    nc, npts, bs, mrows = 12, 50, 3, 6
    scale = np.logspace(0, 1.25, nc + npts * bs)
    rng.shuffle(scale)
    Jc = rng.normal(size=(npts, mrows, nc)) * scale[:nc]
    Jp = rng.normal(size=(npts, mrows, bs)) \
        * scale[nc:].reshape(npts, 1, bs)
    JtJ = SchurJtJ(
        U=jnp.asarray(np.einsum('pmc,pmd->cd', Jc, Jc), jnp.float32),
        W=jnp.asarray(np.einsum('pmc,pmb->cpb', Jc, Jp), jnp.float32),
        V=jnp.asarray(np.einsum('pmb,pmk->pbk', Jp, Jp), jnp.float32))
    # oracle: the exact f64 solution of the STORED (f32-rounded) system
    # — see the dense test's note
    b = jnp.asarray(rng.normal(size=nc + npts * bs), jnp.float32)
    Ad = np.asarray(schur_to_dense(JtJ), np.float64)
    u64 = np.linalg.solve(Ad, np.asarray(b, np.float64))
    lam = jnp.asarray(0.0, jnp.float32)

    def solve(iters):
        ns = SchurNewtonSolver(nc=nc, n_points=npts, block_size=bs,
                               refine_iters=iters)
        r = ns.gauss_newton(JtJ, b, lam, lambda_initial=1e-10,
                            lambda_max_tries=10)
        assert bool(r.ok)
        return -np.asarray(r.step, np.float64)

    e0, e2 = _err(solve(0), u64), _err(solve(2), u64)
    assert e2 < e0 * 1e-1 and e2 < 1e-5, (e0, e2)


def test_sparse_refinement_tightens_f32_solve():
    # banded SPD with GENUINE ill-conditioning: the 1-D biharmonic
    # operator K^2 (K = tridiag(-1,2,-1)), scalar bandwidth 2 so it fits
    # the block-bandwidth-2 pattern exactly, cond ~ (n/pi)^4 ~ 5e5 with
    # sine eigenvectors (full mixing — a scaled-diagonal construction
    # would solve to ~eps regardless of cond)
    rng = np.random.default_rng(2)
    nb, b = 10, 4
    n = nb * b
    rows, cols = zip(*[(i, j) for j in range(nb)
                       for i in range(j, min(nb, j + 3))])
    rows, cols = np.asarray(rows), np.asarray(cols)
    K = (np.diag(2.0 * np.ones(n)) + np.diag(-np.ones(n - 1), 1)
         + np.diag(-np.ones(n - 1), -1))
    # round the assembled system to f32 FIRST so the f64 oracle solves
    # the same stored system (see the dense test's note)
    A64 = np.float32(K @ K).astype(np.float64)
    blocks64 = [A64[i*b:(i+1)*b, j*b:(j+1)*b] for i, j in zip(rows, cols)]
    b64 = np.float32(rng.normal(size=n)).astype(np.float64)
    u64 = np.linalg.solve(A64, b64)

    blocks = jnp.asarray(np.stack(blocks64), jnp.float32)
    rhs = jnp.asarray(b64, jnp.float32)
    lam = jnp.asarray(0.0, jnp.float32)

    def solve(iters):
        ns = SparseNewtonSolver.analyze(rows, cols, nb, b)
        ns = SparseNewtonSolver(symbolic=ns.symbolic, refine_iters=iters)
        r = ns.gauss_newton(blocks, rhs, lam, lambda_initial=1e-10,
                            lambda_max_tries=10)
        assert bool(r.ok)
        return -np.asarray(r.step, np.float64)

    e0, e2 = _err(solve(0), u64), _err(solve(2), u64)
    assert e2 < e0 * 1e-1 and e2 < 5e-7, (e0, e2)


@pytest.mark.parametrize("iters", [1, 2])
def test_refined_full_solve_converges_tighter(iters):
    """Per-step accuracy through the trust-region driver, on an
    ill-conditioned f32 linear least-squares. A finding worth recording:
    on a linear problem the driver's OUTER loop is itself iterative
    refinement (each accepted step re-evaluates the residual and
    re-solves), so a multi-iteration run converges to the floor with or
    without refine_iters. The per-step claim is isolated with
    max_iterations=1: unrefined, the single f32 GN step lands
    cond-scaled-eps away from the f64 solution of the STORED normal
    equations; refined, it must land orders of magnitude closer — the
    mixed-precision route toward the reference's all-double contract
    (dogleg.c:125-127)."""
    from libdogleg_tpu import optimize
    from libdogleg_tpu.problems import DenseProblem

    rng = np.random.default_rng(3)
    m, n = 200, 40
    scale = np.logspace(0, 1.5, n)
    rng.shuffle(scale)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    J64 = rng.normal(size=(m, n)) @ (Q * scale) @ Q.T
    J = jnp.asarray(J64, jnp.float32)
    y = jnp.asarray(rng.normal(size=m), jnp.float32)

    prob = DenseProblem(f=lambda p: (J @ p - y, J))
    p0 = jnp.zeros(n, jnp.float32)
    # oracle: the f64 solution of the STORED normal equations — the
    # exact system the step computation was handed (JtJ formation
    # rounding is data-level error, not solve error)
    prods = prob.products(p0)
    p_opt = -np.linalg.solve(np.asarray(prods.JtJ, np.float64),
                             np.asarray(prods.Jt_x, np.float64))

    prm = DoglegParameters(max_iterations=1)
    r_plain = optimize(prob, p0, prm,
                       newton_solver=DenseNewtonSolver())
    r_ref = optimize(prob, p0, prm,
                     newton_solver=DenseNewtonSolver(refine_iters=iters))
    ref_norm = np.linalg.norm(p_opt)
    e_plain = np.linalg.norm(np.asarray(r_plain.p, np.float64)
                             - p_opt) / ref_norm
    e_ref = np.linalg.norm(np.asarray(r_ref.p, np.float64)
                           - p_opt) / ref_norm
    assert e_ref < e_plain * 0.1, (e_plain, e_ref)
    assert e_ref < 1e-5, (e_plain, e_ref)


def test_blocked_refinement_tightens_f32_solve():
    """BlockedDenseNewtonSolver refine path: same claim as the dense
    test, through the 16-panel blocked factorization."""
    from libdogleg_tpu.ops.newton import BlockedDenseNewtonSolver

    rng = np.random.default_rng(4)
    n, cond = 48, 1e5
    JtJ = jnp.asarray(_ill_conditioned(n, cond, rng), jnp.float32)
    b = jnp.asarray(rng.normal(size=n), jnp.float32)
    lam = jnp.asarray(0.0, jnp.float32)
    u64 = np.linalg.solve(np.asarray(JtJ, np.float64),
                          np.asarray(b, np.float64))

    def solve(iters):
        r = BlockedDenseNewtonSolver(refine_iters=iters).gauss_newton(
            JtJ, b, lam, lambda_initial=1e-10, lambda_max_tries=10)
        assert bool(r.ok)
        return -np.asarray(r.step, np.float64)

    e0, e2 = _err(solve(0), u64), _err(solve(2), u64)
    assert e2 < e0 * 1e-2 and e2 < 1e-6, (e0, e2)


@pytest.mark.parametrize("with_gather", [False, True])
def test_sparsew_refinement(with_gather):
    """SparseWSchurNewtonSolver refine path on a real sparse-visibility
    BA system (f32-cast products), against the f64 solution of the
    stored system. With the static cam_gather table the camera rows are
    fully compensated; without it they fall back to the HIGHEST-f32
    residual — both must improve on the unrefined solve, the gathered
    form by more."""
    import dataclasses as dc

    from libdogleg_tpu.models import pinhole_ba
    from libdogleg_tpu.ops.newton import build_cam_gather

    ba = pinhole_ba.make_synthetic_sparse(seed=1, ncam=6, npts=80,
                                          k_obs=3)
    p0 = ba.p0(jax.random.PRNGKey(0), jitter=0.02)
    pr = ba.products(p0)
    JtJ = pr.JtJ._replace(U=pr.JtJ.U.astype(jnp.float32),
                          Wv=pr.JtJ.Wv.astype(jnp.float32),
                          V=pr.JtJ.V.astype(jnp.float32))
    rhs = {"c": pr.Jt_x["c"].astype(jnp.float32),
           "q": pr.Jt_x["q"].astype(jnp.float32)}
    lam = jnp.asarray(0.01, jnp.float32)     # keep the system solvable

    # densify the STORED f32 system in f64 for the oracle
    nc = ba.ncam * 6
    n = nc + ba.npts * 3
    A = np.zeros((n, n))
    A[:nc, :nc] = np.asarray(JtJ.U, np.float64)
    cam_of = np.asarray(JtJ.cam_of)
    Wv = np.asarray(JtJ.Wv, np.float64)
    for p in range(ba.npts):
        for k in range(cam_of.shape[1]):
            c = int(cam_of[p, k])
            A[c*6:(c+1)*6, nc+p*3:nc+(p+1)*3] += Wv[p, k]
    A[nc:, :nc] = A[:nc, nc:].T
    for p in range(ba.npts):
        A[nc+p*3:nc+(p+1)*3, nc+p*3:nc+(p+1)*3] = np.asarray(
            JtJ.V[p], np.float64)
    A += float(lam) * np.eye(n)
    b64 = np.concatenate([np.asarray(rhs["c"], np.float64),
                          np.asarray(rhs["q"], np.float64).reshape(-1)])
    u64 = np.linalg.solve(A, b64)

    ns0 = ba.newton_solver()
    gather = build_cam_gather(cam_of, ba.ncam) if with_gather else None

    def solve(iters):
        ns = dc.replace(ns0, refine_iters=iters, cam_gather=gather)
        r = ns.gauss_newton(JtJ, rhs, lam, lambda_initial=1e-10,
                            lambda_max_tries=10)
        assert bool(r.ok)
        u = np.concatenate([-np.asarray(r.step["c"], np.float64),
                            -np.asarray(r.step["q"],
                                        np.float64).reshape(-1)])
        return u

    e0, e2 = _err(solve(0), u64), _err(solve(2), u64)
    assert e2 < e0, (e0, e2)
    if with_gather:
        assert e2 < max(e0 * 1e-1, 5e-7), (e0, e2)


def test_sparsew_refinement_masked_visibility():
    """cam_gather composed with VARIABLE visibility (obs_mask): masked
    slots carry exactly-zero Wv blocks, so the static gather table built
    over all np*k_obs slots gathers exact zeros and the compensated
    camera residual stays exact — refinement improves as in the
    fully-visible case."""
    import dataclasses as dc

    from libdogleg_tpu.models import pinhole_ba
    from libdogleg_tpu.ops.newton import build_cam_gather

    ba = pinhole_ba.make_synthetic_sparse(seed=2, ncam=6, npts=80,
                                          k_obs=3)
    rng = np.random.default_rng(0)
    mask = (rng.random((ba.npts, ba.k_obs)) > 0.25).astype(np.float64)
    mask[:, 0] = 1.0                       # every point keeps >=1 obs
    ba = ba._replace(obs_mask=jnp.asarray(mask))
    p0 = ba.p0(jax.random.PRNGKey(0), jitter=0.02)
    pr = ba.products(p0)
    JtJ = pr.JtJ._replace(U=pr.JtJ.U.astype(jnp.float32),
                          Wv=pr.JtJ.Wv.astype(jnp.float32),
                          V=pr.JtJ.V.astype(jnp.float32))
    rhs = {"c": pr.Jt_x["c"].astype(jnp.float32),
           "q": pr.Jt_x["q"].astype(jnp.float32)}
    lam = jnp.asarray(0.01, jnp.float32)

    nc = ba.ncam * 6
    n = nc + ba.npts * 3
    A = np.zeros((n, n))
    A[:nc, :nc] = np.asarray(JtJ.U, np.float64)
    cam_of = np.asarray(JtJ.cam_of)
    Wv = np.asarray(JtJ.Wv, np.float64)
    for p in range(ba.npts):
        for k in range(cam_of.shape[1]):
            c = int(cam_of[p, k])
            A[c*6:(c+1)*6, nc+p*3:nc+(p+1)*3] += Wv[p, k]
    A[nc:, :nc] = A[:nc, nc:].T
    for p in range(ba.npts):
        A[nc+p*3:nc+(p+1)*3, nc+p*3:nc+(p+1)*3] = np.asarray(
            JtJ.V[p], np.float64)
    A += float(lam) * np.eye(n)
    b64 = np.concatenate([np.asarray(rhs["c"], np.float64),
                          np.asarray(rhs["q"], np.float64).reshape(-1)])
    u64 = np.linalg.solve(A, b64)

    # masked slots must hold exactly-zero coupling blocks (the gather
    # precondition)
    assert np.all(Wv[mask == 0.0] == 0.0)

    ns0 = ba.newton_solver()
    gather = build_cam_gather(cam_of, ba.ncam)

    def solve(iters):
        ns = dc.replace(ns0, refine_iters=iters, cam_gather=gather)
        r = ns.gauss_newton(JtJ, rhs, lam, lambda_initial=1e-10,
                            lambda_max_tries=10)
        assert bool(r.ok)
        return np.concatenate([-np.asarray(r.step["c"], np.float64),
                               -np.asarray(r.step["q"],
                                           np.float64).reshape(-1)])

    e0, e2 = _err(solve(0), u64), _err(solve(2), u64)
    assert e2 < e0, (e0, e2)
    assert e2 < max(e0 * 1e-1, 5e-7), (e0, e2)
