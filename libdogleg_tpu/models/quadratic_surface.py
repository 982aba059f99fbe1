"""The reference's demo/integration-test problem, re-specified in JAX.

Spec (not code) from reference sample.c: fit the 6-parameter model

    m(x, y; p) = p0*p1*x^2 + p1*p2*y^2 + p2*x*y + p3*x + p4*y + p5

to 100 noise-corrupted measurements sampled on a 10x10 grid with
x, y in {-10, -8, ..., 8} (sample.c:35-39, 64-80), true parameters
(1, 2, 3, 4, 5, 6) (sample.c:28-33), +-0.5 units of uniform noise
(sample.c:60), and an initial state drawn uniformly from [-0.1, 0.9]
(sample.c:371). The reference asserts convergence within 8 accepted steps and
per-parameter recovery within 5e-2 (sample.c:365, 443-457); our integration
tests and benchmarks assert the same budget.

The C reference seeds glibc random(); exact noise streams are not
reproducible (nor meaningful) here — jax.random with a fixed key gives the
same determinism guarantee.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from libdogleg_tpu.ops.pallas_mega import lane_sum
from libdogleg_tpu.problems import (DenseProblem, FactoredBasisProblem,
                                    ProductsProblem,
                                    ResidualProblem, SparseProblem)
from libdogleg_tpu.sparsity import dense_structure

NSTATE = 6
GRID_WIDTH = 10
GRID_MIN = -10.0
GRID_DELTA = 2.0
NMEAS = GRID_WIDTH * GRID_WIDTH
P_TRUE = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])


def make_grid(dtype=jnp.float64) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The 10x10 sampling grid (reference sample.c:64-80; x-major order)."""
    coords = GRID_MIN + GRID_DELTA * np.arange(GRID_WIDTH)
    gx, gy = np.meshgrid(coords, coords, indexing="ij")
    return (jnp.asarray(gx.ravel(), dtype), jnp.asarray(gy.ravel(), dtype))


def model(p: jnp.ndarray, gx: jnp.ndarray, gy: jnp.ndarray) -> jnp.ndarray:
    return (p[0] * p[1] * gx * gx
            + p[1] * p[2] * gy * gy
            + p[2] * gx * gy
            + p[3] * gx
            + p[4] * gy
            + p[5])


def jacobian(p: jnp.ndarray, gx: jnp.ndarray, gy: jnp.ndarray) -> jnp.ndarray:
    """Closed-form (nmeas, 6) Jacobian (reference sample.c:118-123)."""
    one = jnp.ones_like(gx)
    return jnp.stack([
        p[1] * gx * gx,
        p[0] * gx * gx + p[2] * gy * gy,
        p[1] * gy * gy + gx * gy,
        gx,
        gy,
        one,
    ], axis=-1)


def products_lanes(p, meas):
    """Lane-form products for ops.pallas_mega.megakernel_optimize: p is a
    list of 6 lane vectors, meas[r] the lane vector of measurement r ->
    (norm2, Jt_x (6 lanes), JtJ lower triangle). Same math as
    model()/jacobian(); the grid coordinates of row r are computed from r
    (x-major, as make_grid), so one rolled loop walks the measurements."""
    dt = p[0].dtype
    c0, c1 = p[0] * p[1], p[1] * p[2]

    def row(r, acc):
        n2, jtx, jtj = acc
        r, w = r.astype(jnp.int32), np.int32(GRID_WIDTH)
        x = jax.lax.div(r, w).astype(dt) * GRID_DELTA + GRID_MIN
        y = jax.lax.rem(r, w).astype(dt) * GRID_DELTA + GRID_MIN
        xx, yy, xy = x * x, y * y, x * y
        e = c0 * xx + c1 * yy + p[2] * xy + p[3] * x + p[4] * y + p[5] \
            - meas[r]
        J = (p[1] * xx, p[0] * xx + p[2] * yy, p[1] * yy + xy,
             x, y, 1.0)
        n2 = n2 + e * e
        jtx = tuple(g + Ja * e for g, Ja in zip(jtx, J))
        jtj = tuple(tuple(h + J[a] * J[b] for b, h in enumerate(hr))
                    for a, hr in enumerate(jtj))
        return n2, jtx, jtj

    zero = jnp.zeros_like(p[0])
    acc0 = (zero, (zero,) * NSTATE,
            tuple((zero,) * (a + 1) for a in range(NSTATE)))
    n2, jtx, jtj = jax.lax.fori_loop(0, NMEAS, row, acc0)
    return n2, list(jtx), [list(r) for r in jtj]


def factored_products_lanes(G_pair):
    """Lane-form factored (sufficient-statistics) products for
    ops.pallas_mega.megakernel_optimize: config 3f inside the kernel.

    G_pair = gram_pair(dtype) is folded into the kernel as constants. The
    returned function takes (p, h_hi, h_lo, n2m_hi, n2m_lo): p a list of 6
    lane vectors and the statistics of factored_statistics as data
    (rows 0..5 of h_hi/h_lo, row 0 of n2m_hi/n2m_lo).

    The cancelling combinations (G c - h, m.m - c.h) run in compensated
    double-f32 exactly like FactoredBasisProblem.products, with the
    pairwise reduction replaced by a sequential two_sum cascade (same
    O(eps^2) error class). T's structure is hand-applied (8 nonzero
    entries), so JtJ/Jt_x assembly is ~40 lane ops."""
    from libdogleg_tpu.ops.compensated import two_prod, two_sum

    Ghi, Glo = (np.asarray(g) for g in G_pair)
    Gf = Ghi + Glo

    def products(p, h_hi, h_lo, n2m_hi, n2m_lo):
        hh = [h_hi[i] for i in range(NSTATE)]
        hl = [h_lo[i] for i in range(NSTATE)]
        # coefficients c = [p0 p1, p1 p2, p2, p3, p4, p5]
        c = [p[0] * p[1], p[1] * p[2], p[2], p[3], p[4], p[5]]

        # g = (G c - h) as compensated pairs, row by row, then collapsed
        g = []
        for i in range(NSTATE):
            s, lo = two_prod(c[0], Ghi[i, 0])
            lo = lo + Glo[i, 0] * c[0]
            for j in range(1, NSTATE):
                pj, pe = two_prod(c[j], Ghi[i, j])
                s, se = two_sum(s, pj)
                lo = lo + pe + se + Glo[i, j] * c[j]
            s, e = two_sum(s, -hh[i])
            g.append(s + (lo - hl[i] + e))

        # Jt_x = T^T g with T's sparsity hand-applied
        jtx = [p[1] * g[0], p[0] * g[0] + p[2] * g[1], p[1] * g[1] + g[2],
               g[3], g[4], g[5]]

        # JtJ = T^T G T: columns of M = G T, then rows of T^T M
        def M(i, j):
            if j == 0:
                return Gf[i, 0] * p[1]
            if j == 1:
                return Gf[i, 0] * p[0] + Gf[i, 1] * p[2]
            if j == 2:
                return Gf[i, 1] * p[1] + Gf[i, 2]
            return jnp.full_like(p[0], Gf[i, j])

        def TtM(a, b):
            if a == 0:
                return p[1] * M(0, b)
            if a == 1:
                return p[0] * M(0, b) + p[2] * M(1, b)
            if a == 2:
                return p[1] * M(1, b) + M(2, b)
            return M(a, b)

        jtj = [[TtM(a, b) for b in range(a + 1)] for a in range(NSTATE)]

        # norm2 = c.g + ((m.m) - c.h), the second term compensated
        cg = lane_sum(ci * gi for ci, gi in zip(c, g))
        wh, wl = two_prod(c[0], hh[0])
        wl = wl + c[0] * hl[0]
        for i in range(1, NSTATE):
            pi, pe = two_prod(c[i], hh[i])
            wh, se = two_sum(wh, pi)
            wl = wl + pe + se + c[i] * hl[i]
        uh, ue = two_sum(n2m_hi[0], -wh)
        norm2 = cg + (uh + (n2m_lo[0] - wl + ue))
        return jnp.maximum(norm2, 0.0), jtx, jtj

    return products


def simulate(key: jax.Array, dtype=jnp.float64,
             noise: float = 1.0) -> jnp.ndarray:
    """Noisy measurements: truth +- 0.5*noise units uniform (sample.c:46-62)."""
    gx, gy = make_grid(dtype)
    truth = model(jnp.asarray(P_TRUE, dtype), gx, gy)
    u = jax.random.uniform(key, (NMEAS,), dtype=dtype)
    return truth + (u - 0.5) * noise


def initial_state(key: jax.Array, dtype=jnp.float64) -> jnp.ndarray:
    """Initial guess uniform in [-0.1, 0.9] (sample.c:371)."""
    u = jax.random.uniform(key, (NSTATE,), dtype=dtype)
    return u - 0.1


def residuals(p: jnp.ndarray, measurements: jnp.ndarray,
              gx: jnp.ndarray, gy: jnp.ndarray) -> jnp.ndarray:
    return model(p, gx, gy) - measurements


def make_dense_problem(measurements: jnp.ndarray) -> DenseProblem:
    """Dense mode (reference optimizerCallback_dense, sample.c:130-162)."""
    dtype = measurements.dtype
    gx, gy = make_grid(dtype)

    def f(p):
        return residuals(p, measurements, gx, gy), jacobian(p, gx, gy)
    return DenseProblem(f=f)


def make_sparse_problem(measurements: jnp.ndarray,
                        block_rows: int = 4) -> SparseProblem:
    """Sparse mode. The demo problem is fully dense (sample.c:113-116), so
    the block pattern stores every block — exercising the BCSR machinery the
    way sample.c exercises the CHOLMOD path with a dense pattern."""
    dtype = measurements.dtype
    gx, gy = make_grid(dtype)
    structure = dense_structure(NMEAS, NSTATE,
                                block_rows=block_rows, block_cols=NSTATE)

    def f(p):
        x = residuals(p, measurements, gx, gy)
        J = jacobian(p, gx, gy)
        values = J.reshape(structure.nbrow, block_rows, 1, NSTATE)
        values = values.reshape(structure.nnzb, block_rows, NSTATE)
        return x, values
    return SparseProblem(f=f, structure=structure)


# ---------------------------------------------------------------------------
# Basis-factored sufficient-statistics formulation.
#
# The sample model is linear in a STATIC basis: model(p) = B @ coeffs(p)
# with B = [x^2, y^2, xy, x, y, 1] fixed by the grid, so
#     J          = B @ T(p),            T = d coeffs / dp  (6x6)
#     JtJ        = T^T (B^T B) T        (B^T B = G precomputed once)
#     Jt_x       = T^T (G c - B^T meas) (B^T meas = h precomputed per
#                                        instance)
#     norm2_x    = c.(G c - h) + (meas.meas - c.h)
# The per-attempt evaluation therefore reads 14 f32 of sufficient
# statistics instead of streaming all m measurements, and does O(n^2)
# flops instead of O(m n^2) — the difference between an HBM-bound and a
# carry-bound batched solve (see bench_kernels end_to_end rows). The
# reference's callback model cannot express this (the callback always
# walks the measurement vector, sample.c:130-237); it is an accelerator-first
# reformulation of the same mathematics.
#
# Numerics: G c and h carry ~1e7 magnitudes whose difference is the
# O(1e-3..1) gradient — plain f32 would cancel to noise. G, h and
# meas.meas are therefore held as double-f32 PAIRS and the cancelling
# combinations run in compensated arithmetic (ops/compensated.py), making
# the factored gradient MORE accurate than the general form's f32
# per-measurement reduction. coeffs(p) is used at its stored-f32 value,
# exactly as the general form rounds the same products.
# ---------------------------------------------------------------------------

def basis(gx: jnp.ndarray, gy: jnp.ndarray) -> jnp.ndarray:
    """The static (nmeas, 6) basis: model(p) = basis @ coeffs(p). Entries
    are integers <= 100 on the sample grid — exact in f32."""
    return jnp.stack([gx * gx, gy * gy, gx * gy, gx, gy,
                      jnp.ones_like(gx)], axis=-1)


def coeffs(p: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack([p[0] * p[1], p[1] * p[2], p[2], p[3], p[4], p[5]])


def coeffs_jac(p: jnp.ndarray) -> jnp.ndarray:
    """T[i, j] = d coeffs_i / d p_j."""
    one = jnp.ones((), p.dtype)
    T = jnp.zeros((NSTATE, NSTATE), p.dtype)
    T = T.at[0, 0].set(p[1]).at[0, 1].set(p[0])
    T = T.at[1, 1].set(p[2]).at[1, 2].set(p[1])
    T = T.at[2, 2].set(one).at[3, 3].set(one)
    T = T.at[4, 4].set(one).at[5, 5].set(one)
    return T


def factored_statistics(measurements: jnp.ndarray):
    """Per-instance sufficient statistics as double-f32 pairs:
    (h_hi, h_lo) = B^T meas and (n2m_hi, n2m_lo) = meas . meas."""
    gx, gy = make_grid(measurements.dtype)
    return FactoredBasisProblem.statistics(basis(gx, gy), measurements)


def gram_pair(dtype=jnp.float32):
    """G = B^T B as a double-f32 pair (exact integer entries up to ~1e10
    exceed f32's 24-bit integer range; computed in f64 numpy, split)."""
    coords = GRID_MIN + GRID_DELTA * np.arange(GRID_WIDTH)
    gx, gy = np.meshgrid(coords, coords, indexing="ij")
    gx, gy = gx.ravel(), gy.ravel()
    B = np.stack([gx * gx, gy * gy, gx * gy, gx, gy,
                  np.ones_like(gx)], axis=-1)
    return FactoredBasisProblem.gram(B, dtype)


def factored_products(p: jnp.ndarray, stats, G_pair):
    """Products from sufficient statistics (see module comment above).
    stats = factored_statistics(meas); G_pair = gram_pair(dtype)."""
    return FactoredBasisProblem(coeffs=coeffs, G_pair=G_pair,
                                stats=stats,
                                coeffs_jac=coeffs_jac).products(p)


def make_factored_problem(measurements: jnp.ndarray) -> FactoredBasisProblem:
    """The sufficient-statistics formulation as a drop-in problem: same
    optimum as make_dense_problem / make_products_problem, per-attempt
    cost independent of the measurement count."""
    return FactoredBasisProblem(
        coeffs=coeffs,
        G_pair=gram_pair(measurements.dtype),
        stats=factored_statistics(measurements),
        coeffs_jac=coeffs_jac)


def make_products_problem(measurements: jnp.ndarray) -> ProductsProblem:
    """Products mode (reference optimizerCallback_dense_products,
    sample.c:165-237): the user reduces over measurements themselves."""
    dtype = measurements.dtype
    gx, gy = make_grid(dtype)

    def f(p):
        x = residuals(p, measurements, gx, gy)
        J = jacobian(p, gx, gy)
        return (jnp.dot(x, x),
                jnp.matmul(J.T, x, preferred_element_type=dtype),
                jnp.matmul(J.T, J, preferred_element_type=dtype))
    return ProductsProblem(f=f)


def make_residual_problem(measurements: jnp.ndarray) -> ResidualProblem:
    """Autodiff mode (no reference equivalent)."""
    dtype = measurements.dtype
    gx, gy = make_grid(dtype)
    return ResidualProblem(f=lambda p: residuals(p, measurements, gx, gy))
