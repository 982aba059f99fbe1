"""Problem adapters: the library/user boundary.

The reference defines three callback flavors (reference dogleg.h:11-45):
sparse (x + CSR Jt), dense (x + row-major J), and dense-products
(norm2x, Jt_x, JtJ — for Nstate << Nmeasurements, so x and J never
materialize, reference dogleg.c:1054-1069). Each maps to an adapter class
here; all of them reduce an operating point to the solver's universal
`Products`. A fourth adapter, ResidualProblem, accepts a residual-only
function and derives the Jacobian by autodiff — something a C library cannot
offer.

User functions must be pure and jit-compatible (traced once); any extra data
(the reference's `cookie`, dogleg.h:20) is closed over or passed via
functools.partial.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from libdogleg_tpu.ops import bcsr as bops
from libdogleg_tpu.ops import dense as dops
from libdogleg_tpu.ops.bcsr import BCSRJacobian, BCSRStructure
from libdogleg_tpu.params import DoglegParameters
from libdogleg_tpu.solver import Products, SolveResult, solve_products


@dataclasses.dataclass(frozen=True)
class DenseProblem:
    """Dense formulation: f(p) -> (x, J) with J of shape (nmeas, nstate)
    (reference dogleg_callback_dense_t, dogleg.h:21-30)."""
    f: Callable[[jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray]]

    def products(self, p: jnp.ndarray) -> Products:
        x, J = self.f(p)
        return Products(norm2_x=dops.norm2(x),
                        Jt_x=dops.jt_dot(J, x),
                        JtJ=dops.build_jtj(J))

    def full(self, p: jnp.ndarray):
        """(x, J) for analysis paths (gradient check, outlierness)."""
        return self.f(p)

    def dense_jacobian(self, p: jnp.ndarray) -> jnp.ndarray:
        return self.f(p)[1]


@dataclasses.dataclass(frozen=True)
class SparseProblem:
    """Block-sparse formulation: f(p) -> (x, values) where values is the
    (nnzb, bm, bn) block-value tensor for the fixed `structure`
    (reference dogleg_callback_t, dogleg.h:11-20, with the static BCSR
    structure playing the role of the one-time symbolic analysis).

    jtj selects the Gauss-Newton system representation:
      "dense"  (default): JtJ materializes as (nstate, nstate) — right while
        nstate is moderate (one dense Cholesky beats any sparse
        schedule there).
      "sparse": JtJ stays block-sparse on its symbolic lower-triangle
        pattern and the Newton step runs through the level-scheduled
        block-sparse Cholesky (the CHOLMOD regime, for large nstate).
        `ordering` is the fill-reducing ordering passed to the analysis.
    Pass `default_newton_solver()` to the solver (optimize() does this
    automatically when no newton_solver is given)."""
    f: Callable[[jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray]]
    structure: BCSRStructure
    jtj: str = "dense"
    # None picks the right companion: "mindeg" simplicial, "rcm" amalgamated
    ordering: object = None
    amalgamate: int = 1
    _jtj_sched: object = dataclasses.field(init=False, default=None,
                                           repr=False, compare=False)
    _newton: object = dataclasses.field(init=False, default=None,
                                        repr=False, compare=False)

    def __post_init__(self):
        if self.jtj not in ("dense", "sparse"):
            raise ValueError(f"jtj must be 'dense' or 'sparse', "
                             f"got {self.jtj!r}")
        if self.jtj == "sparse":
            from libdogleg_tpu.ops.newton import SparseNewtonSolver
            s = self.structure
            if s.block_rows > 1 and s.nmeas % s.block_rows:
                raise ValueError("nmeas must divide into block rows")
            sched = bops.jtj_lower_schedule(s)
            ns = SparseNewtonSolver.analyze(
                sched.rows, sched.cols, s.nbcol, s.block_cols,
                self.ordering, amalgamate=self.amalgamate)
            object.__setattr__(self, "_jtj_sched", sched)
            object.__setattr__(self, "_newton", ns)

    def jacobian(self, p: jnp.ndarray) -> Tuple[jnp.ndarray, BCSRJacobian]:
        x, values = self.f(p)
        return x, BCSRJacobian(structure=self.structure, values=values)

    def products(self, p: jnp.ndarray) -> Products:
        x, J = self.jacobian(p)
        if self.jtj == "sparse":
            JtJ = bops.bcsr_jtj_lower_blocks(J, self._jtj_sched)
        else:
            JtJ = bops.bcsr_jtj_dense(J)
        return Products(norm2_x=dops.norm2(x),
                        Jt_x=bops.bcsr_jt_x(J, x),
                        JtJ=JtJ)

    def default_newton_solver(self):
        return self._newton  # None for "dense" -> solver default

    def full(self, p: jnp.ndarray):
        x, J = self.jacobian(p)
        return x, bops.bcsr_to_dense(J)

    def dense_jacobian(self, p: jnp.ndarray) -> jnp.ndarray:
        return self.full(p)[1]


@dataclasses.dataclass(frozen=True)
class ProductsProblem:
    """Products formulation: f(p) -> (norm2x, Jt_x, JtJ) with JtJ full
    symmetric (reference dogleg_callback_dense_products_t, dogleg.h:34-45).
    Packed-triangle callbacks can be adapted with
    libdogleg_tpu.utils.packed.packed_to_full."""
    f: Callable[[jnp.ndarray],
                Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]

    def products(self, p: jnp.ndarray) -> Products:
        norm2x, Jt_x, JtJ = self.f(p)
        return Products(norm2_x=norm2x, Jt_x=Jt_x, JtJ=JtJ)


@dataclasses.dataclass(frozen=True)
class ResidualProblem:
    """Residual-only formulation: f(p) -> x; the Jacobian comes from autodiff
    (jacfwd — nmeas >= nstate makes forward mode the right default). No
    reference equivalent: the C library requires hand-written Jacobians and
    ships a checker for them (dogleg.c:349-522); autodiff makes both
    unnecessary."""
    f: Callable[[jnp.ndarray], jnp.ndarray]

    def products(self, p: jnp.ndarray) -> Products:
        x, J = self.full(p)
        return Products(norm2_x=dops.norm2(x),
                        Jt_x=dops.jt_dot(J, x),
                        JtJ=dops.build_jtj(J))

    def full(self, p: jnp.ndarray):
        return self.f(p), jax.jacfwd(self.f)(p)

    def dense_jacobian(self, p: jnp.ndarray) -> jnp.ndarray:
        return jax.jacfwd(self.f)(p)


@dataclasses.dataclass(frozen=True)
class FactoredBasisProblem:
    """Separable (basis-factored) residual: x(p) = B @ coeffs(p) - meas
    with B a STATIC (nmeas, nbasis) basis and coeffs(p) the (usually much
    smaller) nonlinear core. Then with G = B^T B and h = B^T meas
    precomputed,

        J     = B T,  T = d coeffs / dp
        JtJ   = T^T G T
        Jt_x  = T^T (G c - h)
        norm2 = c.(G c - h) + (meas.meas - c.h)

    so the per-attempt evaluation never touches the measurement axis: it
    reads 2*nbasis + 2 floats of sufficient statistics and does
    O(nbasis^2) flops: a measurement-stream-bound solve becomes a
    carry-bound one. The reference's callback contract cannot express
    this — its callbacks always walk the measurement vector
    (reference dogleg.h:24-45) — it is an accelerator-first reformulation of the
    same mathematics, exact up to float association.

    Numerics: G c and h are large and cancel down to the gradient scale,
    far below f32 resolution, so G, h and meas.meas are held as
    double-f32 pairs and the cancelling combinations run in compensated
    arithmetic (ops/compensated.py). The factored f32 gradient is
    thereby MORE accurate than a per-measurement f32 reduction
    (tests/test_factored.py).

    coeffs_jac defaults to autodiff (jacfwd of coeffs); pass a closed
    form when you have one. Construct per-instance statistics with
    FactoredBasisProblem.statistics(B, meas) (vmap-able for batches) and
    the static Gram pair with FactoredBasisProblem.gram(B64, dtype) —
    compute B in float64 there, Gram entries routinely exceed f32's
    exact-integer range."""
    coeffs: Callable[[jnp.ndarray], jnp.ndarray]
    G_pair: Tuple[jnp.ndarray, jnp.ndarray]
    stats: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]
    coeffs_jac: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None

    @staticmethod
    def gram(B64, dtype) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """G = B^T B as a double-f32 (or degenerate f64) pair; B64 must
        be float64 (numpy or jax) so the split captures the low bits."""
        import numpy as np
        B64 = np.asarray(B64, np.float64)
        G = B64.T @ B64
        hi = G.astype(np.float32).astype(np.float64)
        return (jnp.asarray(hi, dtype), jnp.asarray(G - hi, dtype))

    @staticmethod
    def statistics(B, measurements):
        """Per-instance sufficient statistics as compensated pairs:
        (h_hi, h_lo, n2m_hi, n2m_lo) with h = B^T meas, n2m = meas.meas.
        vmap over measurements for a batch."""
        from libdogleg_tpu.ops import compensated as comp
        hh, hl = comp.comp_matvec(jnp.swapaxes(B, -1, -2), measurements)
        p, e = comp.two_prod(measurements, measurements)
        nh, nl = comp.comp_reduce(p, e, axis=-1)
        return hh, hl, nh, nl

    def products(self, p: jnp.ndarray) -> Products:
        from libdogleg_tpu.ops import compensated as comp
        hh, hl, nh, nl = self.stats
        Ghi, Glo = self.G_pair
        c = self.coeffs(p)
        T = (self.coeffs_jac or jax.jacfwd(self.coeffs))(p)
        gh, gl = comp.comp_matvec_pair(Ghi, Glo, c)      # G c
        dh, dl = comp.pair_add(gh, gl, -hh, -hl)         # g = G c - h
        g = comp.collapse(dh, dl)
        hiP = jax.lax.Precision.HIGHEST
        Jt_x = jnp.matmul(T.T, g, precision=hiP,
                          preferred_element_type=p.dtype)
        JtJ = jnp.matmul(T.T,
                         jnp.matmul(Ghi + Glo, T, precision=hiP,
                                    preferred_element_type=p.dtype),
                         precision=hiP, preferred_element_type=p.dtype)
        wh, wl = comp.pair_dot_pair(c, hh, hl)           # c . h
        uh, ul = comp.pair_add(nh, nl, -wh, -wl)         # n2m - c.h
        norm2 = jnp.dot(c, g) + comp.collapse(uh, ul)
        # The compensated c.(Gc-h) + (m.m - c.h) combination can cancel a
        # hair below zero near the optimum (the general form's x@x cannot);
        # clamp so downstream sqrt/scale consumers never see a negative
        # cost. Exact whenever the true value is nonnegative.
        norm2 = jnp.maximum(norm2, jnp.zeros_like(norm2))
        return Products(norm2_x=norm2, Jt_x=Jt_x, JtJ=JtJ)


def optimize(problem,
             p0: jnp.ndarray,
             parameters: Optional[DoglegParameters] = None,
             *,
             newton_solver=None,
             record_history: bool = False,
             history_capacity: Optional[int] = None,
             debug: bool = False) -> SolveResult:
    """Top-level solve — the counterpart of dogleg_optimize2 /
    dogleg_optimize_dense2 / dogleg_optimize_dense_products (reference
    dogleg.c:1755-1818), with the solve-type dispatch replaced by the problem
    adapter's `products` method. Returns the full SolveResult (the reference
    returns norm2(x) and optionally the solver context, dogleg.c:1694-1752).

    jit/vmap-compatible: wrap in jax.jit for production use; vmap over p0
    (and over closed-over problem data via the adapters' pytree fields) for
    batched solves.
    """
    if newton_solver is None:
        default = getattr(problem, "default_newton_solver", None)
        if default is not None:
            newton_solver = default()
    return solve_products(problem.products, p0, parameters,
                          newton_solver=newton_solver,
                          record_history=record_history,
                          history_capacity=history_capacity,
                          debug=debug)
