"""Newton-system strategies: how the solver factors and solves JtJ.

The reference hardwires two backends — CHOLMOD sparse Cholesky and LAPACK
packed dense Cholesky — selected by solve_type (reference dogleg.c:634-908).
Here the Gauss-Newton system is a *strategy object*: the trust-region driver
only ever needs two operations on whatever representation Products.JtJ
carries,

    quad_form(JtJ, v)                    == norm2(J v)
    gauss_newton(JtJ, Jt_x, lam, ...)    == solve (JtJ + lam I) u = Jt_x; -u

so structured representations (Schur-complement BA systems, block-sparse
factors) plug in without touching the driver. All strategies preserve the
reference's permanent escalating-lambda semantics (dogleg.c:137-138,
670-676).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from libdogleg_tpu.ops import cholesky as chol
from libdogleg_tpu.ops import compensated as comp


class GNResult(NamedTuple):
    step: jnp.ndarray     # (Nstate,) the negated Newton solution
    norm2_step: jnp.ndarray
    lam: jnp.ndarray      # possibly escalated permanent lambda
    ok: jnp.ndarray       # factorization succeeded


# Mixed-precision residual computation for iterative refinement. Two
# levels matter: (1) a float32 matmul at Precision.DEFAULT may multiply
# in a reduced format (TF32 on the GPU, ~2^-11 relative per product) —
# HIGHEST forces true-f32 multiplication for the residual contractions; (2) even a
# true-f32 residual r = b - A u carries rounding ~ n*eps32*|A||u|, the
# same order as the solve error it is measuring, so refinement against
# it stalls near the unrefined forward error. The strategies therefore
# accumulate their refinement residuals in DOUBLE-f32 compensated
# arithmetic (ops/compensated.py) wherever the structure permits —
# error-free products + cascaded two_sum — making the residual accurate
# to ~eps of its OWN magnitude and letting refinement converge to the
# f32 representation floor.
_HI = jax.lax.Precision.HIGHEST


def _refine(u, solve_fn, resid_fn, iters: int):
    """Classical iterative refinement against a low-precision factor:
    u_{k+1} = u_k + A^{-1} r(u_k), with the residual r computed by
    resid_fn (compensated, see module note) and the correction solved
    with the ALREADY-COMPUTED factor (cost per pass: one matvec + one
    factor solve — no refactorization). Recovers near-f64 solve accuracy
    while all heavy work stays f32 (the reference's contract is C
    doubles end-to-end, dogleg.c:125-127; this is the f32-native route
    back toward it). u is a pytree (flat vector or structured state)."""
    for _ in range(iters):
        u = jax.tree_util.tree_map(lambda a, d: a + d, u,
                                   solve_fn(resid_fn(u)))
    return u


@dataclasses.dataclass(frozen=True)
class DenseNewtonSolver:
    """Default: JtJ is a dense (Nstate, Nstate) symmetric matrix
    (the reference's LAPACK path, generalized to the sparse path too since
    the BCSR adapter materializes dense JtJ for moderate Nstate).

    refine_iters > 0 runs that many iterative-refinement passes of the GN
    solve against the computed factor (see _refine) — the mixed-precision
    option that recovers near-f64 solve accuracy on float32 device paths."""
    refine_iters: int = 0

    def quad_form(self, JtJ, v):
        return jnp.dot(v, jnp.matmul(JtJ, v,
                                     preferred_element_type=JtJ.dtype))

    def gauss_newton(self, JtJ, Jt_x, lam, *, lambda_initial,
                     lambda_max_tries) -> GNResult:
        fac = chol.factorize_jtj(JtJ, lam, lambda_initial=lambda_initial,
                                 lambda_max_tries=lambda_max_tries)
        step, n2 = chol.gauss_newton_step(fac.L, Jt_x)
        if self.refine_iters:
            def resid(v):
                hi, lo = comp.comp_matvec(JtJ, v)
                hi, lo = comp.pair_add_prod(hi, lo, fac.lam, v)
                return comp.residual(Jt_x, hi, lo)

            u = _refine(-step, lambda r: chol.cholesky_solve(fac.L, r),
                        resid, self.refine_iters)
            step = -u
            n2 = jnp.dot(step, step)
        return GNResult(step=step, norm2_step=n2, lam=fac.lam, ok=fac.ok)


# BlockedDenseNewtonSolver wins for BATCHED mid-size Nstate (17..256);
# batched_optimize auto-selects it there (parallel/batched.py).
BLOCKED_MIN_N = 17
BLOCKED_MAX_N = 256


@dataclasses.dataclass(frozen=True)
class BlockedDenseNewtonSolver:
    """Dense JtJ through the 16-block-panel Cholesky (ops/blockchol.py).

    The mid-size BATCHED regime (Nstate 17..256, thousands of vmapped
    instances): the blocked-panel form keeps the O(n^3) work in batched
    matmuls and the per-column recurrences as unrolled flat elementwise
    DAGs. Whether it beats XLA's lax.linalg (cuSOLVER) lowering on the
    GPU is not measured yet (ROADMAP A5). Trade-off: trace-time unrolling grows compile
    time with Nstate (tens of seconds at Nstate=128) — right for production
    batched solves, wrong for one-off single solves, hence a separate
    strategy rather than a new factorize_jtj default.

    Above BLOCKED_MAX_N the factorization dispatches to the recursive
    GEMM-dominant form (ops/largechol.py) instead: compile size stays
    O(n/panel), the trailing updates run as large matmuls, and the
    triangular solves ride lax.linalg (O(n^2), off the critical flops).
    One strategy covers dense Nstate 17..thousands."""
    refine_iters: int = 0

    def quad_form(self, JtJ, v):
        return jnp.dot(v, jnp.matmul(JtJ, v,
                                     preferred_element_type=JtJ.dtype))

    def gauss_newton(self, JtJ, Jt_x, lam, *, lambda_initial,
                     lambda_max_tries) -> GNResult:
        from libdogleg_tpu.ops import blockchol, largechol

        n = JtJ.shape[-1]
        eye = jnp.eye(n, dtype=JtJ.dtype)
        large = n > BLOCKED_MAX_N

        def try_factor(lm):
            L, ok = (largechol.large_cholesky if large
                     else blockchol.blocked_cholesky)(JtJ + lm * eye)
            return L, jnp.all(ok)

        L, lam, ok = chol.escalating_lambda(
            try_factor, lam, JtJ.dtype, lambda_initial=lambda_initial,
            lambda_max_tries=lambda_max_tries)

        def solve(r):
            if large:
                return chol.cholesky_solve(L, r)
            return blockchol.blocked_cho_solve(L, r)

        u = solve(Jt_x)
        if self.refine_iters:
            def resid(v):
                hi, lo = comp.comp_matvec(JtJ, v)
                hi, lo = comp.pair_add_prod(hi, lo, lam, v)
                return comp.residual(Jt_x, hi, lo)

            u = _refine(u, solve, resid, self.refine_iters)
        step = -u
        return GNResult(step=step, norm2_step=jnp.dot(step, step),
                        lam=lam, ok=ok)


class SchurJtJ(NamedTuple):
    """BA-style arrow-structured Gauss-Newton system.

    State layout: p = [dense block (nc params) | np point blocks of size bs],
    Nstate = nc + np*bs. JtJ = [[U, W], [W^T, V]] with V block-diagonal —
    the classic bundle-adjustment structure (SURVEY.md section 5.7;
    BASELINE.md config 4). No reference equivalent: libdogleg hands such
    systems whole to CHOLMOD.
    """
    U: jnp.ndarray         # (nc, nc) dense camera/global block
    W: jnp.ndarray         # (nc, np, bs) coupling blocks
    V: jnp.ndarray         # (np, bs, bs) point diagonal blocks


def schur_split(v: jnp.ndarray, nc: int, n_points: int, bs: int):
    return v[:nc], v[nc:].reshape(n_points, bs)


@dataclasses.dataclass(frozen=True)
class SchurNewtonSolver:
    """Gauss-Newton via Schur-complement elimination of the point blocks.

    factorize: Vhat_i = V_i + lam I (vmapped small Cholesky, batch
    friendly); S = U + lam I - sum_i W_i Vhat_i^{-1} W_i^T (one batched
    einsum); dense Cholesky of S.
    solve:     y_i = Vhat_i^{-1} rp_i; dc = S^{-1}(rc - sum_i W_i y_i);
               dp_i = Vhat_i^{-1}(rp_i - W_i^T dc).

    This keeps only nc^2 + np*bs^2 state resident instead of Nstate^2 and
    turns the factorization into batched small blocks + one small dense
    factor — the accelerator shape for BA problems.
    """
    nc: int
    n_points: int
    block_size: int
    # Point-block factor/solve backend for block_size <= 16:
    #   "unrolled" (default) — smallchol flat elementwise DAGs.
    #   "lax" — lax.linalg, kept as an escape hatch: if a model's solve
    #     regresses with the default, A/B this flag. Which wins on the
    #     GPU is not measured yet (ROADMAP C4).
    # block_size > 16 always uses lax.
    point_solver: str = "unrolled"
    # iterative-refinement passes of the GN solve against the computed
    # factors (see _refine); corrects f32/bf16 rounding in the point
    # eliminations AND the reduced-system assembly einsums.
    refine_iters: int = 0

    def quad_form(self, JtJ: SchurJtJ, v):
        vc, vp = schur_split(v, self.nc, self.n_points, self.block_size)
        uv = jnp.dot(vc, jnp.matmul(JtJ.U, vc,
                                    preferred_element_type=vc.dtype))
        wv = jnp.einsum('cpb,pb->c', JtJ.W, vp,
                        preferred_element_type=vc.dtype)
        vv = jnp.einsum('pb,pbk,pk->', vp, JtJ.V, vp,
                        preferred_element_type=vc.dtype)
        return uv + 2.0 * jnp.dot(vc, wv) + vv

    def factor(self, JtJ: SchurJtJ, lam):
        """Factorize JtJ + lam*I once at a FIXED lambda (no escalation).

        Returns ((Lv, Ls), ok): Lv (np, bs, bs) lower Cholesky factors of
        the damped point blocks, Ls (nc, nc) lower Cholesky factor of the
        Schur complement S, ok scalar bool. This is the public
        cached-factorization handle: analysis passes (outlierness,
        query-point confidence) recompute the solve's factorization once
        via this method and share it across queries — the reference's
        reuse-or-recompute semantics (dogleg.c:2636-2652) without keeping
        mutable factor state inside SolveResult. The tuple layout is a
        stable contract (used by analysis.get_outlierness_factors_ba)."""
        from libdogleg_tpu.ops import smallchol

        bs = self.block_size
        eye_b = jnp.eye(bs, dtype=JtJ.V.dtype)
        Vhat = JtJ.V + lam * eye_b
        Wt = jnp.transpose(JtJ.W, (1, 2, 0))            # (np, bs, nc)
        if bs <= smallchol.SMALL_N_MAX and self.point_solver == "unrolled":
            # batched tiny blocks: XLA's lax.linalg lowering is the wrong
            # regime by orders of magnitude (measured (20000, 3, 3):
            # 6832 us chol / 483 us trisolve vs 9.4 us / 88 us unrolled)
            Lv, okb = smallchol.small_cholesky(Vhat)    # (np, bs, bs)
            ok_v = jnp.all(okb)
            Y = smallchol.small_cho_solve_mat(Lv, Wt)
        else:
            Lv = jnp.linalg.cholesky(Vhat)
            ok_v = jnp.all(jnp.isfinite(Lv)) & jnp.all(
                jnp.diagonal(Lv, axis1=-2, axis2=-1) > 0)
            # Vhat^{-1} W^T via batched triangular solves per point block.
            Y = jax.lax.linalg.triangular_solve(Lv, Wt, left_side=True,
                                                lower=True)
            Y = jax.lax.linalg.triangular_solve(Lv, Y, left_side=True,
                                                lower=True,
                                                transpose_a=True)
        # S = U + lam I - sum_p W_p Vhat_p^{-1} W_p^T
        S = (JtJ.U + lam * jnp.eye(self.nc, dtype=JtJ.U.dtype)
             - jnp.einsum('cpb,pbd->cd', JtJ.W, Y,
                          preferred_element_type=JtJ.U.dtype))
        Ls = jnp.linalg.cholesky(S)
        ok_s = jnp.all(jnp.isfinite(Ls)) & jnp.all(jnp.diag(Ls) > 0)
        return (Lv, Ls), ok_v & ok_s

    def _gn_core(self, JtJ: SchurJtJ, rc, rp, lam, lambda_initial,
                 lambda_max_tries):
        """Factor (with the escalating-lambda loop) and solve for the
        camera/point step pair (dc, dp)."""
        (Lv, Ls), lam, ok = chol.escalating_lambda(
            lambda lm: self.factor(JtJ, lm), lam, rc.dtype,
            lambda_initial=lambda_initial,
            lambda_max_tries=lambda_max_tries)

        from libdogleg_tpu.ops import smallchol

        def vsolve(b):
            # (np, bs, k) batched solve with the point-block factors
            if (self.block_size <= smallchol.SMALL_N_MAX
                    and self.point_solver == "unrolled"):
                return smallchol.small_cho_solve_mat(Lv, b)
            y = jax.lax.linalg.triangular_solve(Lv, b, left_side=True,
                                                lower=True)
            return jax.lax.linalg.triangular_solve(Lv, y, left_side=True,
                                                   lower=True,
                                                   transpose_a=True)

        def solve_pair(bc, bp):
            # exact A^{-1} given the factors (Schur elimination is
            # algebraically exact): y = Vhat^{-1} bp; dc from S; back-sub
            y = vsolve(bp[..., None])[..., 0]           # (np, bs)
            sc = chol.cholesky_solve(
                Ls, bc - jnp.einsum('cpb,pb->c', JtJ.W, y,
                                    preferred_element_type=bc.dtype))
            sp = vsolve((bp - jnp.einsum('cpb,c->pb', JtJ.W, sc,
                                         preferred_element_type=bc.dtype)
                         )[..., None])[..., 0]
            return sc, sp

        dc, dp = solve_pair(rc, rp)
        if self.refine_iters:
            def resid(v):
                vc, vp = v
                # camera rows: U vc + lam vc + sum_pb W[c,p,b] vp[p,b]
                hc, lc = comp.comp_matvec(JtJ.U, vc)
                hc, lc = comp.pair_add_prod(hc, lc, lam, vc)
                hw, lw = comp.comp_contract(
                    JtJ.W, vp, reduce_axes=(1, 2),
                    broadcast=lambda x: x[None, :, :])
                hc, lc = comp.pair_add(hc, lc, hw, lw)
                # point rows: W^T vc + V vp + lam vp
                h1, l1 = comp.comp_contract(
                    JtJ.W, vc, reduce_axes=(0,),
                    broadcast=lambda x: x[:, None, None])
                h2, l2 = comp.comp_contract(
                    JtJ.V, vp, reduce_axes=(2,),
                    broadcast=lambda x: x[:, None, :])
                hp, lp = comp.pair_add(h1, l1, h2, l2)
                hp, lp = comp.pair_add_prod(hp, lp, lam, vp)
                return comp.residual(rc, hc, lc), comp.residual(rp, hp, lp)

            dc, dp = _refine((dc, dp), lambda r: solve_pair(*r), resid,
                             self.refine_iters)
        return dc, dp, lam, ok

    def gauss_newton(self, JtJ: SchurJtJ, Jt_x, lam, *, lambda_initial,
                     lambda_max_tries) -> GNResult:
        rc, rp = schur_split(Jt_x, self.nc, self.n_points, self.block_size)
        dc, dp, lam, ok = self._gn_core(JtJ, rc, rp, lam, lambda_initial,
                                        lambda_max_tries)
        step = -jnp.concatenate([dc, dp.reshape(-1)])
        return GNResult(step=step, norm2_step=jnp.dot(step, step),
                        lam=lam, ok=ok)


@dataclasses.dataclass(frozen=True)
class TreeSchurNewtonSolver(SchurNewtonSolver):
    """SchurNewtonSolver over structured pytree states
    {"c": (nc,), "q": (n_points, bs)} instead of one flat vector.

    The point of the structure: each leaf carries its OWN mesh sharding, so
    the camera block stays replicated while the point states/gradients/
    steps shard over a "pts" mesh axis together with the SchurJtJ W/V
    blocks — GSPMD then keeps the whole solve distributed (per-point work
    local, one all-reduce for the nc-sized reduced system per
    factorization). A flat (nc + np*bs,) vector cannot express that mixed
    sharding, which is why solver states are pytrees (SURVEY.md section
    2.2: row-block partitioning + Schur elimination via collectives)."""

    def quad_form(self, JtJ: SchurJtJ, v):
        vc, vp = v["c"], v["q"]
        uv = jnp.dot(vc, jnp.matmul(JtJ.U, vc,
                                    preferred_element_type=vc.dtype))
        wv = jnp.einsum('cpb,pb->c', JtJ.W, vp,
                        preferred_element_type=vc.dtype)
        vv = jnp.einsum('pb,pbk,pk->', vp, JtJ.V, vp,
                        preferred_element_type=vc.dtype)
        return uv + 2.0 * jnp.dot(vc, wv) + vv

    def gauss_newton(self, JtJ: SchurJtJ, Jt_x, lam, *, lambda_initial,
                     lambda_max_tries) -> GNResult:
        dc, dp, lam, ok = self._gn_core(JtJ, Jt_x["c"], Jt_x["q"], lam,
                                        lambda_initial, lambda_max_tries)
        step = {"c": -dc, "q": -dp}
        n2 = jnp.dot(dc, dc) + jnp.sum(dp * dp)
        return GNResult(step=step, norm2_step=n2, lam=lam, ok=ok)


@dataclasses.dataclass(frozen=True)
class SparseNewtonSolver:
    """General block-sparse Gauss-Newton systems via the level-scheduled
    block-sparse Cholesky (libdogleg_tpu.sparse_cholesky) — the CHOLMOD
    replacement for patterns that are neither dense nor arrow-structured.

    Products.JtJ is the (n_input_blocks, b, b) tensor of stored
    lower-triangle blocks in the pattern this strategy was analyzed for.
    The symbolic analysis (fill + level schedules) happens once at
    construction, mirroring the reference's single cholmod_analyze
    (dogleg.c:649-654).
    """
    symbolic: "object"  # SparseCholeskySymbolic (kept loose to avoid cycle)
    # iterative-refinement passes of the GN solve (see _refine)
    refine_iters: int = 0

    @staticmethod
    def analyze(rows, cols, nb: int, b: int = 1,
                ordering=None,
                amalgamate: int = 1) -> "SparseNewtonSolver":
        """amalgamate > 1 merges that many consecutive (post-ordering)
        block columns into supernodes (libdogleg_tpu.supernodal): fewer,
        fatter dependency levels — the matmul-friendly regime for small b.

        ordering defaults to the right companion of the factorization
        style: "mindeg" (fill-minimizing) for the simplicial path, "rcm"
        (bandwidth-minimizing, keeps grouped supernodes banded) when
        amalgamating — minimum degree scatters structurally-related
        columns and makes fixed-width grouping couple distant nodes
        (measured 7x regression)."""
        if ordering is None:
            ordering = "rcm" if amalgamate > 1 else "mindeg"
        if amalgamate > 1:
            from libdogleg_tpu import supernodal as sn
            return SparseNewtonSolver(
                symbolic=sn.analyze(rows, cols, nb, b, ordering,
                                    amalgamate=amalgamate))
        from libdogleg_tpu import sparse_cholesky as sc
        return SparseNewtonSolver(
            symbolic=sc.analyze(rows, cols, nb, b, ordering))

    def _backend(self):
        if hasattr(self.symbolic, "inner"):
            from libdogleg_tpu import supernodal as sn
            return sn
        from libdogleg_tpu import sparse_cholesky as sc
        return sc

    def quad_form(self, blocks, v):
        # works for both symbolic kinds: in_rows/in_cols/nb/b are the
        # ORIGINAL pattern on either
        sym = self.symbolic
        b = sym.b
        vb = v.reshape(sym.nb, b)
        vi = vb[jnp.asarray(sym.in_rows)]
        vj = vb[jnp.asarray(sym.in_cols)]
        per_block = jnp.einsum('ka,kab,kb->k', vi, blocks, vj,
                               preferred_element_type=v.dtype)
        offdiag = jnp.asarray((sym.in_rows != sym.in_cols).astype(np.int8))
        weight = jnp.where(offdiag == 1, 2.0, 1.0).astype(v.dtype)
        return jnp.sum(per_block * weight)

    def gauss_newton(self, blocks, Jt_x, lam, *, lambda_initial,
                     lambda_max_tries) -> GNResult:
        be = self._backend()
        L, lam, ok = be.factorize_with_lambda(
            self.symbolic, blocks, lam, lambda_initial=lambda_initial,
            lambda_max_tries=lambda_max_tries)
        u = be.solve(self.symbolic, L, Jt_x)
        if self.refine_iters:
            sym = self.symbolic
            b = sym.b
            rows_np = np.asarray(sym.in_rows)
            cols_np = np.asarray(sym.in_cols)
            K = rows_np.shape[0]
            # A scatter-add matvec would round each accumulation in f32
            # and defeat the compensated residual, so build (trace-time,
            # from the static symbolic pattern) a padded per-block-row
            # GATHER table instead: stored lower block B_k at (i, j)
            # contributes product index k (B_k v_j) to row i and index
            # K+k (B_k^T v_i) to row j when off-diagonal; rows then
            # compensated-reduce their gathered exact-product pairs.
            terms = [[] for _ in range(sym.nb)]
            for k, (i, j) in enumerate(zip(rows_np, cols_np)):
                terms[int(i)].append(k)
                if i != j:
                    terms[int(j)].append(K + k)
            width = max(len(t) for t in terms)
            tbl = np.zeros((sym.nb, width), np.int32)
            msk = np.zeros((sym.nb, width), bool)
            for i, t in enumerate(terms):
                tbl[i, :len(t)] = t
                msk[i, :len(t)] = True
            tbl_j, msk_j = jnp.asarray(tbl), jnp.asarray(msk[..., None])
            rows_j, cols_j = jnp.asarray(rows_np), jnp.asarray(cols_np)

            def resid(v):
                vb = v.reshape(sym.nb, b)
                pl, el = comp.comp_contract(      # B_k @ v_{cols[k]}
                    blocks, vb[cols_j], reduce_axes=(2,),
                    broadcast=lambda x: x[:, None, :])
                pu, eu = comp.comp_contract(      # B_k^T @ v_{rows[k]}
                    blocks, vb[rows_j], reduce_axes=(1,),
                    broadcast=lambda x: x[:, :, None])
                H = jnp.where(msk_j, jnp.concatenate([pl, pu])[tbl_j], 0)
                E = jnp.where(msk_j, jnp.concatenate([el, eu])[tbl_j], 0)
                hi, lo = comp.comp_reduce(H, E, axis=1)
                hi, lo = comp.pair_add_prod(hi.reshape(-1),
                                            lo.reshape(-1), lam, v)
                return comp.residual(Jt_x, hi, lo)

            u = _refine(u, lambda r: be.solve(sym, L, r), resid,
                        self.refine_iters)
        step = -u
        return GNResult(step=step, norm2_step=jnp.dot(step, step),
                        lam=lam, ok=ok)


def schur_to_dense(JtJ: SchurJtJ) -> jnp.ndarray:
    """Densify the arrow structure (test oracle helper)."""
    nc = JtJ.U.shape[0]
    n_points, bs, _ = JtJ.V.shape
    n = nc + n_points * bs
    out = jnp.zeros((n, n), JtJ.U.dtype)
    out = out.at[:nc, :nc].set(JtJ.U)
    W = JtJ.W.reshape(nc, n_points * bs)
    out = out.at[:nc, nc:].set(W)
    out = out.at[nc:, :nc].set(W.T)
    Vd = jax.scipy.linalg.block_diag(*[JtJ.V[i] for i in range(n_points)])
    return out.at[nc:, nc:].set(Vd)


class SparseWSchurJtJ(NamedTuple):
    """Arrow system with SPARSE camera-point coupling: the realistic
    bundle-adjustment regime where each point is observed by only k_obs of
    the cameras. The dense SchurJtJ.W is (nc, np, bs) — 460 MB at
    ncam=128/np=50000/bs=3 — while only k_obs blocks per point are
    nonzero; this form stores exactly those.

    No reference equivalent (libdogleg hands BA systems whole to CHOLMOD);
    the design rule here is scatter-free consumption: every camera-axis
    reduction is a one-hot einsum and every camera-axis broadcast is a
    gather (scatters serialize on the accelerator this library was first
    built for; their cost on the GPU is not measured).
    """
    U: jnp.ndarray        # (nc, nc) dense camera block (nc = ncam * cb)
    Wv: jnp.ndarray       # (np, k_obs, cb, bs) nonzero W blocks, point-major
    cam_of: jnp.ndarray   # (np, k_obs) int32: which camera each block couples
    V: jnp.ndarray        # (np, bs, bs) point diagonal blocks


@dataclasses.dataclass(frozen=True)
class SparseWSchurNewtonSolver:
    """Schur elimination of the point blocks for SparseWSchurJtJ, over
    pytree states {"c": (nc,), "q": (np, bs)} (the TreeSchurNewtonSolver
    state convention).

    The reduced system S = U + lam I - sum_p W_p Vhat_p^{-1} W_p^T is
    assembled as S = U + lam I - sum_p F_p F_p^T with
    F[p, c*cb+i, j] = sum_k onehot(cam_of[p,k], c) * (Wv[p,k] Lv_p^{-T})
    — one one-hot contraction and one batched matmul, no scatter. All
    solve-phase camera reductions/broadcasts are one-hot einsums/gathers.
    Escalating-lambda semantics identical to the other strategies.
    """
    nc: int
    n_points: int
    block_size: int
    k_obs: int
    cam_block: int = 6
    # S-assembly single-pass threshold in F elements (~64 MB f32); above
    # it the reduced system accumulates over point chunks (see
    # factor()). Tests shrink it to force the chunked path.
    s_chunk_limit: int = 1 << 24
    # iterative-refinement passes of the GN solve (see _refine)
    refine_iters: int = 0
    # optional STATIC per-camera gather table from build_cam_gather
    # (requires concrete visibility at construction time); enables a
    # fully compensated camera-row refinement residual — see gauss_newton
    cam_gather: "object" = None

    @property
    def ncam(self) -> int:
        return self.nc // self.cam_block

    def _onehot(self, cam_of, dtype):
        # (np, k_obs, ncam) {0,1} selector; built from iota comparison
        return (cam_of[..., None]
                == jnp.arange(self.ncam, dtype=cam_of.dtype)).astype(dtype)

    def _cam_reduce(self, JtJ, vals):
        return onehot_cam_reduce(JtJ.cam_of, vals, self.ncam,
                                 chunk_limit=self.s_chunk_limit
                                 ).reshape(self.nc)

    def quad_form(self, JtJ: SparseWSchurJtJ, v):
        vc, vp = v["c"], v["q"]
        dt = vc.dtype
        uv = jnp.dot(vc, jnp.matmul(JtJ.U, vc, preferred_element_type=dt))
        # vc^T W vp: gather each block's camera slice of vc
        vcg = vc.reshape(self.ncam, self.cam_block)[JtJ.cam_of]
        wv = jnp.einsum('pki,pkij,pj->', vcg, JtJ.Wv, vp,
                        preferred_element_type=dt)
        vv = jnp.einsum('pb,pbk,pk->', vp, JtJ.V, vp,
                        preferred_element_type=dt)
        return uv + 2.0 * wv + vv

    def factor(self, JtJ: SparseWSchurJtJ, lam):
        """Factorize JtJ + lam*I once at a FIXED lambda (no escalation).

        Returns ((Lv, Ls), ok) — same public contract as
        SchurNewtonSolver.factor (point-block Cholesky factors + reduced
        camera-system factor); see that docstring for the reuse semantics."""
        from libdogleg_tpu.ops import smallchol

        dt = JtJ.U.dtype
        bs = self.block_size
        Vhat = JtJ.V + lam * jnp.eye(bs, dtype=dt)
        Lv, okb = smallchol.small_cholesky(Vhat)        # (np, bs, bs)
        ok_v = jnp.all(okb)
        # B[p,k] = Wv[p,k] Lv_p^{-T}: solve Lv Y = Wv^T per block, with Lv
        # broadcast over the k_obs axis (the unrolled substitution helper
        # broadcasts its batch dims)
        B = jnp.swapaxes(
            smallchol.small_fwd_solve_mat(
                Lv[:, None], jnp.swapaxes(JtJ.Wv, -1, -2)), -1, -2)
        # S = U + lam I - sum_p F_p F_p^T with
        # F[p, c*cb+i, j] = sum_k onehot(cam_of[p,k], c) B[p,k,i,j].
        # F materialized whole would be (np, nc, bs) — the SAME size as the
        # dense W this representation exists to avoid (460 MB at the
        # config-7s scale) — so accumulate S over point chunks instead:
        # each chunk's F is bounded, total FLOPs unchanged.
        S0 = JtJ.U + lam * jnp.eye(self.nc, dtype=dt)
        limit = self.s_chunk_limit
        if self.n_points * self.nc * bs <= limit:
            E = self._onehot(JtJ.cam_of, dt)
            F = jnp.einsum('pkc,pkij->pcij', E, B,
                           preferred_element_type=dt)
            F = F.reshape(self.n_points, self.nc, bs)
            S = S0 - jnp.einsum('pcj,pdj->cd', F, F,
                                preferred_element_type=dt)
        else:
            chunk = max(1, limit // (self.nc * bs))
            nchunks = -(-self.n_points // chunk)
            npad = nchunks * chunk - self.n_points
            Bp = jnp.pad(B, ((0, npad), (0, 0), (0, 0), (0, 0)))
            # padded blocks are zero, so their one-hot target is harmless
            cam_p = jnp.pad(JtJ.cam_of, ((0, npad), (0, 0)))

            def body(S, i):
                Bc = jax.lax.dynamic_slice_in_dim(Bp, i * chunk, chunk)
                cc = jax.lax.dynamic_slice_in_dim(cam_p, i * chunk, chunk)
                Ec = self._onehot(cc, dt)
                Fc = jnp.einsum('pkc,pkij->pcij', Ec, Bc,
                                preferred_element_type=dt)
                Fc = Fc.reshape(chunk, self.nc, bs)
                return S - jnp.einsum('pcj,pdj->cd', Fc, Fc,
                                      preferred_element_type=dt), None

            S, _ = jax.lax.scan(body, S0, jnp.arange(nchunks))
        Ls = jnp.linalg.cholesky(S)
        ok_s = jnp.all(jnp.isfinite(Ls)) & jnp.all(jnp.diag(Ls) > 0)
        return (Lv, Ls), ok_v & ok_s

    def gauss_newton(self, JtJ: SparseWSchurJtJ, Jt_x, lam, *,
                     lambda_initial, lambda_max_tries) -> GNResult:
        from libdogleg_tpu.ops import smallchol

        rc, rp = Jt_x["c"], Jt_x["q"]
        dt = rc.dtype
        (Lv, Ls), lam, ok = chol.escalating_lambda(
            lambda lm: self.factor(JtJ, lm), lam, dt,
            lambda_initial=lambda_initial,
            lambda_max_tries=lambda_max_tries)

        def vsolve(b):                                   # (np, bs)
            return smallchol.small_cho_solve_mat(Lv, b[..., None])[..., 0]

        def solve_pair(bc, bp):
            y = vsolve(bp)
            wy = self._cam_reduce(JtJ, jnp.einsum(
                'pkij,pj->pki', JtJ.Wv, y, preferred_element_type=dt))
            sc = chol.cholesky_solve(Ls, bc - wy)
            scg = sc.reshape(self.ncam, self.cam_block)[JtJ.cam_of]
            sp = vsolve(bp - jnp.einsum('pkij,pki->pj', JtJ.Wv, scg,
                                        preferred_element_type=dt))
            return sc, sp

        dc, dp = solve_pair(rc, rp)
        if self.refine_iters:
            # Point rows compensate fully (small static contractions).
            # Camera rows: the per-camera segmented reduction over
            # observations can only be compensated through a STATIC
            # gather table (build_cam_gather) — the one-hot einsum
            # rounds its accumulation invisibly. With cam_gather set the
            # residual is full double-f32; without it the camera rows
            # fall back to a Precision.HIGHEST f32 residual, which still
            # corrects the reduced-precision multiplies (TF32 on the GPU)
            # of the default-precision solve path.
            cg = self.cam_gather

            def resid(v):
                vc, vp = v
                vcg = vc.reshape(self.ncam, self.cam_block)[JtJ.cam_of]
                if cg is not None:
                    tbl, msk = cg
                    hw, lw = comp.comp_contract(   # (np, k, cb) pairs
                        JtJ.Wv, vp, reduce_axes=(3,),
                        broadcast=lambda x: x[:, None, None, :])
                    cb = hw.shape[-1]
                    H = jnp.where(msk, hw.reshape(-1, cb)[tbl], 0)
                    E = jnp.where(msk, lw.reshape(-1, cb)[tbl], 0)
                    hc, lc = comp.comp_reduce(H, E, axis=1)
                    hc, lc = hc.reshape(-1), lc.reshape(-1)
                    h1, l1 = comp.comp_matvec(JtJ.U, vc)
                    hc, lc = comp.pair_add(hc, lc, h1, l1)
                    hc, lc = comp.pair_add_prod(hc, lc, lam, vc)
                    mc = comp.residual(rc, hc, lc)
                else:
                    mc = rc - (jnp.matmul(JtJ.U, vc, precision=_HI,
                                          preferred_element_type=dt)
                               + lam * vc
                               + self._cam_reduce(JtJ, jnp.einsum(
                                   'pkij,pj->pki', JtJ.Wv, vp,
                                   precision=_HI,
                                   preferred_element_type=dt)))
                h1, l1 = comp.comp_contract(
                    JtJ.Wv, vcg, reduce_axes=(1, 2),
                    broadcast=lambda x: x[..., None])
                h2, l2 = comp.comp_contract(
                    JtJ.V, vp, reduce_axes=(2,),
                    broadcast=lambda x: x[:, None, :])
                hp, lp = comp.pair_add(h1, l1, h2, l2)
                hp, lp = comp.pair_add_prod(hp, lp, lam, vp)
                return mc, comp.residual(rp, hp, lp)

            dc, dp = _refine((dc, dp), lambda r: solve_pair(*r), resid,
                             self.refine_iters)
        step = {"c": -dc, "q": -dp}
        n2 = jnp.dot(dc, dc) + jnp.sum(dp * dp)
        return GNResult(step=step, norm2_step=n2, lam=lam, ok=ok)


def build_cam_gather(cam_of, ncam: int):
    """Static per-camera gather table over the flattened (np*k_obs)
    observation axis, for SparseWSchurNewtonSolver.cam_gather: lets the
    refinement residual's camera reduction run as gather + compensated
    pairwise sum instead of a rounding one-hot einsum. Requires CONCRETE
    visibility (numpy cam_of) at construction time — padded/invalid
    observation slots are fine as long as their Wv blocks are zero (they
    gather exact zeros). Returns (tbl (ncam, width) int32, mask
    (ncam, width, 1) bool) as jnp arrays."""
    cam_of = np.asarray(cam_of).reshape(-1)
    if not np.all((cam_of >= 0) & (cam_of < ncam)):
        # negative Python indexing would silently wrap a padding entry
        # (e.g. -1) onto the last camera; fail loudly instead
        raise ValueError(
            "build_cam_gather: cam_of entries must be in [0, ncam); "
            "pad invalid observation slots with a valid camera id and "
            "zero Wv blocks")
    terms = [[] for _ in range(ncam)]
    for idx, c in enumerate(cam_of):
        terms[int(c)].append(idx)
    width = max(1, max(len(t) for t in terms))
    tbl = np.zeros((ncam, width), np.int32)
    msk = np.zeros((ncam, width), bool)
    for c, t in enumerate(terms):
        tbl[c, :len(t)] = t
        msk[c, :len(t)] = True
    return jnp.asarray(tbl), jnp.asarray(msk[..., None])


def onehot_cam_reduce(cam_of, vals, ncam: int,
                      chunk_limit: int = 1 << 24):
    """Scatter-free segment reduction over the camera axis:
    out[c] = sum over (p, k) with cam_of[p, k] == c of vals[p, k],
    for vals (np, k_obs, ...trailing). Implemented as a one-hot
    einsum (scatter-free), processed in point chunks so the
    (np, k_obs, ncam) selector never materializes whole (410 MB at
    np=200000, ncam=128). Shared by SparseWSchurNewtonSolver and the
    sparse-visibility BA products assembly."""
    dt = vals.dtype
    n_points, k_obs = cam_of.shape
    trailing = vals.shape[2:]
    v2 = vals.reshape(n_points, k_obs, -1)

    def onehot(cc):
        return (cc[..., None]
                == jnp.arange(ncam, dtype=cc.dtype)).astype(dt)

    if n_points * k_obs * ncam <= chunk_limit:
        out = jnp.einsum('pkc,pki->ci', onehot(cam_of), v2,
                         preferred_element_type=dt)
        return out.reshape((ncam,) + trailing)

    chunk = max(1, chunk_limit // (k_obs * ncam))
    nchunks = -(-n_points // chunk)
    npad = nchunks * chunk - n_points
    v_p = jnp.pad(v2, ((0, npad), (0, 0), (0, 0)))
    cam_p = jnp.pad(cam_of, ((0, npad), (0, 0)))

    def body(acc, i):
        vc = jax.lax.dynamic_slice_in_dim(v_p, i * chunk, chunk)
        cc = jax.lax.dynamic_slice_in_dim(cam_p, i * chunk, chunk)
        return acc + jnp.einsum('pkc,pki->ci', onehot(cc), vc,
                                preferred_element_type=dt), None

    acc, _ = jax.lax.scan(body,
                          jnp.zeros((ncam, v2.shape[-1]), dt),
                          jnp.arange(nchunks))
    return acc.reshape((ncam,) + trailing)
