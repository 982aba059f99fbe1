"""Outlierness factors, outlier marking, and query-point confidence.

The reference's experimental analysis suite (reference dogleg.c:1826-3149):
Cook's-D-family leverage factors computed from the factorized JtJ. The full
derivation lives in the reference's long comment (dogleg.c:1924-2291); the
computational core is

    A = J* inv(JtJ) J*^T      (per feature: a featureSize x featureSize block)
    B = inv(A - I)
    factor = k * x*^T (B + B^2) x*        (Cook's self+others, featureSize 2)
    factor = k * x*^2 / (1 - A)           (featureSize 1 path, dogleg.c:2319-2330)

with the normalization scale k chosen so the outlier threshold is 1
(dogleg.c:2281-2289) — including the reference's acknowledged ad-hoc k/8 hack
(dogleg.c:2374-2378), preserved verbatim for behavioral parity.

Differences from the reference: the reference computes pinv(J) rows in chunks of 4
through CHOLMOD (dogleg.c:2427-2431); here all measurements are solved at
once as one batched triangular solve, and the per-feature blocks are a single
batched einsum. featureSize is unrestricted (the reference supports only 1
and 2, dogleg.c:2367-2371; >2 here uses the same Cook's self+others form with
a batched dense inverse).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from libdogleg_tpu.ops.cholesky import cholesky_solve

# The reference marks an outlier only if removing it costs < 5% confidence
# (dogleg.c:3015).
OUTLIER_CONFIDENCE_DROP_THRESHOLD = 0.05


def get_outlierness_scale(norm2_x,
                          nmeasurements: int,
                          nstate: int,
                          n_outlier_features: int = 0,
                          feature_size: int = 1):
    """Normalization scale so the outlierness threshold is 1.0
    (reference getOutliernessScale, dogleg.c:2381-2399):
      scale = Nnon / (4 (Nstate+1) norm2_x / (Nnon - Nstate - 1))
    with Nnon = measurements not already marked as outliers."""
    n_non = nmeasurements - n_outlier_features * feature_size
    return n_non / (4.0 * ((nstate + 1) * norm2_x / (n_non - nstate - 1)))


def pseudoinverse_rows(J: jnp.ndarray, L: jnp.ndarray,
                       solve_fn=None) -> jnp.ndarray:
    """pinv(J) = inv(JtJ) J^T for ALL measurements at once, given the lower
    Cholesky factor L of JtJ (+ lambda). The reference computes this in
    chunks of 4 through CHOLMOD/dpptrs (pseudoinverse_J_dense/sparse,
    dogleg.c:1826-1921); here it is one batched triangular solve.
    solve_fn overrides the dense factor: any rhs->solution map for JtJ
    (e.g. a block-sparse factor via
    `lambda r: sparse_cholesky.solve(sym, Lb, r)` — multi-RHS supported).
    Returns (nstate, nmeas)."""
    if solve_fn is not None:
        return solve_fn(J.T)
    return cholesky_solve(L, J.T)


def _feature_blocks(x: jnp.ndarray, J: jnp.ndarray, L: jnp.ndarray,
                    feature_size: int, solve_fn=None):
    """A_f = J_f inv(JtJ) J_f^T for every consecutive feature group, plus the
    grouped residuals. One batched solve + one batched einsum replaces the
    reference's chunks-of-4 pseudoinverse loop (dogleg.c:2427-2495)."""
    nmeas, nstate = J.shape
    nf = nmeas // feature_size
    W = pseudoinverse_rows(J, L, solve_fn)        # (nstate, nmeas)
    Jr = J.reshape(nf, feature_size, nstate)
    Wr = W.reshape(nstate, nf, feature_size)
    A = jnp.einsum('fim,mfj->fij', Jr, Wr,
                   preferred_element_type=J.dtype)  # (nf, fs, fs)
    xr = x.reshape(nf, feature_size)
    return A, xr


def _cooks_fs2(a00, a01, a11, x0, x1):
    """Cook's self+others closed 2x2 form (reference dogleg.c:2332-2365):
    raw factor (unscaled) and the singular-leverage flag, elementwise over
    any batch shape. Shared by the dense-J and BA-structured paths."""
    det = (1.0 - a00) * (1.0 - a11) - a01 * a01
    b00 = a11 - 1.0
    b11 = a00 - 1.0
    b01 = -a01
    xBx = (x0 * x0 * b00 + 2.0 * x0 * x1 * b01 + x1 * x1 * b11) / det
    v1 = x0 * b00 + x1 * b01
    v2 = x0 * b01 + x1 * b11
    xBBx = (v1 * v1 + v2 * v2) / (det * det)
    return xBx + xBBx, jnp.abs(det) < 1e-8


def get_outlierness_factors(x: jnp.ndarray,
                            J: jnp.ndarray,
                            L: jnp.ndarray,
                            *,
                            feature_size: int = 1,
                            n_outlier_features: int = 0,
                            scale=None,
                            solve_fn=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Outlierness factor per feature (reference dogleg_getOutliernessFactors,
    dogleg.c:2621-2667). Factors > 1.0 are outlier candidates.

    Args:
      x: (nmeas,) residuals at the operating point.
      J: (nmeas, nstate) dense Jacobian (densify BCSR via bcsr_to_dense).
      L: lower Cholesky factor of JtJ (+ permanent lambda), e.g. from
         factorize_jtj(result.JtJ, result.lam).
      feature_size: measurements per feature (any size; reference: 1 or 2).
      n_outlier_features: already-marked outliers, excluded from the scale.
      scale: reuse a previously computed scale if not None (the reference's
        scale<0-means-recompute convention, dogleg.h:337).
      solve_fn: optional JtJ solve to use instead of the dense factor L
        (pass L=None): e.g. the block-sparse/supernodal factor of a large
        problem — `lambda r: sparse_cholesky.solve(sym, L_blocks, r)`.

    Returns (factors (nfeatures,), scale).
    """
    nmeas, nstate = J.shape
    big = jnp.finfo(J.dtype).max  # the reference's DBL_MAX sentinel
    if scale is None:
        scale = get_outlierness_scale(jnp.dot(x, x), nmeas, nstate,
                                      n_outlier_features, feature_size)
    A, xr = _feature_blocks(x, J, L, feature_size, solve_fn)

    if feature_size == 1:
        # x^2 / (1 - A), guarded like the reference (dogleg.c:2319-2330).
        denom = 1.0 - A[:, 0, 0]
        singular = jnp.abs(denom) < 1e-8
        raw = xr[:, 0] * xr[:, 0] / denom
    elif feature_size == 2:
        raw, singular = _cooks_fs2(A[:, 0, 0], A[:, 0, 1], A[:, 1, 1],
                                   xr[:, 0], xr[:, 1])
    else:
        # General featureSize (beyond the reference): same Cook's
        # self+others, batched dense inverse of (A - I), with the same
        # singular-leverage guard generalized to |det(A - I)| < 1e-8.
        eye = jnp.eye(feature_size, dtype=J.dtype)
        AmI = A - eye
        B = jnp.linalg.inv(AmI)
        Bx = jnp.einsum('fij,fj->fi', B, xr)
        singular = jnp.abs(jnp.linalg.det(AmI)) < 1e-8
        raw = jnp.einsum('fi,fi->f', xr, Bx) + jnp.einsum(
            'fi,fi->f', Bx, Bx)

    # The reference's acknowledged hack: "the threshold should be 1.0, and
    # the scaling should make sure that is the case" (dogleg.c:2374-2378).
    # Singular leverage means "definitely an outlier": the DBL_MAX sentinel
    # is returned UNSCALED, exactly as the reference's early returns skip
    # the k multiplication (dogleg.c:2325, 2336).
    k = scale / 8.0
    return jnp.where(singular, big, raw * k), scale


class MarkResult(NamedTuple):
    marked: np.ndarray        # (nfeatures,) bool, updated in place semantics
    n_outliers: int
    marked_any: bool


def mark_outliers(factors,
                  get_confidence: Callable[[int], float],
                  marked: Optional[np.ndarray] = None) -> MarkResult:
    """Accept factor>1 candidates as outliers iff removing them drops the
    user-supplied confidence by less than 5% (reference dogleg_markOutliers,
    dogleg.c:3016-3100). get_confidence(i) returns the solution confidence
    with feature i excluded; get_confidence(-1) is the baseline. This stays
    host-side Python: the callback typically re-solves the problem."""
    factors = np.asarray(factors)
    marked = (np.zeros(factors.shape[0], bool) if marked is None
              else np.asarray(marked).copy())
    confidence0 = float(get_confidence(-1))
    if confidence0 < 0.0:
        return MarkResult(marked, int(marked.sum()), False)

    marked_any = False
    n_outliers = 0
    for i in range(factors.shape[0]):
        if marked[i]:
            n_outliers += 1
            continue
        if factors[i] < 1.0:
            continue
        confidence_excluded = float(get_confidence(i))
        if confidence_excluded < 0.0:
            return MarkResult(marked, n_outliers, marked_any)
        drop = 1.0 - confidence_excluded / confidence0
        if drop < OUTLIER_CONFIDENCE_DROP_THRESHOLD:
            marked[i] = True
            marked_any = True
            n_outliers += 1
    return MarkResult(marked, n_outliers, marked_any)


def report_outliers(factors, get_confidence) -> str:
    """Debug report of every feature's factor and the relative confidence
    drop were it removed (reference dogleg_reportOutliers,
    dogleg.c:3106-3149). Slow by design — calls get_confidence per feature."""
    factors = np.asarray(factors)
    lines = ["## Outlier statistics",
             "# i_feature outlier_factor confidence_drop_relative_if_removed"]
    confidence_full = float(get_confidence(-1))
    for i in range(factors.shape[0]):
        drop = 1.0 - float(get_confidence(i)) / confidence_full
        lines.append(f"{i:5d} {factors[i]:9.3g} {drop:9.3g}")
    return "\n".join(lines) + "\n"


def outlierness_trace_new_feature(Jq: jnp.ndarray,
                                  L: jnp.ndarray,
                                  norm2_x,
                                  nmeasurements: int,
                                  *,
                                  n_outlier_features: int = 0,
                                  solve_fn=None):
    """Expected outlierness of a hypothetical new feature — the query-point
    confidence metric (reference
    dogleg_getOutliernessTrace_newFeature_sparse, dogleg.c:2793-3012).

    Given the would-be feature Jacobian Jq (feature_size, nstate) (zero
    columns where the reference's istateActive/NstateActive window would not
    reach), computes A = Jq inv(JtJ) Jq^T, B = inv(A + I), and returns
    scale * (feature_size - trace(B)) — the reference's Cook's self+others
    form scale*(2 - traceB) (dogleg.c:3005-3006) generalized to any
    feature_size (the reference asserts feature_size == 2, dogleg.c:2873).
    """
    feature_size, nstate = Jq.shape
    W = solve_fn(Jq.T) if solve_fn is not None else \
        cholesky_solve(L, Jq.T)                      # (nstate, fs)
    A = jnp.matmul(Jq, W, preferred_element_type=Jq.dtype)
    B = jnp.linalg.inv(A + jnp.eye(feature_size, dtype=Jq.dtype))
    traceB = jnp.trace(B)
    scale = get_outlierness_scale(norm2_x, nmeasurements, nstate,
                                  n_outlier_features, feature_size)
    return scale * (feature_size - traceB)


def outlierness_trace_new_features_windowed(Jq_win: jnp.ndarray,
                                            istate_active: jnp.ndarray,
                                            L: jnp.ndarray,
                                            norm2_x,
                                            nmeasurements: int,
                                            *,
                                            nstate: int = None,
                                            n_outlier_features: int = 0,
                                            solve_fn=None):
    """Windowed, BATCHED query-point confidence.

    The reference's istateActive/NstateActive window builds an
    O(window)-sized synthetic Jt per query (reference dogleg.c:2794-2842);
    the dense `outlierness_trace_new_feature` above takes a zero-padded
    (fs, nstate) Jq instead — O(nstate) handling per query, which defeats
    the point at large nstate. This form keeps the reference's windowed
    contract AND batches many hypothetical features into one factor solve
    (the mrcal use case: score every candidate observation of a
    calibration object at once):

    Args:
      Jq_win: (nq, fs, w) query Jacobians, each touching only its w
        consecutive states (w static; pad rows with zeros for narrower
        queries).
      istate_active: (nq,) int window starts.
      L: lower Cholesky factor of JtJ (+ permanent lambda), or None when
        solve_fn is given.
      nstate: required when solve_fn is given (otherwise from L).
      solve_fn: optional (nstate, k)-RHS JtJ solve (e.g. the block-sparse
        factor of a large problem) used instead of L.

    Returns (nq,) traces: scale * (fs - trace(inv(A_q + I))) per query,
    identical to the dense form on the zero-padded Jq (tested). Per-query
    work beyond the shared batched solve is O(w * fs), not O(nstate).

    Out-of-range windows (istate_active < 0 or istate_active + w >
    nstate): window columns falling outside [0, nstate) are treated as
    exactly zero — identical to the dense form on a Jq whose
    out-of-range columns are dropped (the scatter drops them and the
    gather masks them; tested). Queries entirely out of range therefore
    return scale * (fs - trace(inv(I))) = 0.
    """
    nq, fs, w = Jq_win.shape
    n = L.shape[-1] if L is not None else nstate
    if n is None:
        raise ValueError("pass nstate when using solve_fn without L")
    dtype = Jq_win.dtype
    offs = jnp.arange(w)

    # scatter all windows into one (nstate, nq*fs) RHS: one batched solve
    # against the cached factorization (the reference re-solves per query,
    # dogleg.c:2864-2868)
    def scatter_one(jq, i0):
        # (fs, w), scalar -> (nstate, fs). mode="drop" discards idx >= n,
        # but JAX wraps NEGATIVE indices numpy-style before the drop, so
        # invalid rows are zeroed and redirected to the (dropped) index n.
        idx = i0 + offs
        valid = (idx >= 0) & (idx < n)
        idx = jnp.where(valid, idx, n)
        rows = jq.T * valid[:, None].astype(dtype)
        rhs = jnp.zeros((n, fs), dtype)
        return rhs.at[idx, :].set(rows, mode="drop")

    rhs = jax.vmap(scatter_one)(Jq_win, istate_active)   # (nq, nstate, fs)
    rhs_flat = jnp.moveaxis(rhs, 0, 1).reshape(n, nq * fs)
    W = solve_fn(rhs_flat) if solve_fn is not None else \
        cholesky_solve(L, rhs_flat)                      # (nstate, nq*fs)
    Wq = jnp.moveaxis(W.reshape(n, nq, fs), 1, 0)        # (nq, nstate, fs)

    # A_q = Jq_win @ W[window rows]: gather only each query's w rows.
    # Rows outside [0, nstate) are masked to zero so they match the
    # scatter's mode="drop" exactly (the raw gather clamps indices, which
    # would silently duplicate edge rows for out-of-range windows).
    def gather_window(wq, i0):
        idx = i0 + offs
        valid = ((idx >= 0) & (idx < n))[:, None].astype(dtype)
        return wq[idx, :] * valid                        # (w, fs)

    Wwin = jax.vmap(gather_window)(Wq, istate_active)    # (nq, w, fs)
    A = jnp.einsum('qfw,qwg->qfg', Jq_win, Wwin,
                   preferred_element_type=dtype)
    B = jnp.linalg.inv(A + jnp.eye(fs, dtype=dtype)[None])
    traceB = jnp.trace(B, axis1=-2, axis2=-1)            # (nq,)
    scale = get_outlierness_scale(norm2_x, nmeasurements, n,
                                  n_outlier_features, fs)
    return scale * (fs - traceB)


def get_outlierness_factors_ba(x_obs: jnp.ndarray,
                               Jc: jnp.ndarray,
                               Jq: jnp.ndarray,
                               JtJ,
                               lam,
                               norm2_x,
                               nmeasurements: int,
                               solver,
                               *,
                               n_outlier_features: int = 0,
                               scale=None,
                               chunk: int = 4096,
                               factorization=None):
    """Observation-level outlierness factors at bundle-adjustment scale.

    The dense-J entry point above needs the full (nmeas, nstate) Jacobian
    and a dense factor — infeasible for large BA. This form computes the
    same featureSize-2 Cook's factors (one feature per observation, the
    reference's camera-calibration usage, dogleg.c:2318-2371) from the
    SPARSE-visibility structure: each observation touches one 6-dof camera
    block and one 3-dof point block, so A_f = J_f inv(JtJ) J_f^T needs
    only the 9x9 covariance sub-block at (camera c, point p), assembled
    from the Schur factors by the standard block-inverse identities

        Sigma_cc = S^{-1}
        Sigma_cq[:, p] = -S^{-1} T_p,      T_p = W_p Vhat_p^{-1}
        Sigma_qq[p]    = Vhat_p^{-1} + T_p^T S^{-1} T_p

    processed in point chunks (nothing nstate-sized materializes beyond
    the nc x nc S^{-1}).

    Args:
      x_obs: (np, k_obs, 2) reprojection residuals at the operating point.
      Jc: (np, k_obs, 2, 6) camera Jacobians; Jq: (np, k_obs, 2, 3) point
        Jacobians (e.g. SparseVisibilityPinholeBA.observation_jacobians).
      JtJ: the SparseWSchurJtJ at the operating point.
      lam: the solve's permanent lambda (SolveResult.lam).
      norm2_x: total norm2 of ALL residuals (incl. priors).
      nmeasurements: total measurement count (incl. prior rows) — the
        reference's Nmeasurements for the scale.
      solver: the SparseWSchurNewtonSolver (supplies the factorization).
      factorization: optional precomputed ((Lv, Ls), ok) from
        solver.factor(JtJ, lam) — pass it to reuse the solve's
        factorization across outlierness passes and confidence queries
        instead of re-factorizing here (the reference reuses its cached
        factorization when still valid, dogleg.c:2636-2652).

    Returns (factors (np, k_obs), scale) — factors > 1 are outlier
    candidates, DBL_MAX marks singular leverage (see
    get_outlierness_factors).
    """
    from libdogleg_tpu.ops import smallchol
    from libdogleg_tpu.ops.cholesky import cholesky_solve

    dt = x_obs.dtype
    n_points, k_obs = JtJ.cam_of.shape
    nc = solver.nc
    cb = solver.cam_block
    big = jnp.finfo(dt).max

    (Lv, Ls), ok = (factorization if factorization is not None
                    else solver.factor(JtJ, jnp.asarray(lam, dt)))
    Sinv = cholesky_solve(Ls, jnp.eye(nc, dtype=dt))        # (nc, nc)
    eye3 = jnp.eye(JtJ.V.shape[-1], dtype=dt)

    nmeas = nmeasurements
    nstate = nc + n_points * JtJ.V.shape[-1]
    if scale is None:
        scale = get_outlierness_scale(norm2_x, nmeas, nstate,
                                      n_outlier_features, 2)
    k = scale / 8.0

    nchunks = -(-n_points // chunk)
    npad = nchunks * chunk - n_points
    pad = lambda a: jnp.pad(a, ((0, npad),) + ((0, 0),) * (a.ndim - 1))
    Wv_p, cam_p = pad(JtJ.Wv), pad(JtJ.cam_of)
    # padded point factors must stay invertible for the chunked solves
    Lv_p = jnp.where(
        (jnp.arange(nchunks * chunk) < n_points)[:, None, None],
        pad(Lv), eye3)
    x_p, Jc_p, Jq_p = pad(x_obs), pad(Jc), pad(Jq)

    def body(_, i):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk)
        Lvc, Wvc, camc = sl(Lv_p), sl(Wv_p), sl(cam_p)
        xc, Jcc, Jqc = sl(x_p), sl(Jc_p), sl(Jq_p)
        Vinv = smallchol.small_cho_solve_mat(Lvc, eye3)      # (ch, 3, 3)
        Tb = jnp.einsum('pkij,pjm->pkim', Wvc, Vinv,
                        preferred_element_type=dt)           # (ch,k,6,3)
        E = (camc[..., None]
             == jnp.arange(solver.ncam, dtype=camc.dtype)).astype(dt)
        T = jnp.einsum('pkc,pkij->pcij', E, Tb,
                       preferred_element_type=dt)
        T = T.reshape(chunk, nc, 3)                          # (ch, nc, 3)
        Z = jnp.einsum('cd,pdj->pcj', Sinv, T,
                       preferred_element_type=dt)            # (ch, nc, 3)
        Sqq = Vinv + jnp.einsum('pci,pcj->pij', T, Z,
                                preferred_element_type=dt)   # (ch, 3, 3)
        # per-(p, k) camera-block gathers
        Zb = Z.reshape(chunk, solver.ncam, cb, 3)
        rows = jnp.arange(chunk)[:, None]
        Scq = -Zb[rows, camc]                                # (ch,k,6,3)
        Sb = Sinv.reshape(solver.ncam, cb, solver.ncam, cb)
        Scc = Sb[camc, :, camc, :]                           # (ch,k,6,6)
        # A_f = Jc Scc Jc^T + Jc Scq Jq^T + (..)^T + Jq Sqq Jq^T
        A = (jnp.einsum('pkai,pkij,pkbj->pkab', Jcc, Scc, Jcc,
                        preferred_element_type=dt)
             + jnp.einsum('pkai,pkij,pkbj->pkab', Jcc, Scq, Jqc,
                          preferred_element_type=dt)
             + jnp.einsum('pkaj,pkij,pkbi->pkab', Jqc, Scq, Jcc,
                          preferred_element_type=dt)
             + jnp.einsum('pkai,pij,pkbj->pkab', Jqc, Sqq, Jqc,
                          preferred_element_type=dt))
        raw, singular = _cooks_fs2(A[..., 0, 0], A[..., 0, 1],
                                   A[..., 1, 1],
                                   xc[..., 0], xc[..., 1])
        return None, jnp.where(singular, big, raw * k)

    _, chunks_out = jax.lax.scan(body, None, jnp.arange(nchunks))
    factors = chunks_out.reshape(nchunks * chunk, k_obs)[:n_points]
    # the reference returns false when the factorization fails
    # (dogleg_getOutliernessFactors); the in-jit analog is NaN factors —
    # unmistakably invalid, and mark_outliers treats them as non-candidates
    factors = jnp.where(ok, factors, jnp.nan)
    return factors, scale
