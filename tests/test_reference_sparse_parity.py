"""Trace parity against the reference's REAL sparse code paths.

Round 1 diffed our sparse mode against the reference's *dense* trace because
the oracle linked a types-only CHOLMOD stub that aborted on any sparse call.
The oracle now links minichol (tests/reference_oracle/minichol.{h,c}) — a
functional implementation of the CHOLMOD API subset dogleg.c uses — so the
reference's primary entry point `dogleg_optimize2` (dogleg.c:1755-1764), its
sparse factorization/solve (dogleg.c:649-677, 842-865), the sparse
outlierness machinery (dogleg.c:2793-3012) and the sparse gradient checker
(dogleg.c:349-522) all EXECUTE here, driven through ctypes sparse callbacks
on random block-structured problems, and are diffed decision-by-decision
against our sparse path (SparseProblem, jtj="sparse": block-CSR products +
level-scheduled sparse Cholesky).

Real SuiteSparse is unobtainable in this environment (no network, no system
package — see PARITY.md); minichol computes the same JtJ + lambda I Cholesky
in double precision with natural ordering, so it differs from real CHOLMOD
only in summation order (ulp-level), which is irrelevant at the decision
level asserted here.
"""

import ctypes
import os
import tempfile

import numpy as np
import pytest

from tests.test_reference_parity import assert_traces_match
from tests.test_reference_random_parity import (DOGLEG_DEBUG_VNLOG,
                                                DoglegParameters2,
                                                _SolverContext, libref)

assert libref is not None  # re-exported pytest fixture (module-scoped build)


class CholmodSparse(ctypes.Structure):
    """ctypes mirror of minichol.h's cholmod_sparse (the oracle .so was
    built against it, so the embedded layout is minichol's)."""
    _fields_ = [("nrow", ctypes.c_size_t), ("ncol", ctypes.c_size_t),
                ("nzmax", ctypes.c_size_t),
                ("p", ctypes.c_void_p), ("i", ctypes.c_void_p),
                ("nz", ctypes.c_void_p), ("x", ctypes.c_void_p),
                ("z", ctypes.c_void_p),
                ("stype", ctypes.c_int), ("itype", ctypes.c_int),
                ("xtype", ctypes.c_int), ("dtype", ctypes.c_int),
                ("sorted", ctypes.c_int), ("packed", ctypes.c_int)]


SPARSE_CB = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_double),
                             ctypes.POINTER(ctypes.c_double),
                             ctypes.POINTER(CholmodSparse), ctypes.c_void_p)


def banded_problem(seed, nstate, nmeas, k):
    """Random banded nonlinear least squares with a FIXED sparsity pattern
    (the reference assumes the pattern of zeros is constant,
    dogleg.c:649-654): measurement i touches a contiguous window of k states
    starting at floor(i * (nstate-k) / (nmeas-1)), with
    r_i = sum_j a_ij tanh(w_ij p_j) + c_ij p_j  - d_i on the window."""
    rng = np.random.default_rng(seed)
    starts = np.floor(np.arange(nmeas) * (nstate - k)
                      / max(nmeas - 1, 1)).astype(np.int64)
    cols = starts[:, None] + np.arange(k)[None, :]        # (nmeas, k) sorted
    a = rng.normal(size=(nmeas, k))
    w = rng.normal(size=(nmeas, k)) * 0.5
    c = rng.normal(size=(nmeas, k)) * 0.3
    p_true = rng.normal(size=nstate)
    pw = p_true[cols]
    d = (a * np.tanh(w * pw) + c * pw).sum(1) + rng.normal(size=nmeas) * 0.05
    p0 = rng.normal(size=nstate)

    def residuals(p):
        pwin = p[cols]
        return (a * np.tanh(w * pwin) + c * pwin).sum(1) - d

    def jac_values(p):
        """nnz values in CSR order: row-major, columns ascending."""
        pwin = p[cols]
        t = np.tanh(w * pwin)
        return (a * w * (1.0 - t * t) + c)                # (nmeas, k)

    return cols, residuals, jac_values, p0


def run_reference_sparse(lib, cols, residuals, jac_values, p0, nmeas,
                         parameters=None, return_context=False):
    """Solve with dogleg_optimize2 through a ctypes sparse callback,
    capturing the vnlog stream. cols is the fixed (nmeas, k) support;
    the callback fills Jt's CSC arrays (Jt column j = measurement j,
    reference dogleg.h:11-20, sample.c:89-125)."""
    nstate = p0.shape[0]
    k = cols.shape[1]
    njnnz = nmeas * k
    csc_p = np.arange(nmeas + 1, dtype=np.int32) * k
    csc_i = cols.astype(np.int32).reshape(-1)

    @SPARSE_CB
    def cb(p_ptr, x_ptr, Jt_ptr, cookie):
        p = np.ctypeslib.as_array(p_ptr, (nstate,)).copy()
        np.ctypeslib.as_array(x_ptr, (nmeas,))[:] = residuals(p)
        Jt = Jt_ptr.contents
        np.ctypeslib.as_array(
            ctypes.cast(Jt.p, ctypes.POINTER(ctypes.c_int32)),
            (nmeas + 1,))[:] = csc_p
        np.ctypeslib.as_array(
            ctypes.cast(Jt.i, ctypes.POINTER(ctypes.c_int32)),
            (njnnz,))[:] = csc_i
        np.ctypeslib.as_array(
            ctypes.cast(Jt.x, ctypes.POINTER(ctypes.c_double)),
            (njnnz,))[:] = jac_values(p).reshape(-1)

    lib.dogleg_optimize2.restype = ctypes.c_double
    lib.dogleg_optimize2.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_uint, ctypes.c_uint,
        ctypes.c_uint, SPARSE_CB, ctypes.c_void_p,
        ctypes.POINTER(DoglegParameters2),
        ctypes.POINTER(ctypes.POINTER(_SolverContext))]

    prm = parameters or DoglegParameters2()
    if parameters is None:
        lib.dogleg_getDefaultParameters(ctypes.byref(prm))
    prm.dogleg_debug = DOGLEG_DEBUG_VNLOG

    p = np.ascontiguousarray(p0, np.float64).copy()
    ctx = ctypes.POINTER(_SolverContext)()
    ctx_arg = ctypes.byref(ctx) if return_context else None
    with tempfile.TemporaryFile() as tmp:
        saved = os.dup(1)
        os.dup2(tmp.fileno(), 1)
        try:
            norm2x = lib.dogleg_optimize2(
                p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                nstate, nmeas, njnnz, cb, None, ctypes.byref(prm), ctx_arg)
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        tmp.seek(0)
        text = tmp.read().decode()
    rows = [l.split() for l in text.splitlines()
            if l.strip() and not l.startswith("#")]
    if return_context:
        return rows, p, float(norm2x), ctx
    return rows, p, float(norm2x)


def make_our_sparse_problem(cols, nstate, nmeas, a, w, c, d, jtj="sparse"):
    import jax.numpy as jnp

    from libdogleg_tpu import SparseProblem
    from libdogleg_tpu.sparsity import bcsr_from_scalar_csr

    k = cols.shape[1]
    rowptr = np.arange(nmeas + 1, dtype=np.int32) * k
    structure = bcsr_from_scalar_csr(rowptr, cols.reshape(-1), nmeas, nstate)
    aj, wj, cj, dj = map(jnp.asarray, (a, w, c, d))
    colsj = jnp.asarray(cols)

    def f(p):
        pwin = p[colsj]
        t = jnp.tanh(wj * pwin)
        x = (aj * t + cj * pwin).sum(1) - dj
        values = (aj * wj * (1.0 - t * t) + cj).reshape(-1, 1, 1)
        return x, values

    return SparseProblem(f=f, structure=structure, jtj=jtj)


def run_ours_sparse(cols, nstate, nmeas, seed, jtj):
    """Rebuild the same instance data and solve with our sparse path."""
    import jax
    import jax.numpy as jnp

    from libdogleg_tpu import DoglegParameters, optimize
    from libdogleg_tpu.diagnostics import format_vnlog

    rng = np.random.default_rng(seed)
    k = cols.shape[1]
    a = rng.normal(size=(nmeas, k))
    w = rng.normal(size=(nmeas, k)) * 0.5
    c = rng.normal(size=(nmeas, k)) * 0.3
    p_true = rng.normal(size=nstate)
    pw = p_true[cols]
    d = (a * np.tanh(w * pw) + c * pw).sum(1) + rng.normal(size=nmeas) * 0.05
    p0 = rng.normal(size=nstate)

    problem = make_our_sparse_problem(cols, nstate, nmeas, a, w, c, d, jtj)
    r = jax.jit(lambda q: optimize(problem, q, DoglegParameters(),
                                   record_history=True))(jnp.asarray(p0))
    text = format_vnlog(r.history, r.n_attempts)
    rows = [l.split() for l in text.splitlines()[1:] if l.strip()]
    return rows, r


@pytest.mark.parametrize("seed,nstate,nmeas,k,jtj", [
    (20, 12, 60, 3, "sparse"),
    (21, 24, 96, 4, "sparse"),
    (22, 16, 64, 5, "dense"),    # sparse Jacobian, dense JtJ representation
    (23, 32, 128, 4, "sparse"),
])
def test_sparse_trace_parity(libref, seed, nstate, nmeas, k, jtj):
    """dogleg_optimize2's vnlog trace (real sparse path: CHOLMOD-API
    factorize/solve through minichol) matches our SparseProblem trace
    attempt by attempt."""
    cols, residuals, jac_values, p0 = banded_problem(seed, nstate, nmeas, k)
    ref_rows, p_ref, norm2_ref = run_reference_sparse(
        libref, cols, residuals, jac_values, p0, nmeas)
    our_rows, result = run_ours_sparse(cols, nstate, nmeas, seed, jtj)
    assert_traces_match(ref_rows, our_rows, rel=1e-4)
    assert norm2_ref >= 0
    np.testing.assert_allclose(np.asarray(result.p), p_ref,
                               rtol=1e-5, atol=1e-7)


def test_sparse_outlierness_trace_parity(libref):
    """dogleg_getOutliernessTrace_newFeature_sparse (dogleg.c:2793-3012),
    running its real sparse solve through cholmod_spsolve, matches
    outlierness_trace_new_feature for windowed featureSize-2 queries."""
    import jax.numpy as jnp

    from libdogleg_tpu.analysis import outlierness_trace_new_feature
    from libdogleg_tpu.ops.cholesky import factorize_jtj

    seed, nstate, nmeas, k = 24, 16, 80, 4
    cols, residuals, jac_values, p0 = banded_problem(seed, nstate, nmeas, k)
    _, p_ref, _, ctx = run_reference_sparse(
        libref, cols, residuals, jac_values, p0, nmeas, return_context=True)
    assert bool(ctx)

    lib = libref
    lib.dogleg_getOutliernessTrace_newFeature_sparse.restype = \
        ctypes.c_double
    lib.dogleg_getOutliernessTrace_newFeature_sparse.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(_SolverContext)]

    # our factor at the reference's converged state (same lambda)
    lam = float(ctx.contents.lam)
    J = np.zeros((nmeas, nstate))
    np.put_along_axis(J, cols, jac_values(p_ref), axis=1)
    x = residuals(p_ref)
    fac = factorize_jtj(jnp.asarray(J.T @ J), jnp.asarray(lam))

    feature_size = 2
    rng = np.random.default_rng(99)
    ref_vals, wins = [], []
    for istate_active, nstate_active in [(0, 3), (5, 4), (12, 4), (7, 2)]:
        # reference layout: column-major (NstateActive, featureSize),
        # dogleg.c:2836-2850
        Jq_win = rng.normal(size=(nstate_active, feature_size))
        ref_val = lib.dogleg_getOutliernessTrace_newFeature_sparse(
            np.ascontiguousarray(Jq_win.T.reshape(-1)).ctypes.data_as(
                ctypes.POINTER(ctypes.c_double)),
            istate_active, nstate_active, feature_size, 0,
            ctx.contents.beforeStep, ctx)

        Jq = np.zeros((feature_size, nstate))
        Jq[:, istate_active:istate_active + nstate_active] = Jq_win.T
        ours = outlierness_trace_new_feature(
            jnp.asarray(Jq), fac.L, jnp.asarray(float(x @ x)), nmeas)
        np.testing.assert_allclose(float(ours), ref_val,
                                   rtol=1e-8, atol=1e-12)
        ref_vals.append(ref_val)
        wins.append((istate_active, nstate_active, Jq_win))

    # and the windowed BATCHED form against the same reference values:
    # one solve for all queries, O(window) handling each
    from libdogleg_tpu.analysis import (
        outlierness_trace_new_features_windowed)
    wmax = max(na for _, na, _ in wins)
    Jq_b = np.zeros((len(wins), feature_size, wmax))
    starts = np.zeros(len(wins), np.int32)
    for q, (i0, na, Jq_win) in enumerate(wins):
        Jq_b[q, :, :na] = Jq_win.T
        starts[q] = i0
    batched = outlierness_trace_new_features_windowed(
        jnp.asarray(Jq_b), jnp.asarray(starts), fac.L,
        jnp.asarray(float(x @ x)), nmeas)
    np.testing.assert_allclose(np.asarray(batched), np.asarray(ref_vals),
                               rtol=1e-8, atol=1e-12)

    lib.dogleg_freeContext.restype = None
    lib.dogleg_freeContext.argtypes = [
        ctypes.POINTER(ctypes.POINTER(_SolverContext))]
    lib.dogleg_freeContext(ctypes.byref(ctx))


def test_sparse_outlierness_factors_parity(libref):
    """The SPARSE outlierness-factor driver (dogleg.c:2534-2619 — the one
    WITHOUT the dense driver's featureSize-2 indexing bug) matches
    get_outlierness_factors exactly."""
    import jax.numpy as jnp

    from libdogleg_tpu.analysis import get_outlierness_factors
    from libdogleg_tpu.ops.cholesky import factorize_jtj

    seed, nstate, nmeas, k = 25, 14, 56, 4
    cols, residuals, jac_values, p0 = banded_problem(seed, nstate, nmeas, k)
    _, p_ref, _, ctx = run_reference_sparse(
        libref, cols, residuals, jac_values, p0, nmeas, return_context=True)
    assert bool(ctx)

    lib = libref
    lib.dogleg_getOutliernessFactors.restype = ctypes.c_bool
    lib.dogleg_getOutliernessFactors.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(_SolverContext)]

    lam = float(ctx.contents.lam)
    for feature_size in (1, 2):
        nfeat = nmeas // feature_size
        factors_ref = np.zeros(nfeat)
        scale = ctypes.c_double(-1.0)
        ok = lib.dogleg_getOutliernessFactors(
            factors_ref.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.byref(scale), feature_size, nfeat, 0,
            ctx.contents.beforeStep, ctx)
        assert ok

        J = np.zeros((nmeas, nstate))
        np.put_along_axis(J, cols, jac_values(p_ref), axis=1)
        x = residuals(p_ref)
        fac = factorize_jtj(jnp.asarray(J.T @ J), jnp.asarray(lam))
        factors, _ = get_outlierness_factors(
            jnp.asarray(x), jnp.asarray(J), fac.L,
            feature_size=feature_size)
        np.testing.assert_allclose(np.asarray(factors), factors_ref,
                                   rtol=1e-8, atol=1e-12)

    lib.dogleg_freeContext.restype = None
    lib.dogleg_freeContext.argtypes = [
        ctypes.POINTER(ctypes.POINTER(_SolverContext))]
    lib.dogleg_freeContext(ctypes.byref(ctx))


def test_sparse_gradient_checker_parity(libref):
    """dogleg_testGradient (the SPARSE checker: reported gradients looked up
    in the callback's CSC pattern, zero outside it — dogleg.c:353-367)
    produces the same table as check_gradients on our SparseProblem."""
    import jax.numpy as jnp

    from libdogleg_tpu.analysis import check_gradients, format_gradient_table

    seed, nstate, nmeas, k = 26, 10, 40, 3
    cols, residuals, jac_values, p0 = banded_problem(seed, nstate, nmeas, k)
    njnnz = nmeas * k
    csc_p = np.arange(nmeas + 1, dtype=np.int32) * k
    csc_i = cols.astype(np.int32).reshape(-1)

    @SPARSE_CB
    def cb(p_ptr, x_ptr, Jt_ptr, cookie):
        p = np.ctypeslib.as_array(p_ptr, (nstate,)).copy()
        np.ctypeslib.as_array(x_ptr, (nmeas,))[:] = residuals(p)
        Jt = Jt_ptr.contents
        np.ctypeslib.as_array(
            ctypes.cast(Jt.p, ctypes.POINTER(ctypes.c_int32)),
            (nmeas + 1,))[:] = csc_p
        np.ctypeslib.as_array(
            ctypes.cast(Jt.i, ctypes.POINTER(ctypes.c_int32)),
            (njnnz,))[:] = csc_i
        np.ctypeslib.as_array(
            ctypes.cast(Jt.x, ctypes.POINTER(ctypes.c_double)),
            (njnnz,))[:] = jac_values(p).reshape(-1)

    lib = libref
    lib.dogleg_testGradient.restype = None
    lib.dogleg_testGradient.argtypes = [
        ctypes.c_uint, ctypes.POINTER(ctypes.c_double), ctypes.c_uint,
        ctypes.c_uint, ctypes.c_uint, SPARSE_CB, ctypes.c_void_p]

    # same instance data on our side
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(nmeas, k))
    w = rng.normal(size=(nmeas, k)) * 0.5
    c = rng.normal(size=(nmeas, k)) * 0.3
    p_true = rng.normal(size=nstate)
    pw = p_true[cols]
    d = (a * np.tanh(w * pw) + c * pw).sum(1) + rng.normal(size=nmeas) * 0.05
    problem = make_our_sparse_problem(cols, nstate, nmeas, a, w, c, d,
                                      jtj="dense")

    p = np.ascontiguousarray(p0, np.float64)
    for var in (0, nstate // 2, nstate - 1):
        with tempfile.TemporaryFile() as tmp:
            saved = os.dup(1)
            os.dup2(tmp.fileno(), 1)
            try:
                lib.dogleg_testGradient(
                    var, p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    nstate, nmeas, njnnz, cb, None)
            finally:
                os.dup2(saved, 1)
                os.close(saved)
            tmp.seek(0)
            ref_rows = [l.split() for l in tmp.read().decode().splitlines()
                        if l.strip() and not l.startswith("#")]
        chk = check_gradients(problem, jnp.asarray(p0), var)
        our_rows = [l.split()
                    for l in format_gradient_table(chk).splitlines()[1:]
                    if l.strip()]
        assert len(ref_rows) == len(our_rows) == nmeas
        for rr, orow in zip(ref_rows, our_rows):
            assert rr[0] == orow[0] and rr[1] == orow[1]
            rep = float(rr[2])
            for j, (va, vb) in enumerate(zip(rr[2:], orow[2:])):
                if j < 2:
                    assert float(va) == pytest.approx(float(vb), rel=1e-6,
                                                      abs=1e-12), (rr, orow)
                else:
                    tol = 1e-6 * max(abs(rep), 1e-3)
                    assert abs(float(va) - float(vb)) < tol, (rr, orow)


def test_ba_schur_trace_parity(libref):
    """The Schur-elimination strategies take the SAME decisions as the
    reference solving the identical bundle-adjustment problem through its
    whole-JtJ sparse path (dogleg_optimize2 + minichol): different linear
    algebra (point-block elimination + reduced camera system vs one
    factorization of the full JtJ), same Gauss-Newton mathematics, so the
    vnlog traces must match attempt by attempt."""
    import jax
    import jax.numpy as jnp

    from libdogleg_tpu import DoglegParameters
    from libdogleg_tpu.diagnostics import format_vnlog
    from libdogleg_tpu.models import pinhole_ba
    from libdogleg_tpu.solver import solve_products

    ba = pinhole_ba.make_synthetic_sparse(seed=5, ncam=3, npts=14, k_obs=2,
                                          pixel_noise=0.3)
    nc = ba.ncam * 6
    nstate = ba.nstate
    # measurement layout: 2 rows per (point, k) pair, then the 6 cam0-prior
    # rows, then 3*npts point-prior rows (order is irrelevant to the
    # products, which are sums over measurements)
    nmeas_proj = ba.npts * ba.k_obs * 2
    nmeas = nmeas_proj + 6 + 3 * ba.npts
    njnnz = nmeas_proj * 9 + 6 + 3 * ba.npts
    sw0 = np.sqrt(ba.w_prior_cam0)
    swp = np.sqrt(ba.w_prior_pts)
    cam_of = np.asarray(ba.cam_of)
    obs = np.asarray(ba.obs)
    cam0_prior = np.asarray(ba.cam0_prior)
    pts_prior = np.asarray(ba.pts_prior)

    # per-pair residual + Jacobians via jax (f64 CPU), called per callback
    def pair_jac(cam, point, ob):
        r = pinhole_ba.project(jnp.asarray(cam), jnp.asarray(point),
                               ba.focal) - jnp.asarray(ob)
        Jc = jax.jacfwd(lambda c: pinhole_ba.project(
            c, jnp.asarray(point), ba.focal))(jnp.asarray(cam))
        Jq = jax.jacfwd(lambda s: pinhole_ba.project(
            jnp.asarray(cam), s, ba.focal))(jnp.asarray(point))
        return np.asarray(r), np.asarray(Jc), np.asarray(Jq)

    def fill(p):
        cams = p[:nc].reshape(ba.ncam, 6)
        q = p[nc:].reshape(ba.npts, 3)
        x = np.zeros(nmeas)
        csc_p = np.zeros(nmeas + 1, np.int32)
        csc_i = np.zeros(njnnz, np.int32)
        csc_x = np.zeros(njnnz)
        col = 0
        nz = 0
        for pi in range(ba.npts):
            for kk in range(ba.k_obs):
                ci = int(cam_of[pi, kk])
                r, Jc, Jq = pair_jac(cams[ci], q[pi], obs[pi, kk])
                for row in range(2):
                    x[col] = r[row]
                    idx = np.concatenate([ci * 6 + np.arange(6),
                                          nc + 3 * pi + np.arange(3)])
                    val = np.concatenate([Jc[row], Jq[row]])
                    csc_i[nz:nz + 9] = idx
                    csc_x[nz:nz + 9] = val
                    nz += 9
                    col += 1
                    csc_p[col] = nz
        for i in range(6):
            x[col] = sw0 * (p[i] - cam0_prior[i])
            csc_i[nz] = i
            csc_x[nz] = sw0
            nz += 1
            col += 1
            csc_p[col] = nz
        for pi in range(ba.npts):
            for j in range(3):
                x[col] = swp * (q[pi, j] - pts_prior[pi, j])
                csc_i[nz] = nc + 3 * pi + j
                csc_x[nz] = swp
                nz += 1
                col += 1
                csc_p[col] = nz
        assert nz == njnnz and col == nmeas
        return x, csc_p, csc_i, csc_x

    @SPARSE_CB
    def cb(p_ptr, x_ptr, Jt_ptr, cookie):
        p = np.ctypeslib.as_array(p_ptr, (nstate,)).copy()
        x, csc_p, csc_i, csc_x = fill(p)
        np.ctypeslib.as_array(x_ptr, (nmeas,))[:] = x
        Jt = Jt_ptr.contents
        np.ctypeslib.as_array(
            ctypes.cast(Jt.p, ctypes.POINTER(ctypes.c_int32)),
            (nmeas + 1,))[:] = csc_p
        np.ctypeslib.as_array(
            ctypes.cast(Jt.i, ctypes.POINTER(ctypes.c_int32)),
            (njnnz,))[:] = csc_i
        np.ctypeslib.as_array(
            ctypes.cast(Jt.x, ctypes.POINTER(ctypes.c_double)),
            (njnnz,))[:] = csc_x

    lib = libref
    lib.dogleg_optimize2.restype = ctypes.c_double
    lib.dogleg_optimize2.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_uint, ctypes.c_uint,
        ctypes.c_uint, SPARSE_CB, ctypes.c_void_p,
        ctypes.POINTER(DoglegParameters2), ctypes.c_void_p]
    prm = DoglegParameters2()
    lib.dogleg_getDefaultParameters(ctypes.byref(prm))
    prm.dogleg_debug = DOGLEG_DEBUG_VNLOG

    p0_tree = ba.p0(jax.random.PRNGKey(7), jitter=0.05)
    p0 = np.concatenate([np.asarray(p0_tree["c"]),
                         np.asarray(p0_tree["q"]).reshape(-1)])
    p = np.ascontiguousarray(p0, np.float64).copy()
    with tempfile.TemporaryFile() as tmp:
        saved = os.dup(1)
        os.dup2(tmp.fileno(), 1)
        try:
            norm2_ref = lib.dogleg_optimize2(
                p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                nstate, nmeas, njnnz, cb, None, ctypes.byref(prm), None)
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        tmp.seek(0)
        ref_rows = [l.split() for l in tmp.read().decode().splitlines()
                    if l.strip() and not l.startswith("#")]

    r = jax.jit(lambda pc, pq: solve_products(
        ba.products, {"c": pc, "q": pq}, DoglegParameters(),
        newton_solver=ba.newton_solver(), record_history=True))(
        p0_tree["c"], p0_tree["q"])
    our_rows = [l.split()
                for l in format_vnlog(r.history, r.n_attempts).splitlines()[1:]
                if l.strip()]
    assert_traces_match(ref_rows, our_rows, rel=1e-4)
    assert norm2_ref >= 0
    p_ours = np.concatenate([np.asarray(r.p["c"]),
                             np.asarray(r.p["q"]).reshape(-1)])
    np.testing.assert_allclose(p_ours, p, rtol=1e-5, atol=1e-7)
