"""Whole-solve Pallas megakernel for batched small-N dense problems.

One `pallas_call` runs the ENTIRE dog-leg solve for a tile of problems:
products, Cauchy/GN/dog-leg step selection, trust-region update, lambda
escalation and termination. The solver state stays in registers across
all attempts, so device memory sees one read of the problem data and one
write of the results per SOLVE. The XLA path (`batched_optimize` with
the vmapped `while_loop`) instead launches a chain of kernels per
attempt and copies each loop predicate back to the host.

The kernel is compiled through Pallas's Triton route. Triton needs every
tensor to have a power-of-two size and has no rule for value slicing, so
the kernel is written in LANE FORM: one problem per lane, every value a
`(bt,)` vector with `bt` (the tile width) a power of two. Vectors and
matrices of the state are Python lists of lanes (`p[i]`, `L[i][j]`), all
linear algebra is unrolled over the static state size n <= 16, and
per-problem data rows are read by static or scalar index from the refs.

Semantics mirror solver.py attempt-for-attempt (reference
dogleg.c:1172-1476 placements: criterion 1 on accepted/initial points,
criterion 2 before evaluating the trial, criterion 3 after a reject,
permanent escalating lambda per dogleg.c:670-676). Differences, by
design:
  * no lazy-GN caching: the factorization is recomputed every attempt
    that needs a GN step; the RESULT is identical because JtJ and the
    carried lambda are unchanged on rejects;
  * wavefront granularity is the lane tile (one grid program), so a tile
    only waits for its own slowest member, not the global batch's;
  * record_history is not supported (use batched_optimize for the vnlog
    stream).

Products in lane form: ``products(p, *data, *shared) -> (norm2, Jt_x,
JtJ)`` where ``p`` is a list of n lane vectors, each ``data[k]`` is
indexable by a row number (a kernel ref or a ``(rows, bt)`` array:
``data[k][r]`` is a lane vector), each ``shared[k]`` is an array common
to every problem (``shared[k][r, j]`` is a scalar), ``norm2`` is a lane
vector, ``Jt_x`` a list of n lane vectors and ``JtJ`` a nested list whose
entries ``JtJ[i][j]`` with ``j <= i`` are read (the lower triangle).
Other constants are Python or numpy scalars closed over by the function:
a kernel captures no array constant.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from libdogleg_tpu.params import DoglegParameters
from libdogleg_tpu.solver import SolveResult, StopReason

# Lane-tile width and warps per program, chosen on an H100 (PERF.md: every
# tile swept was within run-to-run noise).
DEFAULT_BLOCK_BATCH = 64
NUM_WARPS = 2


# ---------------------------------------------------------------------------
# lane-form small linear algebra (every value a (bt,) vector)
# ---------------------------------------------------------------------------


def lane_sum(terms):
    """Pairwise sum of a list of lanes (shorter dependency chains than a
    running sum, and the rounding of a tree)."""
    terms = list(terms)
    while len(terms) > 1:
        terms = [terms[i] + terms[i + 1] if i + 1 < len(terms) else terms[i]
                 for i in range(0, len(terms), 2)]
    return terms[0]


def _chol_lanes(A, n, tiny):
    """Unrolled Cholesky of the lower triangle A[i][j] (j <= i).

    Returns (L lower, ok bool lane). A failed lane gets a clamped pivot so
    downstream arithmetic stays finite; its ok is False."""
    L = [[None] * n for _ in range(n)]
    ok = None
    for j in range(n):
        d2 = A[j][j]
        for k in range(j):
            d2 = d2 - L[j][k] * L[j][k]
        good = (d2 > 0) & jnp.isfinite(d2)
        ok = good if ok is None else ok & good
        d = jnp.sqrt(jnp.maximum(d2, tiny))
        L[j][j] = d
        for i in range(j + 1, n):
            acc = A[i][j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = acc / d
    return L, ok


def _cho_solve_lanes(L, b, n):
    """Solve L L^T x = b by forward then backward substitution."""
    y = [None] * n
    for i in range(n):
        acc = b[i]
        for k in range(i):
            acc = acc - L[i][k] * y[k]
        y[i] = acc / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - L[k][i] * x[k]
        x[i] = acc / L[i][i]
    return x


def _quad_form_lanes(A, v, n):
    """v^T A v for symmetric A given by its lower triangle."""
    diag = lane_sum(A[i][i] * v[i] * v[i] for i in range(n))
    off = [A[i][j] * v[i] * v[j] for i in range(n) for j in range(i)]
    return diag + 2.0 * lane_sum(off) if off else diag


def _dot_lanes(u, v):
    return lane_sum(a * b for a, b in zip(u, v))


def _max_abs_lanes(v):
    m = jnp.abs(v[0])
    for x in v[1:]:
        m = jnp.maximum(m, jnp.abs(x))
    return m


def _gauss_newton_lanes(jtj, g, lam, need, n, *, lambda_initial,
                        lambda_max_tries):
    """Masked escalating-lambda GN solve (reference dogleg.c:670-676).

    Only lanes with `need` escalate their lambda; others keep lam and
    report ok. Returns (step list, norm2, lam, fac_ok)."""
    dt = lam.dtype
    tiny = np.asarray(np.finfo(np.float32).tiny, dt)

    def factor(lam_v):
        A = [[jtj[i][j] + lam_v if i == j else jtj[i][j]
              for j in range(i + 1)] for i in range(n)]
        L, ok = _chol_lanes(A, n, tiny)
        return [L[i][j] for i in range(n) for j in range(i + 1)], ok

    def unflat(flat):
        it = iter(flat)
        return [[next(it) for _ in range(i + 1)] for i in range(n)]

    Lf, ok = factor(lam)

    def unresolved(ok_c):
        return jnp.max((need & ~ok_c).astype(jnp.int32)) > 0

    def cond(c):
        _, _, ok_c, tries = c
        return (tries < lambda_max_tries) & unresolved(ok_c)

    def body(c):
        _, lam_c, ok_c, tries = c
        esc = jnp.where(lam_c == 0.0, np.asarray(lambda_initial, dt),
                        lam_c * 10.0)
        lam_n = jnp.where(need & ~ok_c, esc, lam_c)
        Lf_n, ok_n = factor(lam_n)
        return Lf_n, lam_n, ok_n, tries + 1

    Lf, lam, ok, _ = jax.lax.while_loop(
        cond, body, (Lf, lam, ok, jnp.asarray(0, jnp.int32)))
    x = _cho_solve_lanes(unflat(Lf), g, n)
    step = [-xi for xi in x]
    return step, _dot_lanes(step, step), lam, ok | ~need


# ---------------------------------------------------------------------------
# the megakernel
# ---------------------------------------------------------------------------


def _make_kernel(products: Callable, n: int, n_in: int,
                 prm: DoglegParameters):
    """Build the kernel body over refs (data..., shared..., p0, p, Jt_x,
    JtJ, fscal, iscal); n_in counts the data and shared refs."""
    max_attempts = prm.resolved_max_attempts()
    R = StopReason

    def kernel(*refs):
        data_refs = refs[:n_in]
        p0_ref, p_ref, jtx_ref, jtj_ref, fscal_ref, iscal_ref = \
            refs[n_in:]
        dt = p0_ref.dtype

        def f(v):
            return np.asarray(v, dt)

        def eval_products(p):
            n2, jtx, jtj = products(list(p), *data_refs)
            return (n2, list(jtx),
                    [jtj[i][j] for i in range(n) for j in range(i + 1)])

        def unflat(flat):
            it = iter(flat)
            return [[next(it) for _ in range(i + 1)] for i in range(n)]

        def grad_converged(g):
            return _max_abs_lanes(g) <= f(prm.Jt_x_threshold)

        p0 = [p0_ref[i] for i in range(n)]
        norm2_0, jtx_0, jtj_0 = eval_products(p0)
        zero = jnp.zeros_like(p0[0])
        izero = jnp.zeros(zero.shape, jnp.int32)
        false = zero != zero
        conv0 = grad_converged(jtx_0)
        reason0 = jnp.where(conv0, int(R.GRADIENT_CONVERGED),
                            int(R.RUNNING)).astype(jnp.int32)

        # carry: p, norm2, Jt_x, JtJ (lower), cauchy, n2_cauchy,
        # have_cauchy, gn, n2_gn, have_gn, lam, tr, step_count,
        # n_attempts, done, reason
        carry0 = (p0, norm2_0, jtx_0, jtj_0,
                  [zero] * n, zero, false,
                  [zero] * n, zero, false,
                  zero, zero + f(prm.trustregion0),
                  izero, izero, conv0, reason0)

        def attempt(c):
            (p, norm2, jtx, jtj_f, cauchy, n2_cauchy, have_cauchy,
             gn, n2_gn, have_gn, lam, tr, step_count, n_attempts,
             done, reason) = c
            jtj = unflat(jtj_f)
            tr_sq = tr * tr

            # --- Cauchy step, cached per operating point
            # (reference dogleg.c:529-617)
            n2_jtx = _dot_lanes(jtx, jtx)
            k_c = -n2_jtx / _quad_form_lanes(jtj, jtx, n)
            cauchy = [jnp.where(have_cauchy, ci, k_c * gi)
                      for ci, gi in zip(cauchy, jtx)]
            n2_cauchy = jnp.where(have_cauchy, n2_cauchy,
                                  k_c * k_c * n2_jtx)
            use_cauchy = n2_cauchy >= tr_sq

            # --- GN step, masked escalating lambda
            # (reference dogleg.c:822-908, 670-676)
            need_gn = ~use_cauchy & ~have_gn
            gn_f, n2_gn_f, lam_f, fac_ok_f = _gauss_newton_lanes(
                jtj, jtx, lam, need_gn, n,
                lambda_initial=prm.lambda_initial,
                lambda_max_tries=prm.lambda_max_tries)
            gn = [jnp.where(need_gn, a, b) for a, b in zip(gn_f, gn)]
            n2_gn = jnp.where(need_gn, n2_gn_f, n2_gn)
            lam = jnp.where(need_gn, lam_f, lam)
            fac_ok = fac_ok_f
            have_gn = have_gn | need_gn

            # --- step selection (reference dogleg.c:1172-1297)
            use_gn = ~use_cauchy & (n2_gn <= tr_sq)
            d = [ci - gi for ci, gi in zip(cauchy, gn)]
            l2 = _dot_lanes(d, d)
            neg_c = _dot_lanes(d, cauchy)
            disc = jnp.maximum(neg_c * neg_c - l2 * (n2_cauchy - tr_sq),
                               0.0)
            k_i = (neg_c + jnp.sqrt(disc)) / l2
            interp = [ci + k_i * (gi - ci) for ci, gi in zip(cauchy, gn)]

            inv_clen = tr / jnp.sqrt(n2_cauchy)
            step = [jnp.where(use_cauchy, inv_clen * ci,
                              jnp.where(use_gn, gi, ii))
                    for ci, gi, ii in zip(cauchy, gn, interp)]
            stepped_to_edge = ~use_gn

            expected = (-2.0 * _dot_lanes(jtx, step)
                        - _quad_form_lanes(jtj, step, n))

            # --- criterion 2 (reference dogleg.c:1287-1296)
            small_step = _max_abs_lanes(step) <= f(prm.update_threshold)

            # --- trial evaluation (reference dogleg.c:1411); masked out
            # below for small-step/failed lanes like the solver's
            # lax.cond-under-vmap select
            p_new = [a + b for a, b in zip(p, step)]
            norm2_t, jtx_t, jtj_t = eval_products(p_new)
            sk = small_step | ~fac_ok
            norm2_t = jnp.where(sk, norm2, norm2_t)
            jtx_t = [jnp.where(sk, a, b) for a, b in zip(jtx, jtx_t)]
            jtj_t = [jnp.where(sk, a, b) for a, b in zip(jtj_f, jtj_t)]

            observed = norm2 - norm2_t
            rho = observed / expected

            # --- trust-region update (reference dogleg.c:1322-1350);
            # NaN rho fails every comparison -> radius unchanged
            snapped = jnp.where(stepped_to_edge, tr, jnp.sqrt(n2_gn))
            decreased = snapped * f(prm.trustregion_decrease_factor)
            increased = jnp.where(
                stepped_to_edge
                & (rho > f(prm.trustregion_increase_threshold)),
                tr * f(prm.trustregion_increase_factor), tr)
            tr_new = jnp.where(
                rho < f(prm.trustregion_decrease_threshold),
                decreased, increased)

            accept = rho > 0.0
            n_attempts_new = n_attempts + 1
            exhausted = n_attempts_new >= max_attempts
            step_count_acc = step_count + 1

            conv_t = grad_converged(jtx_t)
            max_iters = step_count_acc >= prm.max_iterations
            acc_done = conv_t | max_iters | exhausted
            acc_reason = jnp.where(
                conv_t, int(R.GRADIENT_CONVERGED),
                jnp.where(max_iters, int(R.MAX_ITERATIONS),
                          jnp.where(exhausted, int(R.STALLED),
                                    int(R.RUNNING))))
            rej_small_tr = tr_new < f(prm.trustregion_threshold)
            rej_done = rej_small_tr | exhausted
            rej_reason = jnp.where(
                rej_small_tr, int(R.SMALL_TRUSTREGION),
                jnp.where(exhausted, int(R.STALLED), int(R.RUNNING)))

            # --- path combination, matching solver.py's nested
            # tree_where(~fac_ok, failed, where(small_step, small,
            # where(accept, accepted, rejected)))
            m_fail = ~fac_ok
            m_small = fac_ok & small_step
            m_acc = fac_ok & ~small_step & accept
            m_keep_tr = m_fail | m_small

            def acc(new, old):
                return jnp.where(m_acc, new, old)

            out = (
                [acc(a, b) for a, b in zip(p_new, p)],
                acc(norm2_t, norm2),
                [acc(a, b) for a, b in zip(jtx_t, jtx)],
                [acc(a, b) for a, b in zip(jtj_t, jtj_f)],
                cauchy,
                n2_cauchy,
                ~m_acc,
                gn,
                n2_gn,
                have_gn & ~m_acc,
                lam,
                jnp.where(m_keep_tr, tr, tr_new),
                acc(step_count_acc, step_count),
                n_attempts_new,
                m_fail | m_small | jnp.where(m_acc, acc_done, rej_done),
                jnp.where(
                    m_fail, int(R.FACTORIZATION_FAILED),
                    jnp.where(m_small, int(R.SMALL_STEP),
                              jnp.where(m_acc, acc_reason,
                                        rej_reason))).astype(jnp.int32),
            )
            # freeze terminated lanes
            return jax.tree_util.tree_map(
                lambda old, new: jnp.where(done, old, new), c, out)

        def running(c):
            return jnp.min(c[14].astype(jnp.int32)) == 0

        final = jax.lax.while_loop(running, attempt, carry0)
        (p, norm2, jtx, jtj_f, _, _, _, _, _, _, lam, tr,
         step_count, n_attempts, _, reason) = final
        jtj = unflat(jtj_f)
        for i in range(n):
            p_ref[i] = p[i]
            jtx_ref[i] = jtx[i]
            for j in range(n):
                jtj_ref[i * n + j] = jtj[max(i, j)][min(i, j)]
        for r, v in enumerate((norm2, tr, lam)):
            fscal_ref[r] = v
        for r, v in enumerate((step_count, n_attempts, reason)):
            iscal_ref[r] = v

    return kernel


def megakernel_optimize(products: Callable,
                        p0_batch: jnp.ndarray,
                        parameters: Optional[DoglegParameters] = None,
                        *,
                        problem_data=(),
                        shared_data=(),
                        block_batch: int = DEFAULT_BLOCK_BATCH,
                        mesh=None,
                        axis_name: str = "dp",
                        interpret: bool = False) -> SolveResult:
    """Solve a batch of small dense problems in one whole-solve kernel.

    Args:
      products: lane-form products function (module docstring),
        ``(p lanes, *data, *shared) -> (norm2, Jt_x lanes, JtJ lower
        lanes)``.
      p0_batch: (B, n) initial states, batch-leading like every other
        entry point. B must be a multiple of block_batch.
      problem_data: tuple of per-element arrays with a leading batch
        axis. Inside the kernel, element k of the tuple is a ref whose
        row r is the lane vector of flattened per-element entry r.
      shared_data: tuple of 2-D arrays common to every problem, passed
        whole to every grid program (keep them small).
      block_batch: problems per grid program (the lane-tile width, a
        power of two).
      mesh/axis_name: if given, shard the batch over this mesh axis via
        shard_map: each device runs the kernel on its local batch slice
        (solves are independent; zero communication). B must be
        divisible by (mesh size x block_batch).
      interpret: run in the Pallas interpreter (CPU tests).

    Returns a SolveResult (history=None) with batch-leading leaves.
    """
    prm = parameters if parameters is not None else DoglegParameters()
    B, n = p0_batch.shape
    if block_batch & (block_batch - 1):
        raise ValueError(f"block_batch {block_batch} is not a power of two")

    if mesh is not None:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        def local_solve(p0_l, *data_l):
            return megakernel_optimize(
                products, p0_l, prm, problem_data=data_l,
                shared_data=shared_data, block_batch=block_batch,
                interpret=interpret)

        dp = P(axis_name)
        in_specs = (dp,) + tuple(dp for _ in problem_data)
        out_specs = SolveResult(
            p=dp, norm2_x=dp, Jt_x=dp, JtJ=dp, step_count=dp,
            n_attempts=dp, reason=dp, trustregion=dp, lam=dp,
            history=None)
        # check_vma=False: pallas_call's out ShapeDtypeStructs carry no
        # varying-mesh-axes annotation, and everything here is trivially
        # per-shard (no collectives)
        return shard_map(local_solve, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs,
                         check_vma=False)(p0_batch, *problem_data)

    if B % block_batch:
        raise ValueError(f"batch {B} not divisible by block_batch "
                         f"{block_batch}")
    dt = p0_batch.dtype
    bt = block_batch

    # per-element data -> (rows, B): row r is flattened entry r
    data_rows = tuple(jnp.asarray(d).reshape(B, -1).T for d in problem_data)

    def tile_spec(rows):
        return pl.BlockSpec((rows, bt), lambda i: (0, i))

    shared = tuple(jnp.asarray(a) for a in shared_data)
    in_specs = ([tile_spec(d.shape[0]) for d in data_rows]
                + [pl.BlockSpec(a.shape, lambda i: (0, 0)) for a in shared]
                + [tile_spec(n)])
    out_specs = (tile_spec(n), tile_spec(n), tile_spec(n * n),
                 tile_spec(3), tile_spec(3))
    out_shape = (
        jax.ShapeDtypeStruct((n, B), dt),
        jax.ShapeDtypeStruct((n, B), dt),
        jax.ShapeDtypeStruct((n * n, B), dt),
        jax.ShapeDtypeStruct((3, B), dt),
        jax.ShapeDtypeStruct((3, B), jnp.int32),
    )
    kernel = _make_kernel(products, n, len(data_rows) + len(shared), prm)
    p_m, jtx_m, jtj_m, fscal, iscal = pl.pallas_call(
        kernel,
        grid=(B // bt,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="dogleg_megakernel",
    )(*data_rows, *shared, p0_batch.T)

    return SolveResult(
        p=p_m.T,
        norm2_x=fscal[0],
        Jt_x=jtx_m.T,
        JtJ=jtj_m.T.reshape(B, n, n),
        step_count=iscal[0],
        n_attempts=iscal[1],
        reason=iscal[2],
        trustregion=fscal[1],
        lam=fscal[2],
        history=None)
