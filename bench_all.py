"""Full benchmark matrix: the five BASELINE.json configurations plus two.

bench.py is the batched headline (config 3, kernel against XLA); this
script measures every config and prints one JSON line per config, each
naming the device. It runs on the default backend; the float64 oracle
columns run on the host CPU backend.

  1. sparse sample.c problem (block-CSR path), single-solve latency
  2. dense path: small dense-Jacobian curve fit, single-solve latency
  3. batched trust-region: 10k independent small problems vmapped per card
  4. large block-sparse BA-style problem: Schur elimination of point blocks
  5. covariance/outlierness pass from the factored JtJ
  6. large sparse grid MRF: supernodal block-sparse Cholesky vs dense JtJ
  7. nonlinear pinhole-camera bundle adjustment (the reference's domain)
"""

import dataclasses
import json

from libdogleg_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import libdogleg_tpu.models.quadratic_surface as sp  # noqa: E402
from libdogleg_tpu import DoglegParameters, optimize  # noqa: E402
from libdogleg_tpu.analysis import get_outlierness_factors  # noqa: E402
from libdogleg_tpu.models import (bundle_adjustment, curve_fit,  # noqa: E402
                                  grid_mrf, pinhole_ba)
from libdogleg_tpu.ops.cholesky import factorize_jtj  # noqa: E402
from libdogleg_tpu.ops.newton import build_cam_gather  # noqa: E402
from libdogleg_tpu.solver import Products, solve_products  # noqa: E402
from libdogleg_tpu.utils.benchtime import measure  # noqa: E402

DTYPE = jnp.float32
PRM = DoglegParameters(max_iterations=10, Jt_x_threshold=1e-3,
                       update_threshold=1e-5, trustregion_threshold=1e-5)


# The reference's numeric contract is C doubles end-to-end with 1e-8
# termination thresholds (reference dogleg.c:125-127). Device rows run f32
# with loosened thresholds; the f64 oracle columns below quantify what
# that costs, per instance, against an f64 CPU solve of the SAME
# (f32-rounded) instance under the reference's tight defaults.
TIGHT64 = DoglegParameters()


def _cast64(tree):
    """Cast every floating leaf up to f64 (exact); non-float leaves
    (index tables, static ints) pass through."""
    def cast(a):
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating):
            return jnp.asarray(np.asarray(a), jnp.float64)
        return a
    return jax.tree_util.tree_map(cast, tree)


def _flat64(p):
    return np.concatenate([np.asarray(l, np.float64).ravel()
                           for l in jax.tree_util.tree_leaves(p)])


def _g(x):
    return float(f"{float(x):.4g}")


def f64_accuracy_cols(solve64, p32, n2_32, p32r=None, n2_32r=None):
    """Accuracy-vs-f64 evidence columns.

    solve64(p0_or_None): thunk returning (p, norm2_x) from an f64 solve
    of the SAME (f32-rounded) instance under the reference's tight
    default thresholds, traced with x64 enabled on the host CPU backend.
    Called twice: with None (solve from the config's own start — the
    trajectory-level oracle for final_cost_ratio) and with the f32
    solution (an f64 POLISH — the parameter-error oracle: under
    near-gauge/flat directions two independent trajectories legitimately
    land far apart at identical cost, so distance-to-own-polish is the
    honest measure of how far f32 stopped from a true optimum).
    p32/n2_32: the f32 device solution; p32r/n2_32r: optionally the same
    solve with iterative refinement (ops/newton refine_iters) enabled.
    """
    try:
        dev = jax.devices("cpu")[0]
    except RuntimeError:
        return {"f64_oracle": "cpu backend unavailable"}
    with jax.enable_x64(True), jax.default_device(dev):
        _, n264 = solve64(None)
        n264 = float(n264)
        pp, _ = solve64(_cast64(jax.device_get(p32)))
        pol = _flat64(jax.device_get(pp))
        err = np.linalg.norm(_flat64(p32) - pol) / np.linalg.norm(pol)
        cols = dict(
            f64_final_cost=_g(n264),
            f32_final_cost=_g(n2_32),
            final_cost_ratio_f32_vs_f64=_g(float(n2_32) / n264),
            param_rel_err_f32_vs_polish=_g(err))
        if p32r is not None:
            ppr, _ = solve64(_cast64(jax.device_get(p32r)))
            polr = _flat64(jax.device_get(ppr))
            errr = (np.linalg.norm(_flat64(p32r) - polr)
                    / np.linalg.norm(polr))
            cols.update(
                final_cost_ratio_f32_refined_vs_f64=_g(float(n2_32r)
                                                       / n264),
                param_rel_err_f32_refined_vs_polish=_g(errr))
    return cols


def timeit(fn, *args):
    """(warm per-call seconds, one output): a host clock around
    block_until_ready (utils/benchtime.py)."""
    t = measure(fn, *args)
    return t.warm_s, t.out


def emit(config, metric, value, unit, **extra):
    dev = jax.devices()[0]
    print(json.dumps({"config": config, "metric": metric,
                      "value": float(value), "unit": unit,
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": jax.device_count()},
                      **extra}), flush=True)


def config1_sparse():
    meas = sp.simulate(jax.random.PRNGKey(0), dtype=DTYPE)
    p0 = sp.initial_state(jax.random.PRNGKey(1), dtype=DTYPE)
    problem = sp.make_sparse_problem(meas)
    f = jax.jit(lambda q: optimize(problem, q, PRM).p)
    dt, out = timeit(f, p0)
    emit("1-sparse-sample", "single_solve_latency", dt * 1e6, "us",
         recovered=bool(np.all(np.abs(np.asarray(out) - sp.P_TRUE) < 0.2)))


def config2_dense():
    meas = curve_fit.simulate(jax.random.PRNGKey(0), dtype=DTYPE)
    p0 = curve_fit.initial_state(jax.random.PRNGKey(1), dtype=DTYPE)
    problem = curve_fit.make_dense_problem(meas)
    f = jax.jit(lambda q: optimize(problem, q, PRM).p)
    dt, out = timeit(f, p0)
    emit("2-dense-curvefit", "single_solve_latency", dt * 1e6, "us",
         recovered=bool(np.all(
             np.abs(np.asarray(out) - curve_fit.P_TRUE) < 0.2)))


def config3_batched(batch=10000):
    gx, gy = sp.make_grid(DTYPE)

    def products(p, meas):
        x = sp.model(p, gx, gy) - meas
        J = sp.jacobian(p, gx, gy)
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)

    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    meas = jax.vmap(lambda k: sp.simulate(k, dtype=DTYPE))(keys)
    p0s = jax.vmap(lambda k: sp.initial_state(k, dtype=DTYPE))(
        jax.random.split(jax.random.PRNGKey(1), batch))
    from libdogleg_tpu.parallel.batched import batched_optimize_compacted
    # measure both carry layouts and report the winner
    results = {}
    for layout in ("leading", "minor"):
        f = jax.jit(lambda p0s, m: batched_optimize_compacted(
            products, p0s, PRM, problem_data=m, layout=layout).p)
        dt, out = timeit(f, p0s, meas)
        results[layout] = (dt, out)
    layout = min(results, key=lambda k: results[k][0])
    dt, out = results[layout]
    alt = max(results, key=lambda k: results[k][0])
    err = np.abs(np.asarray(out) - sp.P_TRUE[None])
    emit("3-batched-10k", "batched_solves_per_s", batch / dt, "solves/s",
         vs_baseline=round(batch / dt / 1e4, 2), layout=layout,
         alt_layout_solves_per_s=round(batch / results[alt][0], 1),
         recovered_frac=round(float(np.mean(np.all(err < 0.2, -1))), 4))


def config3f_batched_factored(batch=10000):
    """Config 3's problem through the basis-factored sufficient-statistics
    formulation (models/quadratic_surface.factored_products): per-attempt
    work reads 14 f32 of Gram statistics instead of streaming the 100
    measurements, with the cancelling combinations compensated in
    double-f32. Same optimum, same recovery gate — a reformulation the
    reference's callback model cannot express."""
    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    meas = jax.vmap(lambda k: sp.simulate(k, dtype=DTYPE))(keys)
    p0s = jax.vmap(lambda k: sp.initial_state(k, dtype=DTYPE))(
        jax.random.split(jax.random.PRNGKey(1), batch))
    G_pair = sp.gram_pair(DTYPE)
    stats = jax.vmap(sp.factored_statistics)(meas)
    from libdogleg_tpu.parallel.batched import batched_optimize_compacted
    results = {}
    for layout in ("leading", "minor"):
        f = jax.jit(lambda q, s: batched_optimize_compacted(
            lambda p, st: sp.factored_products(p, st, G_pair), q, PRM,
            problem_data=s, layout=layout).p)
        dt, out = timeit(f, p0s, stats)
        results[layout] = (dt, out)
    layout = min(results, key=lambda k: results[k][0])
    dt, out = results[layout]
    alt = max(results, key=lambda k: results[k][0])
    err = np.abs(np.asarray(out) - sp.P_TRUE[None])
    emit("3f-batched-factored", "batched_solves_per_s", batch / dt,
         "solves/s", vs_baseline=round(batch / dt / 1e4, 2),
         layout=layout,
         alt_layout_solves_per_s=round(batch / results[alt][0], 1),
         recovered_frac=round(float(np.mean(np.all(err < 0.2, -1))), 4))


def config4_ba_schur(nc=64, n_points=20000, bs=3, k_obs=4):
    ba = bundle_adjustment.make_synthetic(
        seed=0, nc=nc, n_points=n_points, block_size=bs, k_obs=k_obs,
        dtype=DTYPE)
    ns = ba.newton_solver()
    f = jax.jit(lambda p0: solve_products(ba.products, p0, PRM,
                                          newton_solver=ns))
    dt, out = timeit(f, jnp.zeros(ba.nstate, DTYPE))
    # refined leg: 2 compensated-residual refinement passes per GN solve
    ns_r = dataclasses.replace(ns, refine_iters=2)
    f_r = jax.jit(lambda p0: solve_products(ba.products, p0, PRM,
                                            newton_solver=ns_r))
    dt_r, out_r = timeit(f_r, jnp.zeros(ba.nstate, DTYPE))
    def solve64(start):
        ba64 = _cast64(ba)   # must run inside the x64 context
        if start is None:
            start = jnp.zeros(ba64.nstate, jnp.float64)
        r = jax.jit(lambda p0: solve_products(
            ba64.products, p0, TIGHT64,
            newton_solver=ba64.newton_solver()))(start)
        return r.p, r.norm2_x
    acc = f64_accuracy_cols(solve64, out.p, out.norm2_x,
                            out_r.p, out_r.norm2_x)
    emit("4-ba-schur", "solve_latency", dt * 1e3, "ms",
         nstate=ba.nstate, nmeas=ba.nmeasurements,
         converged=bool(np.asarray(out.norm2_x) < 1e-3),
         refined_ms=round(dt_r * 1e3, 3), **acc)


def config5_outlierness(nmeas=100000, nstate=64, feature_size=2):
    rng = np.random.default_rng(0)
    J = jnp.asarray(rng.normal(size=(nmeas, nstate)), DTYPE)
    x = jnp.asarray(rng.normal(size=(nmeas,)), DTYPE)
    JtJ = jnp.matmul(J.T, J, preferred_element_type=DTYPE)

    def pass_(J, x, JtJ):
        fac = factorize_jtj(JtJ, jnp.asarray(0.0, DTYPE))
        factors, _ = get_outlierness_factors(x, J, fac.L,
                                             feature_size=feature_size)
        return factors

    f = jax.jit(pass_)
    dt, out = timeit(f, J, x, JtJ)
    emit("5-outlierness", "features_per_s",
         (nmeas // feature_size) / dt, "features/s",
         nmeas=nmeas, nstate=nstate)


def config6_sparse_grid(width=32, height=32, b=8, amalgamate=16,
                        label="6-sparse-grid-mrf", with_dense=True,
                        with_f64=True):
    """Large sparse single problem: RCM-ordered supernodal amalgamation vs
    the dense-JtJ path on the same instance. The supernodal block-sparse
    Cholesky is where sparsity starts beating dense products — the
    analog of the reference's "massive performance gains" claim
    (README.pod:19-21)."""
    m = grid_mrf.make_grid_mrf(width=width, height=height, block_size=b,
                               dtype=DTYPE)
    from libdogleg_tpu.problems import SparseProblem
    base = m.problem(jtj="dense")
    sp_prob = SparseProblem(f=base.f, structure=base.structure,
                            jtj="sparse", ordering="rcm",
                            amalgamate=amalgamate)
    ns = sp_prob.default_newton_solver()
    f_sp = jax.jit(lambda p0: optimize(sp_prob, p0, PRM,
                                       newton_solver=ns))
    dt_sp, r_sp = timeit(f_sp, jnp.zeros(m.nstate, DTYPE))
    out = r_sp.norm2_x
    extra = {}
    if with_f64:
        def solve64(start):
            m64 = _cast64(m)
            base64 = m64.problem(jtj="dense")
            sp64 = SparseProblem(f=base64.f, structure=base64.structure,
                                 jtj="sparse", ordering="rcm",
                                 amalgamate=amalgamate)
            if start is None:
                start = jnp.zeros(m64.nstate, jnp.float64)
            r = jax.jit(lambda p0: optimize(
                sp64, p0, TIGHT64,
                newton_solver=sp64.default_newton_solver()))(start)
            return r.p, r.norm2_x
        extra.update(f64_accuracy_cols(solve64, r_sp.p, out))
    if with_dense:
        f_d = jax.jit(lambda p0: optimize(base, p0, PRM).norm2_x)
        dt_d, _ = timeit(f_d, jnp.zeros(m.nstate, DTYPE))
        extra.update(dense_mode_ms=round(dt_d * 1e3, 2),
                     sparse_speedup_vs_dense=round(dt_d / dt_sp, 2))
    inner = ns.symbolic.inner
    emit(label, "solve_latency", dt_sp * 1e3, "ms",
         nstate=m.nstate, n_nodes=m.n_nodes, amalgamate=amalgamate,
         super_levels=inner.sched.nlevels, super_block=inner.b,
         converged=bool(np.isfinite(np.asarray(out))), **extra)


def config7_pinhole_ba(ncam=32, npts=20000):
    """Nonlinear pinhole-camera bundle adjustment — the reference's actual
    application domain (README.pod:5-15): reprojection errors, autodiff
    per-observation Jacobians, Schur elimination on pytree states."""
    ba = pinhole_ba.make_synthetic(seed=0, ncam=ncam, npts=npts,
                                   dtype=DTYPE)
    p0 = ba.p0(jax.random.PRNGKey(2), jitter=0.02)
    f = jax.jit(lambda pc, pq: solve_products(
        ba.products, {"c": pc, "q": pq}, PRM,
        newton_solver=ba.newton_solver()))
    dt, out = timeit(f, p0["c"], p0["q"])
    def solve64(start):
        ba64 = _cast64(ba)
        if start is None:
            start = _cast64(p0)
        r = jax.jit(lambda pc, pq: solve_products(
            ba64.products, {"c": pc, "q": pq}, TIGHT64,
            newton_solver=ba64.newton_solver()))(start["c"], start["q"])
        return r.p, r.norm2_x
    acc = f64_accuracy_cols(solve64, out.p, out.norm2_x)
    nobs_res = 2 * ba.nobs
    emit("7-pinhole-ba", "solve_latency", dt * 1e3, "ms",
         ncam=ncam, npts=npts, nobs=ba.nobs, nstate=ba.nstate,
         converged=bool(np.asarray(out.norm2_x) < 1.0 * nobs_res), **acc)


def config7s_sparse_visibility_ba(ncam=128, npts=50000, k_obs=4,
                                  label="7s-sparse-vis-ba",
                                  with_f64=True):
    """Large sparse-visibility bundle adjustment: each point seen by k_obs
    of the 128 cameras. The dense coupling W of SchurJtJ would be
    nc x npts x 3 f32 = 460 MB here and is never built — SparseWSchurJtJ
    stores the 14 MB of actual nonzero blocks and the solver reduces over
    the camera axis with one-hot einsums (ops/newton.py). A scale the
    dense-W path cannot reach on one card."""
    ba = pinhole_ba.make_synthetic_sparse(seed=0, ncam=ncam, npts=npts,
                                          k_obs=k_obs, dtype=DTYPE)
    ns = ba.newton_solver()
    p0 = ba.p0(jax.random.PRNGKey(2), jitter=0.02)
    f = jax.jit(lambda pc, pq: solve_products(
        ba.products, {"c": pc, "q": pq}, PRM, newton_solver=ns))
    dt, out = timeit(f, p0["c"], p0["q"])
    acc = {}
    if with_f64:
        # refined leg: 2 compensated-residual refinement passes, with the
        # static per-camera gather table for a fully compensated residual
        ns_r = dataclasses.replace(
            ns, refine_iters=2,
            cam_gather=build_cam_gather(ba.cam_of, ncam))
        f_r = jax.jit(lambda pc, pq: solve_products(
            ba.products, {"c": pc, "q": pq}, PRM, newton_solver=ns_r))
        dt_r, out_r = timeit(f_r, p0["c"], p0["q"])
        def solve64(start):
            ba64 = _cast64(ba)
            if start is None:
                start = _cast64(p0)
            r = jax.jit(lambda pc, pq: solve_products(
                ba64.products, {"c": pc, "q": pq}, TIGHT64,
                newton_solver=ba64.newton_solver()))(start["c"],
                                                     start["q"])
            return r.p, r.norm2_x
        acc = f64_accuracy_cols(solve64, out.p, out.norm2_x,
                                out_r.p, out_r.norm2_x)
        acc["refined_ms"] = round(dt_r * 1e3, 3)
    emit(label, "solve_latency", dt * 1e3, "ms",
         ncam=ncam, npts=npts, k_obs=k_obs, nobs=ba.nobs,
         nstate=ba.nstate,
         converged=bool(np.asarray(out.norm2_x) < 1.0 * 2 * ba.nobs),
         **acc)


def config7o_ba_outlierness(ncam=128, npts=50000, k_obs=4):
    """Observation-level outlierness at BA scale: the featureSize-2 Cook's
    factors for every observation from the sparse-W Schur factors
    (analysis.get_outlierness_factors_ba) — no dense J or factor ever
    exists."""
    from libdogleg_tpu.analysis import get_outlierness_factors_ba
    ba = pinhole_ba.make_synthetic_sparse(seed=0, ncam=ncam, npts=npts,
                                          k_obs=k_obs, dtype=DTYPE)
    solver = ba.newton_solver()
    p0 = ba.p0(jax.random.PRNGKey(2), jitter=0.02)
    r = jax.jit(lambda pc, pq: solve_products(
        ba.products, {"c": pc, "q": pq}, PRM,
        newton_solver=solver))(p0["c"], p0["q"])
    jax.block_until_ready(r.norm2_x)
    nmeas = 2 * ba.nobs + 6 + 3 * ba.npts
    # the solve's factorization, recomputed once via the public handle and
    # REUSED by the pass — the reference's cached-factor semantics
    # (dogleg.c:2636-2652); the pass itself no longer refactorizes
    fac = jax.jit(lambda pc, pq, lam: solver.factor(
        ba.products({"c": pc, "q": pq}).JtJ, lam))(
            r.p["c"], r.p["q"], r.lam)
    jax.block_until_ready(fac)

    def outl(pc, pq, lam, n2, fac):
        robs, Jc, Jq = ba.observation_jacobians({"c": pc, "q": pq})
        JtJ = ba.products({"c": pc, "q": pq}).JtJ
        f, _ = get_outlierness_factors_ba(robs, Jc, Jq, JtJ, lam, n2,
                                          nmeas, solver,
                                          factorization=fac)
        return f

    f = jax.jit(outl)
    dt, out = timeit(f, r.p["c"], r.p["q"], r.lam, r.norm2_x, fac)
    emit("7o-ba-outlierness", "pass_latency", dt * 1e3, "ms",
         nobs=ba.nobs, nstate=ba.nstate, obs_per_s=round(ba.nobs / dt),
         finite=bool(np.isfinite(np.asarray(out)).all()))


def config9_batched_schur_ba(batch=64, ncam=4, npts=2048):
    """Batched STRUCTURED solves — the fleet-calibration case: a batch of
    independent pinhole-BA instances (same rig geometry, distinct
    measurement noise and starts), each solved by Schur elimination,
    vmapped into one program. Composes BASELINE configs 3 (batched) and 4
    (structured JtJ): the per-instance factorization is batched 3x3 point
    eliminations + one small dense reduced camera system, all vmapped."""
    ba = pinhole_ba.make_synthetic(seed=0, ncam=ncam, npts=npts,
                                   dtype=DTYPE)
    ns = ba.newton_solver()
    obs_b = ba.obs[None] + 0.5 * jax.random.normal(
        jax.random.PRNGKey(8), (batch,) + ba.obs.shape, DTYPE)
    p0s = jax.vmap(lambda k: ba.p0(k, jitter=0.02))(
        jax.random.split(jax.random.PRNGKey(7), batch))

    def solve_one(obs_i, pc0, pq0):
        bai = ba._replace(obs=obs_i)
        return solve_products(bai.products, {"c": pc0, "q": pq0}, PRM,
                              newton_solver=ns).norm2_x

    f = jax.jit(jax.vmap(solve_one))
    dt, out = timeit(f, obs_b, p0s["c"], p0s["q"])
    nobs_res = 2 * ba.nobs
    conv = float(np.mean(np.asarray(out) < 1.0 * nobs_res))
    emit("9-batched-schur-ba", "batched_solves_per_s", batch / dt,
         "solves/s", batch=batch, ncam=ncam, npts=npts,
         nstate=ba.nstate, converged_frac=round(conv, 4))


def config8_batched_midsize(nstate=64, batch=512, meas_factor=4):
    """Mid-size batched throughput: dense Nstate=64/128 problems, the
    regime ABOVE smallchol.SMALL_N_MAX=16 where the batch rides the
    blocked lax.linalg Cholesky (multi-camera-calibration scale). The
    Nstate=6 headline (config 3) says nothing about this branch; this
    config tracks it. Problem family: the random-parity tanh residuals
    r = A tanh(Bp) + Cp - d with analytic J (one instance per element)."""
    nmeas = meas_factor * nstate
    rng = np.random.default_rng(8)
    A = jnp.asarray(rng.normal(size=(batch, nmeas, nstate)), DTYPE)
    Bm = jnp.asarray(rng.normal(size=(batch, nstate, nstate)) * 0.5
                     / np.sqrt(nstate), DTYPE)
    C = jnp.asarray(rng.normal(size=(batch, nmeas, nstate)) * 0.3, DTYPE)
    p_true = rng.normal(size=(batch, nstate))
    d_np = (np.einsum('bms,bs->bm', np.asarray(A),
                      np.tanh(np.einsum('bst,bt->bs', np.asarray(Bm),
                                        p_true)))
            + np.einsum('bms,bs->bm', np.asarray(C), p_true)
            + rng.normal(size=(batch, nmeas)) * 0.01)
    d = jnp.asarray(d_np, DTYPE)
    p0s = jnp.asarray(p_true + rng.normal(size=(batch, nstate)) * 0.1,
                      DTYPE)

    def products(p, data):
        Ab, Bb, Cb, db = data
        t = jnp.tanh(Bb @ p)
        x = Ab @ t + Cb @ p - db
        J = jnp.matmul(Ab, ((1.0 - t * t)[:, None]) * Bb,
                       preferred_element_type=DTYPE) + Cb
        return Products(norm2_x=x @ x, Jt_x=J.T @ x,
                        JtJ=jnp.matmul(J.T, J,
                                       preferred_element_type=DTYPE))

    from libdogleg_tpu.parallel.batched import batched_optimize
    f = jax.jit(lambda q, data: batched_optimize(
        products, q, PRM, problem_data=data).p)
    dt, out = timeit(f, p0s, (A, Bm, C, d))
    err = np.abs(np.asarray(out) - p_true)
    emit(f"8-batched-n{nstate}", "batched_solves_per_s", batch / dt,
         "solves/s", nstate=nstate, nmeas=nmeas, batch=batch,
         recovered_frac=round(float(np.mean(np.all(err < 0.05, -1))), 4))


if __name__ == "__main__":
    config1_sparse()
    config2_dense()
    config3_batched()
    config3f_batched_factored()
    config4_ba_schur()
    config5_outlierness()
    config6_sparse_grid()
    # 4x the grid: dense JtJ would be 4.3 GB — sparse-only scale point
    config6_sparse_grid(width=64, height=64, label="6b-sparse-grid-64x64",
                        with_dense=False, with_f64=False)
    config7_pinhole_ba()
    config7s_sparse_visibility_ba()
    config7s_sparse_visibility_ba(ncam=256, npts=200000, k_obs=4,
                                  label="7xl-sparse-vis-ba",
                                  with_f64=False)
    config7o_ba_outlierness()
    config8_batched_midsize(nstate=64, batch=512)
    config8_batched_midsize(nstate=128, batch=256)
    config9_batched_schur_ba()
