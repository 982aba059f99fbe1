"""One process of the 2-process jax.distributed smoke test.

Launched by tests/test_multihost.py (not collected by pytest itself). Each
process owns 2 virtual CPU devices; jax.distributed.initialize unifies them
into a 4-device global mesh whose cross-process collectives ride Gloo — the
same code path (jax.distributed + psum over a global mesh) that carries DCN
traffic on real multi-host clusters (SURVEY.md section 5.8; the reference
has no distribution at all, SURVEY.md section 2.2).

Three legs, each asserted against a process-local single-device reference:
  A. data-parallel batched_optimize over the global mesh (batch axis spans
     both processes);
  B. MeasurementShardedProblem: measurement rows split over all 4 global
     devices, psum of (norm2x, Jt_x, JtJ) crossing the process boundary;
  C. MeasurementShardedSparseProblem: row-sharded measurements contracted
     into block-sparse JtJ, psum'd across processes, solved through the
     level-scheduled sparse Cholesky.

Writes a JSON result file; the parent test diffs the two processes' files
for bitwise agreement.
"""

import argparse
import json
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(
        coordinator_address=f"localhost:{args.port}",
        num_processes=args.nproc, process_id=args.pid)

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from libdogleg_tpu import DenseProblem, DoglegParameters, optimize
    from libdogleg_tpu.ops import dense as dops
    from libdogleg_tpu.parallel import (MeasurementShardedProblem,
                                        MeasurementShardedSparseProblem,
                                        batched_optimize)
    from libdogleg_tpu.solver import Products, solve_products

    assert len(jax.local_devices()) == 2
    assert len(jax.devices()) == args.nproc * 2
    mesh = Mesh(np.array(jax.devices()).reshape(-1), ("ax",))
    prm = DoglegParameters()
    out = {"pid": args.pid, "n_global_devices": len(jax.devices())}

    def to_global(arr):
        """Shard a (replicated-in-every-process) numpy array's leading axis
        over the global mesh axis."""
        sh = NamedSharding(mesh, P("ax"))
        per = arr.shape[0] // len(jax.devices())
        lo = args.pid * 2 * per
        return jax.make_array_from_process_local_data(
            sh, arr[lo:lo + 2 * per], arr.shape)

    # ---- shared instance data (identical in every process) --------------
    rng = np.random.default_rng(7)
    nstate, nmeas, batch = 5, 32, 8
    A = rng.normal(size=(batch, nmeas, nstate))
    Bm = rng.normal(size=(batch, nstate, nstate)) * 0.5
    C = rng.normal(size=(batch, nmeas, nstate)) * 0.3
    p_true = rng.normal(size=(batch, nstate))
    d = (np.einsum('bms,bs->bm', A, np.tanh(np.einsum('bst,bt->bs',
                                                      Bm, p_true)))
         + np.einsum('bms,bs->bm', C, p_true)
         + rng.normal(size=(batch, nmeas)) * 0.05)
    p0s = rng.normal(size=(batch, nstate))

    def products(p, data):
        Ab, Bb, Cb, db = data
        t = jnp.tanh(Bb @ p)
        x = Ab @ t + Cb @ p - db
        J = Ab @ (((1.0 - t * t)[:, None]) * Bb) + Cb
        return Products(norm2_x=dops.norm2(x), Jt_x=dops.jt_dot(J, x),
                        JtJ=dops.build_jtj(J))

    # ---- leg A: data-parallel batch spanning both processes -------------
    data_g = tuple(to_global(a) for a in (A, Bm, C, d))
    r = batched_optimize(products, to_global(p0s), prm, mesh=mesh,
                         axis_name="ax", problem_data=data_g)
    pA = np.asarray(jax.jit(lambda x: x,
                            out_shardings=NamedSharding(mesh, P()))(r.p))
    stepsA = np.asarray(jax.jit(lambda x: x,
                                out_shardings=NamedSharding(mesh, P()))(
        r.step_count))
    # local reference: same solves, one process, no mesh
    r_ref = batched_optimize(products, jnp.asarray(p0s), prm,
                             problem_data=jax.tree_util.tree_map(
                                 jnp.asarray, (A, Bm, C, d)))
    np.testing.assert_allclose(pA, np.asarray(r_ref.p), rtol=1e-12,
                               atol=1e-12)
    assert (stepsA == np.asarray(r_ref.step_count)).all()
    out["legA"] = {"p": pA.tolist(), "steps": stepsA.tolist()}

    # ---- leg B: measurement-sharded dense products (psum over Gloo) -----
    import libdogleg_tpu.models.quadratic_surface as qs
    gx, gy = qs.make_grid(jnp.float64)
    meas = np.asarray(qs.model(jnp.asarray(qs.P_TRUE), gx, gy))
    meas = meas + np.random.default_rng(3).normal(size=meas.shape) * 0.3
    p0 = np.asarray(qs.P_TRUE) + np.random.default_rng(4).normal(size=6)
    gxn, gyn = np.asarray(gx), np.asarray(gy)

    def f_shard(p, data_shard):
        gx_s, gy_s, m_s = data_shard
        return (qs.model(p, gx_s, gy_s) - m_s,
                qs.jacobian(p, gx_s, gy_s))

    # global arrays must enter jit as ARGUMENTS (closing over
    # non-addressable arrays is disallowed in multi-process jax)
    def solveB(q, data):
        sharded = MeasurementShardedProblem(f=f_shard, data=data,
                                            mesh=mesh, axis_name="ax")
        return solve_products(sharded.products, q, prm)

    rB = jax.jit(solveB)(jnp.asarray(p0),
                         (to_global(gxn), to_global(gyn), to_global(meas)))
    pB = np.asarray(jax.jit(lambda x: x,
                            out_shardings=NamedSharding(mesh, P()))(rB.p))

    def f_dense(p):
        return (qs.model(p, jnp.asarray(gxn), jnp.asarray(gyn))
                - jnp.asarray(meas),
                qs.jacobian(p, jnp.asarray(gxn), jnp.asarray(gyn)))

    r_refB = jax.jit(lambda q: optimize(DenseProblem(f=f_dense), q, prm))(
        jnp.asarray(p0))
    np.testing.assert_allclose(pB, np.asarray(r_refB.p), rtol=1e-9,
                               atol=1e-9)
    assert int(rB.step_count) == int(r_refB.step_count)
    out["legB"] = {"p": pB.tolist(), "steps": int(rB.step_count)}

    # ---- leg C: row-sharded block-sparse JtJ -> sparse Cholesky ---------
    rngc = np.random.default_rng(11)
    b, nbcol, nmeas_c = 2, 8, 64
    nstate_c = b * nbcol
    k = 6  # contiguous state window per measurement (3 blocks)
    starts = (np.floor(np.arange(nmeas_c) * (nstate_c - k)
                       / (nmeas_c - 1)).astype(int) // b) * b
    cols = starts[:, None] + np.arange(k)[None, :]
    a_c = rngc.normal(size=(nmeas_c, k))
    w_c = rngc.normal(size=(nmeas_c, k)) * 0.5
    pt_c = rngc.normal(size=nstate_c)
    d_c = (a_c * np.tanh(w_c * pt_c[cols])).sum(1) \
        + rngc.normal(size=nmeas_c) * 0.02
    p0_c = rngc.normal(size=nstate_c)

    # stored lower-triangle JtJ block pattern from the band structure
    touched = np.zeros((nmeas_c, nbcol), bool)
    for i in range(nmeas_c):
        touched[i, np.unique(cols[i] // b)] = True
    pat = set()
    for i in range(nmeas_c):
        blocks = np.nonzero(touched[i])[0]
        for r_ in blocks:
            for c_ in blocks:
                if r_ >= c_:
                    pat.add((int(r_), int(c_)))
    for j in range(nbcol):
        pat.add((j, j))
    pat = sorted(pat)
    prows = np.array([r_ for r_, _ in pat], np.int32)
    pcols = np.array([c_ for _, c_ in pat], np.int32)

    colsj = jnp.asarray(cols)

    # each shard's support indices travel with the data (leading meas axis)
    def f_rows2(p, data_shard):
        aj, wj, dj, cj = data_shard
        pw = p[cj]
        t = jnp.tanh(wj * pw)
        x = (aj * t).sum(1) - dj
        m_local = aj.shape[0]
        J = jnp.zeros((m_local, nstate_c), p.dtype)
        J = jax.vmap(lambda row, c, v: row.at[c].set(v))(
            J, cj, aj * wj * (1.0 - t * t))
        return x, J

    sp0 = MeasurementShardedSparseProblem(
        f=f_rows2, data=None, pattern_rows=prows, pattern_cols=pcols, b=b,
        mesh=mesh, axis_name="ax")

    def solveC(q, data):
        sp = MeasurementShardedSparseProblem(
            f=f_rows2, data=data, pattern_rows=prows, pattern_cols=pcols,
            b=b, mesh=mesh, axis_name="ax")
        return solve_products(sp.products, q, prm,
                              newton_solver=sp0.newton_solver())

    rC = jax.jit(solveC)(jnp.asarray(p0_c),
                         (to_global(a_c), to_global(w_c), to_global(d_c),
                          to_global(cols)))
    pC = np.asarray(jax.jit(lambda x: x,
                            out_shardings=NamedSharding(mesh, P()))(rC.p))

    def f_dense_c(p):
        pw = p[colsj]
        t = jnp.tanh(jnp.asarray(w_c) * pw)
        x = (jnp.asarray(a_c) * t).sum(1) - jnp.asarray(d_c)
        J = jnp.zeros((nmeas_c, nstate_c), p.dtype)
        J = jax.vmap(lambda row, c, v: row.at[c].set(v))(
            J, colsj, jnp.asarray(a_c) * jnp.asarray(w_c) * (1.0 - t * t))
        return x, J

    r_refC = jax.jit(lambda q: optimize(DenseProblem(f=f_dense_c), q, prm))(
        jnp.asarray(p0_c))
    # sparse level-scheduled Cholesky vs the dense reference factorization:
    # same decisions, ulp-different GN steps accumulate to ~1e-7 in p
    np.testing.assert_allclose(pC, np.asarray(r_refC.p), rtol=1e-6,
                               atol=1e-6)
    assert int(rC.step_count) == int(r_refC.step_count)
    out["legC"] = {"p": pC.tolist(), "steps": int(rC.step_count)}

    with open(args.out, "w") as fh:
        json.dump(out, fh)
    print("MULTIHOST_WORKER_OK", args.pid)
    return 0


if __name__ == "__main__":
    sys.exit(main())
