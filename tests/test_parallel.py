"""Distributed-layer tests on a fake 8-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8) — the hardware-less multi-device test mode
(SURVEY.md section 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import libdogleg_tpu.sample_problem as sp
from libdogleg_tpu import DoglegParameters, StopReason, optimize, solve_products
from libdogleg_tpu.parallel import (MeasurementShardedProblem,
                                    batched_optimize, make_mesh, shard_batch)


@pytest.fixture(scope="module")
def measurements():
    return sp.simulate(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def p0():
    return sp.initial_state(jax.random.PRNGKey(1))


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def _sharded_problem(measurements, mesh):
    gx, gy = sp.make_grid(measurements.dtype)

    def f_shard(p, data):
        gx_s, gy_s, m_s, w_s = data
        x = (sp.model(p, gx_s, gy_s) - m_s) * w_s
        return x, sp.jacobian(p, gx_s, gy_s) * w_s[:, None]

    # 100 measurements don't divide by 8; pad with zero-weight rows — a
    # zeroed residual and Jacobian row contributes nothing to any product.
    pad = (-len(measurements)) % 8
    z = jnp.zeros((pad,), measurements.dtype)
    w = jnp.concatenate([jnp.ones_like(measurements), z])
    data = (jnp.concatenate([gx, z]), jnp.concatenate([gy, z]),
            jnp.concatenate([measurements, z]), w)
    return MeasurementShardedProblem(f=f_shard, data=data, mesh=mesh,
                                     axis_name="meas")


def test_measurement_sharded_products_match_dense(measurements, p0):
    mesh = make_mesh(("meas",))
    problem = _sharded_problem(measurements, mesh)
    ref = sp.make_dense_problem(measurements).products(p0)
    got = problem.products(p0)
    np.testing.assert_allclose(got.norm2_x, ref.norm2_x, rtol=1e-12)
    np.testing.assert_allclose(got.Jt_x, ref.Jt_x, rtol=1e-12)
    np.testing.assert_allclose(got.JtJ, ref.JtJ, rtol=1e-12)


def test_measurement_sharded_solve(measurements, p0):
    """The full solve jits over the mesh: row-block-partitioned Jacobian,
    psum of JtJ/Jtx/norm2x, replicated Nstate-sized iteration."""
    mesh = make_mesh(("meas",))
    problem = _sharded_problem(measurements, mesh)
    prm = DoglegParameters(max_iterations=8)
    r = jax.jit(lambda q: optimize(problem, q, prm))(p0)
    assert int(r.step_count) <= 8
    np.testing.assert_allclose(np.asarray(r.p), sp.P_TRUE, atol=5e-2)
    # exact agreement with the single-device dense solve
    r_dense = optimize(sp.make_dense_problem(measurements), p0, prm)
    np.testing.assert_allclose(np.asarray(r.p), np.asarray(r_dense.p),
                               rtol=1e-9)
    assert int(r.step_count) == int(r_dense.step_count)


def test_batched_optimize_sharded(measurements):
    """Config-3 shape (BASELINE.md): many independent problems, batch axis
    sharded over the mesh."""
    mesh = make_mesh(("dp",))
    problem = sp.make_dense_problem(measurements)
    keys = jax.random.split(jax.random.PRNGKey(3), 32)
    p0s = shard_batch(jax.vmap(sp.initial_state)(keys), mesh)

    r = batched_optimize(problem.products, p0s, mesh=mesh)
    assert r.p.shape == (32, sp.NSTATE)
    assert np.all(np.abs(np.asarray(r.p) - sp.P_TRUE) < 5e-2)
    # results carry the batch sharding
    assert r.p.sharding.spec == jax.sharding.PartitionSpec("dp")


def test_batched_optimize_per_element_data(measurements):
    """Distinct problem instances per batch element (different measurement
    noise), still one program."""
    mesh = make_mesh(("dp",))
    gx, gy = sp.make_grid(measurements.dtype)
    keys = jax.random.split(jax.random.PRNGKey(4), 16)
    meas_batch = jax.vmap(lambda k: sp.simulate(k))(keys)
    p0s = jax.vmap(sp.initial_state)(jax.random.split(jax.random.PRNGKey(5), 16))

    def products(p, meas):
        x = sp.model(p, gx, gy) - meas
        J = sp.jacobian(p, gx, gy)
        from libdogleg_tpu.solver import Products
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)

    r = batched_optimize(products, shard_batch(p0s, mesh), mesh=mesh,
                         problem_data=shard_batch(meas_batch, mesh))
    # Noise realizations differ per element; 5e-2 is sample.c's criterion for
    # its one canonical seed — use a statistically safe bound here.
    assert np.all(np.abs(np.asarray(r.p) - sp.P_TRUE) < 0.2)


def test_two_axis_mesh_dp_by_meas(measurements):
    """2-D mesh: batch of solves on the dp axis, each with its measurement
    rows sharded over the mp axis — DP x TP composed in one program."""
    mesh = make_mesh(("dp", "meas"), shape=(4, 2))
    gx, gy = sp.make_grid(measurements.dtype)
    pad = (-sp.NMEAS) % 2
    assert pad == 0

    def f_shard(p, data):
        gx_s, gy_s, m_s = data
        return sp.model(p, gx_s, gy_s) - m_s, sp.jacobian(p, gx_s, gy_s)

    problem = MeasurementShardedProblem(
        f=f_shard, data=(gx, gy, measurements), mesh=mesh, axis_name="meas")

    keys = jax.random.split(jax.random.PRNGKey(6), 8)
    p0s = jax.vmap(sp.initial_state)(keys)

    # vmap over starts; shard_map inside handles the meas axis.
    r = jax.jit(jax.vmap(lambda q: optimize(problem, q)))(p0s)
    assert np.all(np.abs(np.asarray(r.p) - sp.P_TRUE) < 5e-2)


def test_tree_state_schur_matches_flat():
    """Pytree solver states: the {"c", "q"} structured BA solve takes the
    same trajectory as the flat-vector solve."""
    from libdogleg_tpu.models import bundle_adjustment
    ba = bundle_adjustment.make_synthetic(seed=3, nc=8, n_points=64,
                                          block_size=3, k_obs=4,
                                          dtype=jnp.float64, noise=0.05)
    r_flat = solve_products(ba.products, jnp.zeros(ba.nstate),
                            DoglegParameters(),
                            newton_solver=ba.newton_solver())
    r_tree = solve_products(ba.products_tree, ba.p0_tree(),
                            DoglegParameters(),
                            newton_solver=ba.tree_newton_solver())
    p_tree = np.concatenate([np.asarray(r_tree.p["c"]),
                             np.asarray(r_tree.p["q"]).reshape(-1)])
    np.testing.assert_allclose(p_tree, np.asarray(r_flat.p),
                               rtol=1e-12, atol=1e-14)
    assert int(r_tree.step_count) == int(r_flat.step_count)


def test_sharded_schur_elimination():
    """Distributed Schur elimination (BASELINE config 4's multi-chip form):
    point data and states sharded over a 'pts' mesh axis, camera block
    replicated; GSPMD keeps the solve distributed (all-reduce for the
    reduced system) and the result matches the single-device solve."""
    from libdogleg_tpu.models import bundle_adjustment
    from libdogleg_tpu.parallel import make_mesh
    ba = bundle_adjustment.make_synthetic(seed=3, nc=8, n_points=64,
                                          block_size=3, k_obs=4,
                                          dtype=jnp.float64, noise=0.05)
    r_ref = solve_products(ba.products, jnp.zeros(ba.nstate),
                           DoglegParameters(),
                           newton_solver=ba.newton_solver())
    mesh = make_mesh(("pts",), shape=(8,))
    ba_s = ba.shard(mesh)
    p0s = ba.shard_p_tree(ba.p0_tree(), mesh)
    f = jax.jit(lambda p0: solve_products(
        ba_s.products_tree, p0, DoglegParameters(),
        newton_solver=ba_s.tree_newton_solver()))
    r = f(p0s)
    p_flat = np.concatenate([np.asarray(r.p["c"]),
                             np.asarray(r.p["q"]).reshape(-1)])
    np.testing.assert_allclose(p_flat, np.asarray(r_ref.p),
                               rtol=1e-9, atol=1e-11)
    # the point states must still be sharded over the mesh, and the
    # compiled program must contain collectives (it actually distributed)
    assert "pts" in str(r.p["q"].sharding)
    txt = f.lower(p0s).compile().as_text()
    assert "all-reduce" in txt


@pytest.mark.parametrize("cap_frac", [4, 64])
def test_batched_compaction_exact(cap_frac):
    """Straggler compaction returns bit-identical results to the plain
    batched solve — including when the capacity guess is too small and the
    safety-net full pass must finish the leftovers (cap_frac=64)."""
    from libdogleg_tpu.parallel.batched import batched_optimize_compacted
    batch = 128
    meas = jax.vmap(lambda k: sp.simulate(k))(
        jax.random.split(jax.random.PRNGKey(0), batch))
    p0s = jax.vmap(lambda k: sp.initial_state(k))(
        jax.random.split(jax.random.PRNGKey(1), batch))
    gx, gy = sp.make_grid()

    def products(p, m):
        x = sp.model(p, gx, gy) - m
        J = sp.jacobian(p, gx, gy)
        return solve_products.__globals__["Products"](
            norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)

    prm = DoglegParameters(max_iterations=8)
    r_ref = batched_optimize(products, p0s, prm, problem_data=meas)
    r = batched_optimize_compacted(products, p0s, prm, problem_data=meas,
                                   phase1_attempts=3,
                                   compact_capacity=batch // cap_frac)
    np.testing.assert_allclose(np.asarray(r.p), np.asarray(r_ref.p),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_array_equal(np.asarray(r.step_count),
                                  np.asarray(r_ref.step_count))
    np.testing.assert_array_equal(np.asarray(r.reason),
                                  np.asarray(r_ref.reason))


def test_batched_compaction_sharded():
    """Compaction COMPOSED with the dp mesh (the pod deployment shape):
    bit-identical to both the unsharded compacted run and the plain
    sharded batched solve, results carry the dp sharding, and the
    compact straggler buffer is itself dp-sharded (no redundant
    replicated straggler pass)."""
    from jax.sharding import PartitionSpec as P

    from libdogleg_tpu.parallel.batched import batched_optimize_compacted
    batch = 128
    mesh = make_mesh(("dp",))
    meas = jax.vmap(lambda k: sp.simulate(k))(
        jax.random.split(jax.random.PRNGKey(0), batch))
    p0s = jax.vmap(lambda k: sp.initial_state(k))(
        jax.random.split(jax.random.PRNGKey(1), batch))
    gx, gy = sp.make_grid()

    def products(p, m):
        x = sp.model(p, gx, gy) - m
        J = sp.jacobian(p, gx, gy)
        return solve_products.__globals__["Products"](
            norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)

    prm = DoglegParameters(max_iterations=8)
    r_plain = batched_optimize(products, p0s, prm, problem_data=meas,
                               mesh=mesh)
    r_unsharded = batched_optimize_compacted(products, p0s, prm,
                                             problem_data=meas)
    p0s_s, meas_s = shard_batch((p0s, meas), mesh)
    r = batched_optimize_compacted(products, p0s_s, prm,
                                   problem_data=meas_s, mesh=mesh)
    # sharded and unsharded programs are different XLA compilations
    # (different fusion/reduction orders), so agreement is to roundoff,
    # not bitwise; decisions (step counts, stop reasons) must be identical
    for ref in (r_unsharded, r_plain):
        np.testing.assert_allclose(np.asarray(r.p), np.asarray(ref.p),
                                   rtol=1e-12, atol=1e-13)
        np.testing.assert_array_equal(np.asarray(r.step_count),
                                      np.asarray(ref.step_count))
        np.testing.assert_array_equal(np.asarray(r.reason),
                                      np.asarray(ref.reason))
    assert r.p.sharding.spec == P("dp")


def test_scaling_retention_gate():
    """Partitioning-overhead regression gate (BASELINE.md's >= 80%
    scaling-efficiency row, in its single-host measurable form): with
    total work fixed, sharding the batch over the 8-virtual-device mesh
    must retain >= 0.8 of single-device throughput — a hidden
    cross-device serialization or communication in the batched path
    fails this. Runs bench_scaling.py reduced (1->2 devices, batch 1024)
    in a subprocess so its platform/device setup cannot disturb this
    process's backend."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ, SCALING_BATCH="1024", SCALING_DEVICES="2",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)   # bench_scaling sets its own device count
    out = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__), "..",
                                      "bench_scaling.py")],
        env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["metric"] == "partitioning_retention_worst"
    assert last["value"] >= 0.8, out.stdout
    assert last["passes"]


def test_measurement_sharded_sparse_jtj():
    """Row-sharded measurements + block-sparse JtJ psum + supernodal
    Cholesky: the sharding x sparsity composition, exact vs the
    single-device sparse solve on the grid MRF."""
    from libdogleg_tpu.models import grid_mrf
    from libdogleg_tpu.ops.bcsr import jtj_lower_schedule
    from libdogleg_tpu.parallel.sharded import (
        MeasurementShardedSparseProblem)
    from libdogleg_tpu.parallel import make_mesh

    m = grid_mrf.make_grid_mrf(width=8, height=4, block_size=2)
    base = m.problem(jtj="dense")
    # single-device oracle through the simplicial sparse path
    sp_prob = m.problem(jtj="sparse")
    r_ref = optimize(sp_prob, jnp.zeros(m.nstate), DoglegParameters(),
                     newton_solver=sp_prob.default_newton_solver())

    # shard the measurement rows: both residual terms have the measurement
    # axis leading; evaluate dense J rows per shard via the densified f
    sched = jtj_lower_schedule(m.structure)
    nmeas = m.structure.nmeas
    # dense J is static in this linear model: precompute global, shard rows
    _, Jd = base.full(jnp.zeros(m.nstate))
    x0, _ = base.full(jnp.zeros(m.nstate))
    target = -(x0 - Jd @ jnp.zeros(m.nstate))  # x = Jd p - target

    def f_shard(p, data):
        J_rows, t_rows = data
        return J_rows @ p - t_rows, J_rows

    mesh = make_mesh(("meas",), shape=(8,))
    prob = MeasurementShardedSparseProblem(
        f=f_shard, data=(Jd, target), pattern_rows=sched.rows,
        pattern_cols=sched.cols, b=m.block_size, mesh=mesh,
        amalgamate=2)
    r = jax.jit(lambda q: solve_products(
        prob.products, q, DoglegParameters(),
        newton_solver=prob.newton_solver()))(jnp.zeros(m.nstate))
    np.testing.assert_allclose(np.asarray(r.p), np.asarray(r_ref.p),
                               rtol=1e-9, atol=1e-11)
    assert int(r.step_count) == int(r_ref.step_count)


def test_sparse_visibility_ba_point_sharded():
    """Distributed sparse-visibility BA: the SparseWSchurJtJ leaves are
    point-major, so point data/states shard over a 'pts' mesh axis with
    the camera block replicated; the one-hot camera reductions become
    partial sums + all-reduce under GSPMD, and the result matches the
    single-device solve."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from libdogleg_tpu.models import pinhole_ba
    from libdogleg_tpu.parallel import make_mesh

    ba = pinhole_ba.make_synthetic_sparse(seed=2, ncam=8, npts=160,
                                          k_obs=3)
    p0 = ba.p0(jax.random.PRNGKey(4), jitter=0.02)
    ns = ba.newton_solver()
    r_ref = jax.jit(lambda pc, pq: solve_products(
        ba.products, {"c": pc, "q": pq}, DoglegParameters(),
        newton_solver=ns))(p0["c"], p0["q"])

    mesh = make_mesh(("pts",), shape=(8,))
    shp = NamedSharding(mesh, P("pts"))
    rep = NamedSharding(mesh, P())
    ba_s = ba._replace(cam_of=jax.device_put(ba.cam_of, shp),
                       obs=jax.device_put(ba.obs, shp),
                       pts_prior=jax.device_put(ba.pts_prior, shp))
    p0_s = {"c": jax.device_put(p0["c"], rep),
            "q": jax.device_put(p0["q"], shp)}
    f = jax.jit(lambda p: solve_products(ba_s.products, p,
                                         DoglegParameters(),
                                         newton_solver=ns))
    r = f(p0_s)
    assert int(r.step_count) == int(r_ref.step_count)
    np.testing.assert_allclose(np.asarray(r.p["q"]),
                               np.asarray(r_ref.p["q"]),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(r.p["c"]),
                               np.asarray(r_ref.p["c"]),
                               rtol=1e-9, atol=1e-11)
    # the point states stay sharded and the program really distributed
    assert "pts" in str(r.p["q"].sharding)
    txt = f.lower(p0_s).compile().as_text()
    assert "all-reduce" in txt


def test_batched_layout_minor_exact():
    """layout="minor" (batch as the minor dim inside the loop) is
    decision-identical to the
    default leading layout; the public interface stays batch-leading."""
    batch = 64
    meas = jax.vmap(lambda k: sp.simulate(k))(
        jax.random.split(jax.random.PRNGKey(0), batch))
    p0s = jax.vmap(lambda k: sp.initial_state(k))(
        jax.random.split(jax.random.PRNGKey(1), batch))
    gx, gy = sp.make_grid()

    def products(p, m):
        x = sp.model(p, gx, gy) - m
        J = sp.jacobian(p, gx, gy)
        return solve_products.__globals__["Products"](
            norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)

    prm = DoglegParameters(max_iterations=8)
    r0 = batched_optimize(products, p0s, prm, problem_data=meas)
    r1 = batched_optimize(products, p0s, prm, problem_data=meas,
                          layout="minor")
    np.testing.assert_array_equal(np.asarray(r0.step_count),
                                  np.asarray(r1.step_count))
    np.testing.assert_array_equal(np.asarray(r0.reason),
                                  np.asarray(r1.reason))
    np.testing.assert_allclose(np.asarray(r0.p), np.asarray(r1.p),
                               rtol=1e-12, atol=1e-13)
    assert r1.p.shape == (batch, sp.NSTATE)


def test_compacted_layout_minor_exact():
    """Compaction pipeline under layout="minor": identical decisions and
    results to the leading layout, including the straggler gather/scatter
    on the minor axis."""
    from libdogleg_tpu.parallel.batched import batched_optimize_compacted
    batch = 96
    meas = jax.vmap(lambda k: sp.simulate(k))(
        jax.random.split(jax.random.PRNGKey(0), batch))
    p0s = jax.vmap(lambda k: sp.initial_state(k))(
        jax.random.split(jax.random.PRNGKey(1), batch))
    gx, gy = sp.make_grid()

    def products(p, m):
        x = sp.model(p, gx, gy) - m
        J = sp.jacobian(p, gx, gy)
        return solve_products.__globals__["Products"](
            norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)

    prm = DoglegParameters(max_iterations=8)
    r0 = batched_optimize_compacted(products, p0s, prm, problem_data=meas)
    r1 = batched_optimize_compacted(products, p0s, prm, problem_data=meas,
                                    layout="minor")
    np.testing.assert_array_equal(np.asarray(r0.step_count),
                                  np.asarray(r1.step_count))
    np.testing.assert_array_equal(np.asarray(r0.reason),
                                  np.asarray(r1.reason))
    np.testing.assert_allclose(np.asarray(r0.p), np.asarray(r1.p),
                               rtol=1e-12, atol=1e-13)


def _batch_problem(batch, seed0=0, seed1=1):
    meas = jax.vmap(lambda k: sp.simulate(k))(
        jax.random.split(jax.random.PRNGKey(seed0), batch))
    p0s = jax.vmap(lambda k: sp.initial_state(k))(
        jax.random.split(jax.random.PRNGKey(seed1), batch))
    gx, gy = sp.make_grid()

    def products(p, m):
        x = sp.model(p, gx, gy) - m
        J = sp.jacobian(p, gx, gy)
        return solve_products.__globals__["Products"](
            norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)

    return products, p0s, meas


def test_layout_validated():
    """A misspelled layout raises instead of silently measuring the
    leading layout (advisor round-3 finding)."""
    from libdogleg_tpu.parallel.batched import batched_optimize_compacted
    products, p0s, meas = _batch_problem(8)
    with pytest.raises(ValueError, match="layout"):
        batched_optimize(products, p0s, problem_data=meas, layout="Minor")
    with pytest.raises(ValueError, match="layout"):
        batched_optimize_compacted(products, p0s, problem_data=meas,
                                   layout="trailing")


def test_batched_layout_minor_sharded():
    """layout="minor" COMPOSED with the dp mesh: the boundary stays
    batch-leading/dp-sharded while the internal carry is batch-minor.
    Decision-identical to the unsharded minor run."""
    from jax.sharding import PartitionSpec as P
    products, p0s, meas = _batch_problem(128)
    mesh = make_mesh(("dp",))
    prm = DoglegParameters(max_iterations=8)
    r_ref = batched_optimize(products, p0s, prm, problem_data=meas,
                             layout="minor")
    p0s_s, meas_s = shard_batch((p0s, meas), mesh)
    r = batched_optimize(products, p0s_s, prm, problem_data=meas_s,
                         mesh=mesh, layout="minor")
    np.testing.assert_array_equal(np.asarray(r.step_count),
                                  np.asarray(r_ref.step_count))
    np.testing.assert_array_equal(np.asarray(r.reason),
                                  np.asarray(r_ref.reason))
    np.testing.assert_allclose(np.asarray(r.p), np.asarray(r_ref.p),
                               rtol=1e-12, atol=1e-13)
    assert r.p.sharding.spec == P("dp")


def test_compacted_layout_minor_sharded():
    """Compaction x mesh x layout="minor". Decisions identical to the leading
    sharded run; results dp-sharded at the boundary."""
    from jax.sharding import PartitionSpec as P

    from libdogleg_tpu.parallel.batched import batched_optimize_compacted
    products, p0s, meas = _batch_problem(128)
    mesh = make_mesh(("dp",))
    prm = DoglegParameters(max_iterations=8)
    r_ref = batched_optimize_compacted(products, p0s, prm,
                                       problem_data=meas)
    p0s_s, meas_s = shard_batch((p0s, meas), mesh)
    r = batched_optimize_compacted(products, p0s_s, prm,
                                   problem_data=meas_s, mesh=mesh,
                                   layout="minor")
    np.testing.assert_array_equal(np.asarray(r.step_count),
                                  np.asarray(r_ref.step_count))
    np.testing.assert_array_equal(np.asarray(r.reason),
                                  np.asarray(r_ref.reason))
    np.testing.assert_allclose(np.asarray(r.p), np.asarray(r_ref.p),
                               rtol=1e-12, atol=1e-13)
    assert r.p.sharding.spec == P("dp")


@pytest.mark.parametrize("layout", ["leading", "minor"])
def test_batched_record_history(layout):
    """record_history through the batched production entry points: every
    element carries its own vnlog-schema History, identical to a lone
    solve_products run of the same element, and renders to vnlog text."""
    from libdogleg_tpu.diagnostics import format_vnlog
    products, p0s, meas = _batch_problem(32)
    prm = DoglegParameters(max_iterations=8)
    r = batched_optimize(products, p0s, prm, problem_data=meas,
                         layout=layout, record_history=True,
                         history_capacity=32)
    assert r.history is not None
    assert r.history.iteration.shape == (32, 32)
    i = 3
    lone = solve_products(
        lambda p: products(p, jax.tree_util.tree_map(lambda a: a[i], meas)),
        p0s[i], prm, record_history=True, history_capacity=32)
    # vmapped and lone solves are different XLA compilations (different
    # fusion/reduction orders): agreement to roundoff, not bitwise — and
    # the improvement/rho columns are (ratios of) differences of
    # near-equal costs, whose roundoff is ~1e-6 relative. This test
    # checks the PLUMBING (right rows, right element); numeric parity of
    # the history columns is pinned bitwise in test_diagnostics_vnlog.
    for got, ref in zip(r.history, lone.history):
        np.testing.assert_allclose(np.asarray(got[i]), np.asarray(ref),
                                   rtol=1e-5, atol=1e-10)
    hist_i = jax.tree_util.tree_map(lambda a: a[i], r.history)
    txt = format_vnlog(hist_i, int(r.n_attempts[i]))
    # one legend line + one row per attempt
    assert len(txt.splitlines()) == int(r.n_attempts[i]) + 1


def test_compacted_record_history():
    """record_history through compaction: the gather/scatter carries the
    history buffers, re-run lanes stay frozen, and the rows match the
    plain batched run exactly."""
    from libdogleg_tpu.parallel.batched import batched_optimize_compacted
    products, p0s, meas = _batch_problem(64)
    prm = DoglegParameters(max_iterations=8)
    r_ref = batched_optimize(products, p0s, prm, problem_data=meas,
                             record_history=True, history_capacity=32)
    r = batched_optimize_compacted(products, p0s, prm, problem_data=meas,
                                   record_history=True,
                                   history_capacity=32)
    assert r.history is not None
    for got, ref in zip(r.history, r_ref.history):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-12, atol=0)


def test_wavefront_unroll_exact():
    """wavefront_unroll composes the attempt body k times per while_loop
    wavefront (amortizing the carry round-trip through device memory);
    the body freezes done lanes, so results must be bit-identical in
    both batched entry points, including n_attempts."""
    from libdogleg_tpu.parallel.batched import batched_optimize_compacted
    batch = 64
    meas = jax.vmap(lambda k: sp.simulate(k))(
        jax.random.split(jax.random.PRNGKey(0), batch))
    p0s = jax.vmap(lambda k: sp.initial_state(k))(
        jax.random.split(jax.random.PRNGKey(1), batch))
    gx, gy = sp.make_grid()

    def products(p, m):
        x = sp.model(p, gx, gy) - m
        J = sp.jacobian(p, gx, gy)
        return solve_products.__globals__["Products"](
            norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)

    prm = DoglegParameters(max_iterations=8)
    for entry, kwargs in ((batched_optimize, {}),
                          (batched_optimize_compacted, {}),
                          (batched_optimize_compacted,
                           {"layout": "minor"})):
        r0 = entry(products, p0s, prm, problem_data=meas, **kwargs)
        r3 = entry(products, p0s, prm, problem_data=meas,
                   wavefront_unroll=3, **kwargs)
        np.testing.assert_array_equal(np.asarray(r0.step_count),
                                      np.asarray(r3.step_count))
        np.testing.assert_array_equal(np.asarray(r0.n_attempts),
                                      np.asarray(r3.n_attempts))
        np.testing.assert_array_equal(np.asarray(r0.reason),
                                      np.asarray(r3.reason))
        np.testing.assert_array_equal(np.asarray(r0.p), np.asarray(r3.p))
