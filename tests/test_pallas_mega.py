"""Whole-solve megakernel (ops/pallas_mega.py) vs the XLA batched path.

The kernel runs in the Pallas interpreter here; its Triton lowering is
checked without a GPU by tracing the kernel body (power-of-two values, no
slicing) and by lowering the whole call for the cuda platform.

In f64 the two programs' roundoff sits far below every solver threshold,
so decisions (step counts, stop reasons, attempt counts) must match
EXACTLY; in f32 knife-edge threshold ties may flip between different
reduction orders, so the f32 test asserts near-total decision agreement
plus cost/parameter agreement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import libdogleg_tpu.models.quadratic_surface as sp
from libdogleg_tpu import DoglegParameters, StopReason
from libdogleg_tpu.ops.pallas_mega import megakernel_optimize
from libdogleg_tpu.parallel.batched import batched_optimize
from libdogleg_tpu.solver import Products

RELAXED = DoglegParameters(max_iterations=10, Jt_x_threshold=1e-3,
                           update_threshold=1e-5, trustregion_threshold=1e-5)


def _setup(dtype, batch):
    gx, gy = sp.make_grid(dtype)
    meas = jax.vmap(lambda k: sp.simulate(k, dtype=dtype))(
        jax.random.split(jax.random.PRNGKey(0), batch))
    p0s = jax.vmap(lambda k: sp.initial_state(k, dtype=dtype))(
        jax.random.split(jax.random.PRNGKey(1), batch))

    def products(p, m):
        x = sp.model(p, gx, gy) - m
        J = sp.jacobian(p, gx, gy)
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)

    return meas, p0s, products


def _mega(p0s, meas, prm, **kw):
    kw.setdefault("block_batch", 32)
    return megakernel_optimize(sp.products_lanes, p0s, prm,
                               problem_data=(meas,), interpret=True, **kw)


def _assert_decisions_equal(r, r_ref):
    for field in ("step_count", "reason", "n_attempts"):
        np.testing.assert_array_equal(np.asarray(getattr(r, field)),
                                      np.asarray(getattr(r_ref, field)))


def test_megakernel_f64_decision_exact():
    meas, p0s, products = _setup(jnp.float64, 64)
    prm = DoglegParameters()
    r_ref = batched_optimize(products, p0s, prm, problem_data=meas)
    r = _mega(p0s, meas, prm)
    _assert_decisions_equal(r, r_ref)
    np.testing.assert_allclose(np.asarray(r.p), np.asarray(r_ref.p),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(r.trustregion),
                               np.asarray(r_ref.trustregion), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(r.JtJ), np.asarray(r_ref.JtJ),
                               rtol=1e-10, atol=1e-10)


def test_megakernel_f32_benchmark_config():
    """The benchmark stopping rule in f32: decisions may flip on
    threshold ties between reduction orders, but costs and parameters
    must agree."""
    meas, p0s, products = _setup(jnp.float32, 128)
    r_ref = batched_optimize(products, p0s, RELAXED, problem_data=meas)
    r = _mega(p0s, meas, RELAXED)
    same = (np.asarray(r.step_count) == np.asarray(r_ref.step_count)) \
        & (np.asarray(r.n_attempts) == np.asarray(r_ref.n_attempts))
    assert np.mean(same) > 0.85
    np.testing.assert_allclose(np.asarray(r.norm2_x),
                               np.asarray(r_ref.norm2_x),
                               rtol=1e-2, atol=1e-4)
    np.testing.assert_allclose(np.asarray(r.p)[same],
                               np.asarray(r_ref.p)[same],
                               rtol=1e-2, atol=1e-3)
    # the benchmark's own acceptance gate (sample.c:443-457 budget)
    err = np.abs(np.asarray(r.p) - sp.P_TRUE[None])
    assert np.mean(np.all(err < 0.2, axis=1)) > 0.95


def test_megakernel_initial_convergence():
    """Criterion 1 on the initial point: starting at the optimum
    terminates with zero attempts (reference dogleg.c:1364-1371)."""
    dtype = jnp.float64
    gx, gy = sp.make_grid(dtype)
    meas0 = jnp.broadcast_to(sp.model(jnp.asarray(sp.P_TRUE, dtype),
                                      gx, gy), (32, sp.NMEAS))
    p0s = jnp.broadcast_to(jnp.asarray(sp.P_TRUE, dtype), (32, sp.NSTATE))
    r = _mega(p0s, meas0, DoglegParameters())
    assert np.all(np.asarray(r.reason) == int(StopReason.GRADIENT_CONVERGED))
    assert np.all(np.asarray(r.n_attempts) == 0)


def _singular_products(p, meas):
    """A 2-state problem whose second parameter is unobserved, so JtJ is
    exactly singular."""
    r0 = p[0] - meas[0]
    zero = jnp.zeros_like(r0)
    one = jnp.ones_like(r0)
    return r0 * r0, [r0, zero], [[one], [zero, zero]]


def test_megakernel_lambda_escalation_and_failure():
    """Singular JtJ lanes: the in-kernel permanent escalating lambda
    (reference dogleg.c:670-676) converges them; a zero escalation
    budget reports FACTORIZATION_FAILED."""
    dtype = jnp.float64
    meas = jnp.linspace(-1.0, 1.0, 32, dtype=dtype)[:, None]
    p0s = jnp.full((32, 2), 3.0, dtype)
    r = megakernel_optimize(_singular_products, p0s, DoglegParameters(),
                            problem_data=(meas,), block_batch=32,
                            interpret=True)
    assert np.all(np.asarray(r.reason) == int(StopReason.GRADIENT_CONVERGED))
    assert np.all(np.asarray(r.lam) > 0.0)  # escalated off zero
    np.testing.assert_allclose(np.asarray(r.p[:, 0]),
                               np.asarray(meas[:, 0]), atol=1e-6)

    r_fail = megakernel_optimize(
        _singular_products, p0s, DoglegParameters(lambda_max_tries=0),
        problem_data=(meas,), block_batch=32, interpret=True)
    assert np.all(np.asarray(r_fail.reason)
                  == int(StopReason.FACTORIZATION_FAILED))


def test_megakernel_batch_not_divisible_raises():
    meas, p0s, _ = _setup(jnp.float32, 40)
    with pytest.raises(ValueError, match="divisible"):
        _mega(p0s, meas, DoglegParameters())


def test_megakernel_block_must_be_power_of_two():
    meas, p0s, _ = _setup(jnp.float32, 48)
    with pytest.raises(ValueError, match="power of two"):
        _mega(p0s, meas, DoglegParameters(), block_batch=48)


def test_megakernel_factored_config3f():
    """The factored (sufficient-statistics) lane products match
    FactoredBasisProblem.products, and the in-kernel solve is
    decision-identical to the XLA factored path in f32 (the compensated
    arithmetic leaves no threshold-scale roundoff to flip on)."""
    dtype = jnp.float32
    meas, p0s, _ = _setup(dtype, 64)
    G_pair = sp.gram_pair(dtype)
    stats = jax.vmap(sp.factored_statistics)(meas)
    lanes = sp.factored_products_lanes(G_pair)

    i = slice(5, 6)
    pr_ref = sp.factored_products(p0s[5], tuple(s[5] for s in stats),
                                  G_pair)
    n2, jtx, jtj = lanes([p0s[i, k] for k in range(sp.NSTATE)],
                         *(s[i].reshape(1, -1).T for s in stats))
    np.testing.assert_allclose(float(n2[0]), float(pr_ref.norm2_x),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray([g[0] for g in jtx]),
                               np.asarray(pr_ref.Jt_x), rtol=1e-6,
                               atol=1e-8)
    for a in range(sp.NSTATE):
        np.testing.assert_allclose(
            np.asarray([jtj[a][b][0] for b in range(a + 1)]),
            np.asarray(pr_ref.JtJ[a, :a + 1]), rtol=1e-5)

    r_ref = batched_optimize(
        lambda pp, st: sp.factored_products(pp, st, G_pair),
        p0s, RELAXED, problem_data=stats)
    r = megakernel_optimize(lanes, p0s, RELAXED, problem_data=stats,
                            block_batch=32, interpret=True)
    np.testing.assert_array_equal(np.asarray(r.step_count),
                                  np.asarray(r_ref.step_count))
    np.testing.assert_array_equal(np.asarray(r.reason),
                                  np.asarray(r_ref.reason))
    err = np.abs(np.asarray(r.p) - sp.P_TRUE[None])
    assert np.mean(np.all(err < 0.2, axis=1)) == 1.0


def test_megakernel_sharded():
    """megakernel x mesh: shard_map runs the kernel per device on its
    local batch slice; results identical to the unsharded kernel and
    dp-sharded at the boundary."""
    from jax.sharding import PartitionSpec as P

    from libdogleg_tpu.parallel import make_mesh
    meas, p0s, _ = _setup(jnp.float64, 128)
    mesh = make_mesh(("dp",), shape=(4,))
    prm = DoglegParameters()
    r_ref = _mega(p0s, meas, prm)
    r = _mega(p0s, meas, prm, mesh=mesh)
    _assert_decisions_equal(r, r_ref)
    np.testing.assert_allclose(np.asarray(r.p), np.asarray(r_ref.p),
                               rtol=1e-12, atol=1e-14)
    assert r.p.sharding.spec == P("dp")


def test_megakernel_meas_sharded_staged():
    """megakernel x MEAS axis (dp x meas mesh): the measurement axis is
    not sharded inside the kernel, so the composition is staged — a
    meas-sharded XLA stage reduces each instance's rows to sufficient
    statistics (psum over 'meas'; exact because h = B^T m and m.m are
    sums over rows, reference dogleg.h:32-45), feeding the dp-sharded
    factored megakernel."""
    from jax.sharding import PartitionSpec as P

    from libdogleg_tpu.parallel import make_mesh
    from libdogleg_tpu.problems import FactoredBasisProblem

    dtype = jnp.float32
    meas, p0s, _ = _setup(dtype, 64)
    gx, gy = sp.make_grid(dtype)
    mesh2 = make_mesh(("dp", "meas"), shape=(2, 4))

    def stats_shard(meas_blk, B_blk):
        st = jax.vmap(lambda m: FactoredBasisProblem.statistics(B_blk, m))(
            meas_blk)
        return tuple(jax.lax.psum(t, "meas") for t in st)

    stats = jax.jit(jax.shard_map(
        stats_shard, mesh=mesh2,
        in_specs=(P("dp", "meas"), P("meas", None)),
        out_specs=(P("dp"),) * 4))(meas, sp.basis(gx, gy))
    ref = jax.vmap(sp.factored_statistics)(meas)
    # the psum of (hi, lo) pairs preserves the pair SUM
    for k in (0, 2):
        np.testing.assert_allclose(
            np.asarray(stats[k]) + np.asarray(stats[k + 1]),
            np.asarray(ref[k]) + np.asarray(ref[k + 1]),
            rtol=1e-5, atol=1e-5)

    r = megakernel_optimize(
        sp.factored_products_lanes(sp.gram_pair(dtype)), p0s, RELAXED,
        problem_data=stats, block_batch=8,
        mesh=make_mesh(("dp",), shape=(8,)), interpret=True)
    err = np.abs(np.asarray(r.p) - sp.P_TRUE[None])
    assert float(np.mean(np.all(err < 0.2, axis=1))) >= 0.98
    assert np.all(np.asarray(r.reason) > 0)


def test_megakernel_n3_curve_fit():
    """Generality in n: the exponential curve-fit model (n=3) through the
    same kernel, with the in-kernel transcendental (exp) in the
    products."""
    from libdogleg_tpu.models import curve_fit
    from libdogleg_tpu.ops.pallas_mega import lane_sum

    dtype = jnp.float64
    batch = 64
    meas = jax.vmap(lambda k: curve_fit.simulate(k, dtype=dtype))(
        jax.random.split(jax.random.PRNGKey(0), batch))
    p0s = jax.vmap(lambda k: curve_fit.initial_state(k, dtype=dtype))(
        jax.random.split(jax.random.PRNGKey(1), batch))
    t = np.asarray(curve_fit.make_t(meas.shape[1], dtype))

    def lanes(p, m):
        rows = []
        for r, tr in enumerate(t):
            e = jnp.exp(p[1] * tr)
            x = p[0] * e + p[2] - m[r]
            rows.append((x, (e, p[0] * tr * e, jnp.ones_like(x))))
        J = [[Jr[a] for _, Jr in rows] for a in range(3)]
        x = [xr for xr, _ in rows]
        return (lane_sum(v * v for v in x),
                [lane_sum(a * b for a, b in zip(J[k], x))
                 for k in range(3)],
                [[lane_sum(a * b for a, b in zip(J[i], J[j]))
                  for j in range(i + 1)] for i in range(3)])

    def products(p, mm):
        x = curve_fit.model(p, jnp.asarray(t)) - mm
        J = curve_fit.jacobian(p, jnp.asarray(t))
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)

    prm = DoglegParameters()
    r_ref = batched_optimize(products, p0s, prm, problem_data=meas)
    r = megakernel_optimize(lanes, p0s, prm, problem_data=(meas,),
                            block_batch=32, interpret=True)
    np.testing.assert_array_equal(np.asarray(r.step_count),
                                  np.asarray(r_ref.step_count))
    np.testing.assert_array_equal(np.asarray(r.reason),
                                  np.asarray(r_ref.reason))
    conv = np.isin(np.asarray(r_ref.reason),
                   [int(StopReason.GRADIENT_CONVERGED),
                    int(StopReason.SMALL_STEP)])
    assert conv.mean() >= 0.4
    np.testing.assert_allclose(np.asarray(r.p)[conv],
                               np.asarray(r_ref.p)[conv],
                               rtol=1e-9, atol=1e-11)


def _kernel_jaxpr(lanes, p0s, data, **kw):
    """The kernel body's jaxpr, as pallas_call holds it."""
    closed = jax.make_jaxpr(lambda q, *d: megakernel_optimize(
        lanes, q, RELAXED, problem_data=d, **kw))(p0s, *data)
    calls = [e for e in _eqns(closed.jaxpr)
             if e.primitive.name == "pallas_call"]
    assert len(calls) == 1
    return calls[0].params["jaxpr"]


def _eqns(jaxpr):
    for e in jaxpr.eqns:
        yield e
        for v in e.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", None)
                if inner is not None:
                    yield from _eqns(getattr(inner, "jaxpr", inner))
                elif hasattr(sub, "eqns"):
                    yield from _eqns(sub)


@pytest.mark.parametrize("form", ["general", "factored"])
def test_kernel_body_has_only_power_of_two_values(form):
    """What Triton refuses and the interpreter does not check: a value
    whose size is not a power of two, or a value slice or gather."""
    meas, p0s, _ = _setup(jnp.float32, 64)
    if form == "general":
        lanes, data = sp.products_lanes, (meas,)
    else:
        lanes = sp.factored_products_lanes(sp.gram_pair(jnp.float32))
        data = jax.vmap(sp.factored_statistics)(meas)
    body = _kernel_jaxpr(lanes, p0s, data, block_batch=64)
    refs = set(body.invars)
    for e in _eqns(body):
        assert e.primitive.name not in ("slice", "gather", "dynamic_slice",
                                        "dynamic_update_slice"), e
        for v in e.outvars:
            if v in refs or not hasattr(v.aval, "shape"):
                continue
            size = int(np.prod(v.aval.shape))
            assert size & (size - 1) == 0, (e.primitive, v.aval)


@pytest.mark.parametrize("form", ["general", "factored"])
def test_kernel_lowers_to_triton(form):
    """The whole call lowers for the cuda platform: the Pallas-to-Triton
    lowering runs here; only the Triton compile needs the card."""
    meas, p0s, _ = _setup(jnp.float32, 128)
    if form == "general":
        lanes, data = sp.products_lanes, (meas,)
    else:
        lanes = sp.factored_products_lanes(sp.gram_pair(jnp.float32))
        data = jax.vmap(sp.factored_statistics)(meas)
    f = jax.jit(lambda q, *d: megakernel_optimize(
        lanes, q, RELAXED, problem_data=d, block_batch=64))
    text = f.trace(p0s, *data).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "dogleg_megakernel" in text
