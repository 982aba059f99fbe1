"""Megakernel selection and the lane interpreter (parallel/mega_auto.py).

`batched_optimize` hands a batch to the whole-solve kernel on a GPU,
adapting the user's ORDINARY per-element products function to lane form.
Here the adapted kernel runs in the Pallas interpreter (plan_megakernel's
interpret=True) against the XLA path: f64 decisions must match exactly;
f32 may flip knife-edge threshold ties between reduction orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import libdogleg_tpu.models.quadratic_surface as sp
from libdogleg_tpu import DoglegParameters
from libdogleg_tpu.parallel import mega_auto
from libdogleg_tpu.parallel.batched import (batched_optimize,
                                            batched_optimize_compacted)
from libdogleg_tpu.parallel.mega_auto import (_covered, trace_products,
                                              adapt_products_lanes,
                                              plan_megakernel)
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
        # closes over gx, gy: constants folded into the kernel
        x = sp.model(p, gx, gy) - m
        J = sp.jacobian(p, gx, gy)
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)

    return meas, p0s, products


def _factored(dtype, batch):
    meas, p0s, _ = _setup(dtype, batch)
    G_pair = sp.gram_pair(dtype)
    stats = jax.vmap(sp.factored_statistics)(meas)
    return stats, p0s, lambda p, st: sp.factored_products(p, st, G_pair)


def _interpreted(products, p0s, prm, **kw):
    return plan_megakernel(products, p0s, prm, forced=True, interpret=True,
                           **kw)()


def _assert_decisions_equal(r, r_ref):
    for field in ("step_count", "reason", "n_attempts"):
        np.testing.assert_array_equal(np.asarray(getattr(r, field)),
                                      np.asarray(getattr(r_ref, field)))


def test_forced_f64_decision_exact():
    meas, p0s, products = _setup(jnp.float64, 64)
    prm = DoglegParameters()
    r_ref = batched_optimize(products, p0s, prm, problem_data=meas,
                             use_megakernel=False)
    r = _interpreted(products, p0s, prm, problem_data=meas)
    _assert_decisions_equal(r, r_ref)
    np.testing.assert_allclose(np.asarray(r.p), np.asarray(r_ref.p),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(r.JtJ), np.asarray(r_ref.JtJ),
                               rtol=1e-10, atol=1e-10)


def test_forced_padding_non_multiple_batch():
    """B=40 is no multiple of the lane tile: the plan pads with copies of
    element 0 and slices back; results must be exact and full-size."""
    stats, p0s, products = _factored(jnp.float32, 40)
    r_ref = batched_optimize(products, p0s, RELAXED, problem_data=stats,
                             use_megakernel=False)
    r = _interpreted(products, p0s, RELAXED, problem_data=stats)
    assert r.p.shape == (40, sp.NSTATE)
    _assert_decisions_equal(r, r_ref)


def test_forced_shared_problem_data_none():
    """products_fn with NO problem_data (shared measurements, distinct
    starts): the measurements become constants of the kernel."""
    meas, p0s, products = _setup(jnp.float64, 64)
    m0 = meas[0]
    shared = lambda p: products(p, m0)
    prm = DoglegParameters()
    r_ref = batched_optimize(shared, p0s, prm, use_megakernel=False)
    r = _interpreted(shared, p0s, prm)
    _assert_decisions_equal(r, r_ref)
    np.testing.assert_allclose(np.asarray(r.p), np.asarray(r_ref.p),
                               rtol=1e-10, atol=1e-12)


def test_forced_mesh_composition():
    """The plan composes with the dp mesh: each device runs the kernel on
    its local slice, zero communication."""
    from jax.sharding import PartitionSpec as P

    from libdogleg_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(("dp",), shape=(4,))
    stats, p0s, products = _factored(jnp.float32, 4 * 64)
    r_ref = batched_optimize(products, p0s, RELAXED, problem_data=stats,
                             use_megakernel=False)
    r = _interpreted(products, p0s, RELAXED, problem_data=stats, mesh=mesh)
    _assert_decisions_equal(r, r_ref)
    assert r.p.sharding.spec == P("dp")


def test_forced_under_outer_jit():
    """A caller may jit around the plan: the kernel is traced inline and
    decisions are identical to the eager call."""
    stats, p0s, products = _factored(jnp.float32, 64)
    r_eager = _interpreted(products, p0s, RELAXED, problem_data=stats)
    r_jit = jax.jit(lambda q, st: _interpreted(
        products, q, RELAXED, problem_data=st))(p0s, stats)
    _assert_decisions_equal(r_jit, r_eager)
    np.testing.assert_allclose(np.asarray(r_jit.p), np.asarray(r_eager.p),
                               rtol=1e-6, atol=1e-6)


def test_f32_near_total_agreement():
    meas, p0s, products = _setup(jnp.float32, 128)
    r_ref = batched_optimize(products, p0s, RELAXED, problem_data=meas,
                             use_megakernel=False)
    r = _interpreted(products, p0s, RELAXED, problem_data=meas)
    same = np.asarray(r.step_count) == np.asarray(r_ref.step_count)
    assert np.mean(same) > 0.85
    err = np.abs(np.asarray(r.p) - sp.P_TRUE[None])
    assert np.mean(np.all(err < 0.2, axis=1)) > 0.95


def test_auto_is_off_outside_regime():
    """plan_megakernel returns None where the kernel does not go: a CPU
    backend, big Nstate, float64, over-budget products. A small batch is
    in the regime (the kernel was faster at every batch measured)."""
    stats, p0s, products = _factored(jnp.float32, 2048)
    prm = DoglegParameters()
    # auto on the CPU backend: there is no kernel compiler
    assert plan_megakernel(products, p0s, prm, problem_data=stats) is None
    # no batch floor
    small = jax.tree_util.tree_map(lambda a: a[:16], stats)
    assert plan_megakernel(products, p0s[:16], prm, problem_data=small,
                           interpret=True) is not None
    # Nstate beyond the unroll cap
    big = jnp.zeros((2048, 32), jnp.float32)
    assert plan_megakernel(
        lambda p: Products(norm2_x=p @ p, Jt_x=p, JtJ=jnp.eye(32)),
        big, prm, interpret=True) is None


def test_lane_budget_declines_large_unrolls(monkeypatch):
    """Products whose unrolled lane code exceeds MAX_LANE_OPS stay on the
    XLA path (decided by tracing, before anything compiles)."""
    meas, p0s, products = _setup(jnp.float32, 1024)
    monkeypatch.setattr(mega_auto, "MAX_LANE_OPS", 100)
    assert plan_megakernel(products, p0s, RELAXED, problem_data=meas,
                           interpret=True) is None
    with pytest.raises(ValueError, match="MAX_LANE_OPS"):
        plan_megakernel(products, p0s, RELAXED, problem_data=meas,
                        forced=True, interpret=True)


def test_forced_on_cpu_backend_raises():
    """use_megakernel=True on a backend without the kernel is an error,
    never an interpreted run."""
    stats, p0s, products = _factored(jnp.float32, 64)
    with pytest.raises(ValueError, match="GPU"):
        batched_optimize(products, p0s, RELAXED, problem_data=stats,
                         use_megakernel=True)
    with pytest.raises(ValueError, match="GPU"):
        batched_optimize_compacted(products, p0s, RELAXED,
                                   problem_data=stats, use_megakernel=True)


def test_forced_errors_are_loud():
    meas, p0s, products = _setup(jnp.float32, 64)
    with pytest.raises(ValueError, match="record_history"):
        batched_optimize(products, p0s, problem_data=meas,
                         record_history=True, use_megakernel=True)

    def structured(p):
        return Products(norm2_x=p @ p, Jt_x=p,
                        JtJ={"diag": jnp.ones_like(p)})

    with pytest.raises(ValueError, match="dense"):
        plan_megakernel(structured, p0s, RELAXED, forced=True,
                        interpret=True)


def test_coverage_declines_loops():
    """A products function with a loop primitive is not covered; the
    sample products are."""
    meas, p0s, products = _setup(jnp.float32, 8)

    def looped(p, m):
        pr = products(p, m)
        return pr._replace(norm2_x=jax.lax.fori_loop(
            0, 2, lambda i, v: v * 1.0, pr.norm2_x))

    spec = jax.ShapeDtypeStruct((sp.NSTATE,), jnp.float32)
    mspec = jax.ShapeDtypeStruct((sp.NMEAS,), jnp.float32)
    assert _covered(trace_products(products, spec, mspec)[0].jaxpr)
    assert not _covered(trace_products(looped, spec, mspec)[0].jaxpr)


@pytest.mark.parametrize("form", ["general", "factored"])
def test_adapter_reproduces_products(form):
    """The lane form evaluates the per-element products exactly: the
    general form (constants folded, dot_general unrolled) and the
    factored form (scatter, gather, pad and concatenate of constants and
    lanes moved by the position rule)."""
    dtype = jnp.float64
    if form == "general":
        data, p0s, products = _setup(dtype, 8)
    else:
        data, p0s, products = _factored(dtype, 8)
    spec = jax.ShapeDtypeStruct((sp.NSTATE,), dtype)
    dspec = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype), data)
    closed, nd = trace_products(products, spec, dspec)
    lanes, shared = adapt_products_lanes(closed, nd)
    rows = [d.reshape(8, -1).T for d in jax.tree_util.tree_leaves(data)]
    n2, jtx, jtj = lanes([p0s[:, k] for k in range(sp.NSTATE)], *rows,
                         *map(jnp.asarray, shared))
    ref = jax.vmap(products)(p0s, data)
    np.testing.assert_allclose(np.asarray(n2), np.asarray(ref.norm2_x),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(jnp.stack(jtx, -1)),
                               np.asarray(ref.Jt_x), rtol=1e-10, atol=1e-9)
    for a in range(sp.NSTATE):
        for b in range(a + 1):
            np.testing.assert_allclose(np.asarray(jtj[a][b]),
                                       np.asarray(ref.JtJ[:, a, b]),
                                       rtol=1e-10, atol=1e-9)
