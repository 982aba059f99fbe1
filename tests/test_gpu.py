"""Card-only checks: the whole-solve kernel compiled through Triton.

Run on a GPU with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/`; elsewhere each test skips (the `gpu` fixture decides when the
test runs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import libdogleg_tpu.models.quadratic_surface as sp
from libdogleg_tpu import DoglegParameters
from libdogleg_tpu.parallel.batched import batched_optimize
from libdogleg_tpu.parallel.mega_auto import plan_megakernel
from libdogleg_tpu.solver import Products

RELAXED = DoglegParameters(max_iterations=10, Jt_x_threshold=1e-3,
                           update_threshold=1e-5, trustregion_threshold=1e-5)
BATCH = 1024


def _instances():
    dtype = jnp.float32
    gx, gy = sp.make_grid(dtype)
    meas = jax.vmap(lambda k: sp.simulate(k, dtype=dtype))(
        jax.random.split(jax.random.PRNGKey(0), BATCH))
    p0s = jax.vmap(lambda k: sp.initial_state(k, dtype=dtype))(
        jax.random.split(jax.random.PRNGKey(1), BATCH))

    def general_at(precision):
        def products(p, m):
            x = sp.model(p, gx, gy) - m
            J = sp.jacobian(p, gx, gy)
            return Products(norm2_x=jnp.dot(x, x, precision=precision),
                            Jt_x=jnp.dot(J.T, x, precision=precision),
                            JtJ=jnp.dot(J.T, J, precision=precision))
        return products

    G_pair = sp.gram_pair(dtype)
    stats = jax.vmap(sp.factored_statistics)(meas)
    return {"general": (general_at(jax.lax.Precision.HIGHEST), meas),
            "general-default": (general_at(None), meas),
            "factored": (lambda p, st: sp.factored_products(p, st, G_pair),
                         stats)}, p0s


# Least share of instances on which kernel and XLA path take the same
# number of steps. The kernel computes every product in float32. At
# Precision.HIGHEST so does the XLA path, and only roundoff differs. At
# default precision the XLA path forms JtJ and Jt_x in TF32 on the card,
# and the decisions differ far more often (66.4% agreement measured on an
# H100, PERF.md).
MIN_STEP_AGREEMENT = {"general": 0.85, "factored": 0.85,
                      "general-default": 0.6}


@pytest.mark.gpu
def test_batched_optimize_selects_the_kernel(gpu):
    forms, p0s = _instances()
    for products, data in forms.values():
        assert plan_megakernel(products, p0s, RELAXED,
                               problem_data=data) is not None


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["general", "general-default",
                                  "factored"])
def test_compiled_kernel_agrees_with_xla(gpu, form):
    forms, p0s = _instances()
    products, data = forms[form]
    r = batched_optimize(products, p0s, RELAXED, problem_data=data,
                         use_megakernel=True)
    r_ref = batched_optimize(products, p0s, RELAXED, problem_data=data,
                             use_megakernel=False)
    same = np.asarray(r.step_count) == np.asarray(r_ref.step_count)
    assert np.mean(same) > MIN_STEP_AGREEMENT[form]
    err = np.abs(np.asarray(r.p) - sp.P_TRUE[None])
    assert np.mean(np.all(err < 0.2, axis=1)) >= 0.99
