"""Scaling-efficiency benchmark: batched solves across a device mesh.

BASELINE.md asks for >= 80% scaling efficiency from one device to many.
The mode follows the devices JAX runs on:

  * accelerators (e.g. four GPUs of one host): weak scaling — the batch
    grows with the mesh; efficiency(N) = rate(N) / (N * rate(1));
  * virtual CPU devices (JAX_PLATFORMS=cpu; this script asks XLA for
    SCALING_DEVICES of them): the devices share the same cores, so
    throughput cannot grow with N. With the total batch fixed,
    rate(N)/rate(1) should stay ~1.0 if the sharded program has no hidden
    cross-device serialization; that retention is what the 0.8 gate
    checks.

Prints one JSON line per mesh size plus a final efficiency line.

    python bench_scaling.py                       # accelerators
    JAX_PLATFORMS=cpu python bench_scaling.py     # virtual CPU mesh
"""

import json
import os
import sys

N_DEVICES = int(os.environ.get("SCALING_DEVICES", "8"))

if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={N_DEVICES}").strip()

from libdogleg_tpu.utils.compile_cache import enable_compile_cache  # noqa

enable_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import libdogleg_tpu.models.quadratic_surface as sp  # noqa: E402
from libdogleg_tpu import DoglegParameters  # noqa: E402
from libdogleg_tpu.parallel import (batched_optimize, make_mesh,  # noqa: E402
                                    shard_batch)
from libdogleg_tpu.solver import Products  # noqa: E402
from libdogleg_tpu.utils.benchtime import measure  # noqa: E402

REAL = jax.devices()[0].platform != "cpu"
PER_DEVICE_BATCH = 8192
# fixed-work mode (virtual mesh); SCALING_BATCH lets the suite's
# regression gate run a reduced, faster instance
TOTAL_BATCH = int(os.environ.get("SCALING_BATCH", "4096"))
DTYPE = jnp.float32
PRM = DoglegParameters(max_iterations=10, Jt_x_threshold=1e-3,
                       update_threshold=1e-5, trustregion_threshold=1e-5)


def make_batch(batch):
    gx, gy = sp.make_grid(DTYPE)
    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    meas = jax.vmap(lambda k: sp.simulate(k, dtype=DTYPE))(keys)
    p0s = jax.vmap(lambda k: sp.initial_state(k, dtype=DTYPE))(
        jax.random.split(jax.random.PRNGKey(1), batch))

    def products(p, m):
        x = sp.model(p, gx, gy) - m
        J = sp.jacobian(p, gx, gy)
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)

    return products, p0s, meas


def throughput(n_dev):
    batch = PER_DEVICE_BATCH * n_dev if REAL else TOTAL_BATCH
    products, p0s, meas = make_batch(batch)
    mesh = make_mesh(("dp",), shape=(n_dev,))
    p0s, meas = shard_batch((p0s, meas), mesh)

    def run(p0s, meas):
        r = batched_optimize(products, p0s, PRM, mesh=mesh,
                             problem_data=meas)
        return r.p, r.step_count.astype(jnp.float32)

    return batch / measure(jax.jit(run), p0s, meas).warm_s


def main():
    devs = [1]
    n = 2
    while n <= min(N_DEVICES, jax.device_count()):
        devs.append(n)
        n *= 2
    base = None
    effs = {}
    for n_dev in devs:
        rate = throughput(n_dev)
        if base is None:
            base = rate
        eff = rate / ((n_dev * base) if REAL else base)
        effs[n_dev] = eff
        print(json.dumps({
            "metric": "scaling_batched_solves_per_s",
            "devices": n_dev, "value": rate,
            "unit": "solves/s",
            "batch": PER_DEVICE_BATCH * n_dev if REAL else TOTAL_BATCH,
            ("efficiency" if REAL else "retention"): eff,
            "device": {"platform": jax.devices()[0].platform,
                       "kind": jax.devices()[0].device_kind,
                       "count": jax.device_count()}}))
    worst = min(e for n, e in effs.items() if n > 1) if len(effs) > 1 else 1.0
    print(json.dumps({
        "metric": ("scaling_efficiency_worst" if REAL
                   else "partitioning_retention_worst"),
        "value": worst, "unit": "fraction",
        "target": 0.8, "passes": bool(worst >= 0.8),
        "note": ("real device mesh, weak scaling" if REAL else
                 "fixed total work on a shared-core virtual mesh; measures "
                 "partitioning overhead, not hardware scaling")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
