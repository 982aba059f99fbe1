"""Ahead-of-time export: compiled solver artifacts for serving.

The reference ships a C shared library — deploying it means linking
libdogleg.so and calling into it with no compilation at runtime
(reference Makefile:7, ABI_VERSION=2). This library's equivalent of that
deployment story is `jax.export`: trace + lower the full jitted solve
ONCE (including the problem's closed-over data, the Newton strategy, and
every parameter), serialize the StableHLO artifact to bytes, and serve it
with `deserialize(...).call(p0)` — no Python tracing, no library source,
version-stable across processes.

    exp = export_solver(problem.products, nstate=6, batch_size=8192)
    save_exported("solver.bin", exp)
    # serving process:
    solve = load_exported("solver.bin")
    result = solve.call(p0_batch)        # a full SolveResult pytree

Everything the solver closes over (measurement data, BCSR patterns,
symbolic schedules) is baked into the artifact as constants — the
artifact IS the deployable solver for that problem family.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import export as jax_export

from libdogleg_tpu.params import DoglegParameters
from libdogleg_tpu.solver import History, SolveResult, solve_products

# the solver's result pytrees must be registered for artifact
# serialization (stable names — part of the artifact format); structured
# JtJ representations appear inside SolveResult.JtJ
jax_export.register_namedtuple_serialization(
    SolveResult, serialized_name="libdogleg_tpu.SolveResult")
jax_export.register_namedtuple_serialization(
    History, serialized_name="libdogleg_tpu.History")

from libdogleg_tpu.ops.newton import (SchurJtJ,  # noqa: E402
                                      SparseWSchurJtJ)

jax_export.register_namedtuple_serialization(
    SchurJtJ, serialized_name="libdogleg_tpu.SchurJtJ")
jax_export.register_namedtuple_serialization(
    SparseWSchurJtJ, serialized_name="libdogleg_tpu.SparseWSchurJtJ")


def export_solver(products_fn,
                  nstate: int,
                  parameters: Optional[DoglegParameters] = None,
                  *,
                  batch_size: Optional[int] = None,
                  dtype=jnp.float32,
                  newton_solver=None,
                  platforms=None,
                  outputs: str = "full"):
    """Trace, lower, and export the dog-leg solve for serving.

    Args:
      products_fn: `p -> Products` (problem data closed over — it is baked
        into the artifact as constants).
      nstate: static state size.
      parameters: solver parameters, frozen into the artifact.
      batch_size: if given, export the vmapped batched solve over
        `(batch_size, nstate)` initial states (the production batched
        configuration); otherwise a single `(nstate,)` solve.
      dtype: input dtype (f32 for GPU serving; f64 for CPU parity).
      newton_solver: optional strategy (e.g. BlockedDenseNewtonSolver for
        mid-size batches), frozen into the artifact.
      platforms: optional list for cross-platform lowering (e.g.
        ["cuda"] to export for the GPU from a CPU host); default = the
        current backend.
      outputs: "full" (default) returns the whole SolveResult pytree;
        "p" returns only the solution vector — the latency-serving
        configuration (the result fetch is ~1/3 of the single-solve CPU
        round trip; see bench_cpu_ref.py single_solve_exported_cpu).

    Returns a `jax.export.Exported`; serialize with `save_exported`.
    """
    prm = parameters if parameters is not None else DoglegParameters()

    def solve_one(p0):
        r = solve_products(products_fn, p0, prm,
                           newton_solver=newton_solver)
        return r.p if outputs == "p" else r

    fn = jax.vmap(solve_one) if batch_size else solve_one
    shape = (batch_size, nstate) if batch_size else (nstate,)
    return jax_export.export(jax.jit(fn), platforms=platforms)(
        jax.ShapeDtypeStruct(shape, dtype))


def save_exported(path: str, exported) -> None:
    """Write the serialized StableHLO artifact (pure bytes — no pickled
    Python objects, stable across jax versions per jax.export's
    compatibility guarantees)."""
    with open(path, "wb") as fh:
        fh.write(exported.serialize())


def load_exported(path: str):
    """Load an artifact saved by save_exported; returns a
    `jax.export.Exported` — run it with `.call(p0)`."""
    with open(path, "rb") as fh:
        return jax_export.deserialize(bytearray(fh.read()))
