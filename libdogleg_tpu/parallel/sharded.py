"""Measurement-axis (row-block) sharding of the Jacobian.

This library's answer to the reference's sparse-scaling story (SURVEY.md
sections 2.2 and 5.7): the products the solver consumes — norm2(x), J^T x,
J^T J — are all *sums over the measurement axis*, so partitioning measurement
row blocks across devices and psum-ing the per-device partial products is
mathematically exact. Each device evaluates only its rows of the residual and
Jacobian; the Nstate-sized trust-region iteration then runs replicated on
every device (it is tiny), with the only communication being one psum of
(1 + Nstate + Nstate^2) floats per operating-point evaluation, riding ICI.

This is the tensor-parallel row in SURVEY.md's parallelism table and the
structural analog of sequence/context parallelism for this workload (the
measurement axis is the long axis).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from libdogleg_tpu.ops import dense as dops
from libdogleg_tpu.solver import Products


def measurement_sharded_products(
        f_shard: Callable[[jnp.ndarray, Any],
                          Tuple[jnp.ndarray, jnp.ndarray]],
        mesh: Mesh,
        axis_name: str,
) -> Callable[[jnp.ndarray, Any], Products]:
    """Wrap a per-shard dense residual function into a global Products fn.

    Args:
      f_shard: (p, data_shard) -> (x_shard, J_shard) evaluating only this
        device's measurement rows. data_shard is any pytree whose leaves have
        the measurement axis leading.
      mesh: the device mesh.
      axis_name: mesh axis to shard the measurement dimension over.

    Returns:
      products(p, data) -> Products where data leaves are (globally shaped)
      arrays sharded along their leading axis. The partial products are
      reduced with psum — exact, per the sums-over-measurements identity.
    """

    def local(p, data_shard):
        x, J = f_shard(p, data_shard)
        partial = Products(norm2_x=dops.norm2(x),
                           Jt_x=dops.jt_dot(J, x),
                           JtJ=dops.build_jtj(J))
        return jax.tree_util.tree_map(
            lambda a: jax.lax.psum(a, axis_name), partial)

    # in_specs are pytree prefixes: P(axis_name) applies to every leaf of the
    # data pytree (all leaves carry the measurement axis leading).
    return jax.shard_map(local, mesh=mesh,
                         in_specs=(P(), P(axis_name)), out_specs=P())


@dataclasses.dataclass(frozen=True)
class MeasurementShardedProblem:
    """A dense problem whose measurement rows are partitioned over a mesh
    axis. Presents the same `products` interface as the single-device
    adapters, so `optimize`/`solve_products` work unchanged — the entire
    solve jits into one program with XLA-inserted collectives.

    Attributes:
      f: (p, data_shard) -> (x_shard, J_shard), evaluated per device.
      data: pytree of arrays with the measurement axis leading (global view;
        place with jax.device_put(..., NamedSharding(mesh, P(axis_name)))
        for best performance — GSPMD will reshard otherwise).
      mesh / axis_name: where the measurement axis lives.
    """
    f: Callable[[jnp.ndarray, Any], Tuple[jnp.ndarray, jnp.ndarray]]
    data: Any
    mesh: Mesh
    axis_name: str = "meas"

    def products(self, p: jnp.ndarray) -> Products:
        def local(p, data_shard):
            x, J = self.f(p, data_shard)
            partial = Products(norm2_x=dops.norm2(x),
                               Jt_x=dops.jt_dot(J, x),
                               JtJ=dops.build_jtj(J))
            return jax.tree_util.tree_map(
                lambda a: jax.lax.psum(a, self.axis_name), partial)

        fn = jax.shard_map(local, mesh=self.mesh,
                           in_specs=(P(), P(self.axis_name)), out_specs=P())
        return fn(p, self.data)


@dataclasses.dataclass(frozen=True)
class MeasurementShardedSparseProblem:
    """Row-sharded measurements producing BLOCK-SPARSE JtJ: the large-
    Nstate companion of MeasurementShardedProblem, for problems where
    nstate^2 dense JtJ is the thing that doesn't fit.

    Each device evaluates only its measurement rows (dense row slices of
    J), contracts them into the static lower-triangle JtJ block pattern
    (sums over measurements are exact under psum), and the solver consumes
    the psum'd blocks through SparseNewtonSolver — measurement-axis
    partitioning composed with the supernodal block-sparse Cholesky.

    Attributes:
      f: (p, data_shard) -> (x_shard, J_shard) per device, J_shard
        (m_local, nstate) dense rows.
      data: pytree with the measurement axis leading.
      pattern_rows/pattern_cols: the stored lower-triangle JtJ block
        pattern (block coords over nbcol = nstate // b blocks, rows >=
        cols, diagonal present) — the same lists fed to
        SparseNewtonSolver.analyze.
      b: JtJ block size; mesh/axis_name: the measurement axis.

    Pair with `newton_solver()`; Products.JtJ is the (nnzb, b, b) block
    tensor in pattern order.
    """
    f: Callable[[jnp.ndarray, Any], Tuple[jnp.ndarray, jnp.ndarray]]
    data: Any
    pattern_rows: Any
    pattern_cols: Any
    b: int
    mesh: Mesh
    axis_name: str = "meas"
    ordering: object = None
    amalgamate: int = 1
    _newton: object = dataclasses.field(init=False, default=None,
                                        repr=False, compare=False)

    def __post_init__(self):
        import numpy as np
        from libdogleg_tpu.ops.newton import SparseNewtonSolver
        nbcol = int(np.max(self.pattern_cols)) + 1
        nbcol = max(nbcol, int(np.max(self.pattern_rows)) + 1)
        object.__setattr__(self, "_newton", SparseNewtonSolver.analyze(
            self.pattern_rows, self.pattern_cols, nbcol, self.b,
            self.ordering, amalgamate=self.amalgamate))

    def newton_solver(self):
        return self._newton

    def products(self, p: jnp.ndarray) -> Products:
        import numpy as np
        pr = jnp.asarray(np.asarray(self.pattern_rows))
        pc = jnp.asarray(np.asarray(self.pattern_cols))
        b = self.b

        def local(p, data_shard):
            x, J = self.f(p, data_shard)
            m_local = J.shape[0]
            Jb = J.reshape(m_local, J.shape[1] // b, b)
            # one gathered batched contraction per stored lower block
            blocks = jnp.einsum('mkb,mkc->kbc', Jb[:, pr], Jb[:, pc],
                                preferred_element_type=J.dtype)
            partial = Products(norm2_x=dops.norm2(x),
                               Jt_x=dops.jt_dot(J, x),
                               JtJ=blocks)
            return jax.tree_util.tree_map(
                lambda a: jax.lax.psum(a, self.axis_name), partial)

        fn = jax.shard_map(local, mesh=self.mesh,
                           in_specs=(P(), P(self.axis_name)), out_specs=P())
        return fn(p, self.data)
