"""Synthetic bundle-adjustment-style model family: arrow-structured systems.

The structural regime libdogleg was built for (its author wrote it for camera
calibration / SFM, reference README.pod:5-15): a small dense "global" block
(cameras, intrinsics) coupled to many independent small "point" blocks, with
JtJ the arrow matrix [[U, W], [W^T, V]], V block-diagonal. The reference
hands such systems whole to CHOLMOD; here the Schur complement of the point
blocks is eliminated explicitly (ops.newton.SchurNewtonSolver) — batched
small Cholesky + one dense factor, the accelerator shape (BASELINE.md
config 4).

The synthetic instance is linear-Gaussian: each point q_p (size bs) is
observed k_obs times through random local maps A_p (k_obs, bs) plus a
coupling to the global parameters c through B_p (k_obs, nc):

    r_{p,k} = A_p[k] . q_p + B_p[k] . c - obs_{p,k}

State layout p = [c (nc) | q (n_points * bs)], Nstate = nc + n_points*bs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from libdogleg_tpu.ops.newton import SchurJtJ, SchurNewtonSolver
from libdogleg_tpu.solver import Products


class BAProblem(NamedTuple):
    A: jnp.ndarray          # (n_points, k_obs, bs) point observation maps
    B: jnp.ndarray          # (n_points, k_obs, nc) global coupling maps
    obs: jnp.ndarray        # (n_points, k_obs) observations
    p_true: jnp.ndarray     # (nstate,) generating state
    nc: int
    n_points: int
    block_size: int

    @property
    def nstate(self) -> int:
        return self.nc + self.n_points * self.block_size

    @property
    def nmeasurements(self) -> int:
        return int(self.obs.shape[0] * self.obs.shape[1])

    def split(self, p):
        return (p[:self.nc],
                p[self.nc:].reshape(self.n_points, self.block_size))

    def _core(self, c, q):
        """Residual + structured gradient + arrow JtJ — shared by the flat
        and pytree product forms so the two can never drift apart."""
        dt = c.dtype
        r = (jnp.einsum('pkb,pb->pk', self.A, q)
             + jnp.einsum('pkc,c->pk', self.B, c) - self.obs)
        gc = jnp.einsum('pkc,pk->c', self.B, r, preferred_element_type=dt)
        gq = jnp.einsum('pkb,pk->pb', self.A, r, preferred_element_type=dt)
        JtJ = SchurJtJ(
            U=jnp.einsum('pkc,pkd->cd', self.B, self.B,
                         preferred_element_type=dt),
            W=jnp.einsum('pkc,pkb->cpb', self.B, self.A,
                         preferred_element_type=dt),
            V=jnp.einsum('pkb,pkd->pbd', self.A, self.A,
                         preferred_element_type=dt))
        return r, gc, gq, JtJ

    def residuals(self, p):
        c, q = self.split(p)
        return (jnp.einsum('pkb,pb->pk', self.A, q)
                + jnp.einsum('pkc,c->pk', self.B, c) - self.obs)

    def products(self, p) -> Products:
        """One reduction over all observations into the arrow-structured
        Gauss-Newton system — the dense-products formulation (reference
        dogleg.h:34-45) with a structured JtJ the reference cannot express."""
        c, q = self.split(p)
        r, gc, gq, JtJ = self._core(c, q)
        return Products(norm2_x=jnp.sum(r * r),
                        Jt_x=jnp.concatenate([gc, gq.ravel()]),
                        JtJ=JtJ)

    def newton_solver(self) -> SchurNewtonSolver:
        return SchurNewtonSolver(nc=self.nc, n_points=self.n_points,
                                 block_size=self.block_size)

    # ---- structured-state (pytree) form: p = {"c": (nc,), "q": (np, bs)}.
    # Each leaf carries its own sharding, so the point axis distributes
    # over a mesh while the camera block stays replicated — the
    # multi-chip Schur-elimination configuration (BASELINE.md config 4).

    def residuals_tree(self, p):
        return (jnp.einsum('pkb,pb->pk', self.A, p["q"])
                + jnp.einsum('pkc,c->pk', self.B, p["c"]) - self.obs)

    def products_tree(self, p) -> Products:
        r, gc, gq, JtJ = self._core(p["c"], p["q"])
        return Products(norm2_x=jnp.sum(r * r),
                        Jt_x={"c": gc, "q": gq},
                        JtJ=JtJ)

    def tree_newton_solver(self):
        from libdogleg_tpu.ops.newton import TreeSchurNewtonSolver
        return TreeSchurNewtonSolver(nc=self.nc, n_points=self.n_points,
                                     block_size=self.block_size)

    def p0_tree(self, dtype=None):
        dtype = dtype or self.A.dtype
        return {"c": jnp.zeros((self.nc,), dtype),
                "q": jnp.zeros((self.n_points, self.block_size), dtype)}

    def shard(self, mesh, axis_name: str = "pts") -> "BAProblem":
        """Place the per-point data (A, B, obs) sharded over a mesh axis;
        shard p["q"] the same way (see shard_p_tree) and the whole solve
        stays distributed under jit."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        s = NamedSharding(mesh, P(axis_name))
        return self._replace(A=jax.device_put(self.A, s),
                             B=jax.device_put(self.B, s),
                             obs=jax.device_put(self.obs, s))

    def shard_p_tree(self, p, mesh, axis_name: str = "pts"):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        return {"c": jax.device_put(p["c"],
                                    NamedSharding(mesh, P())),
                "q": jax.device_put(p["q"],
                                    NamedSharding(mesh, P(axis_name)))}


def make_synthetic(seed: int = 0,
                   nc: int = 64,
                   n_points: int = 20000,
                   block_size: int = 3,
                   k_obs: int = 4,
                   coupling: float = 0.05,
                   noise: float = 0.0,
                   dtype=jnp.float32) -> BAProblem:
    """Deterministic synthetic instance. noise=0 makes the generating state
    the exact optimum (residuals vanish there), which gives the benchmark a
    built-in convergence check."""
    rng = np.random.default_rng(seed)
    A = jnp.asarray(rng.normal(size=(n_points, k_obs, block_size)), dtype)
    B = jnp.asarray(rng.normal(size=(n_points, k_obs, nc)) * coupling, dtype)
    c_true = jnp.asarray(rng.normal(size=(nc,)), dtype)
    q_true = jnp.asarray(rng.normal(size=(n_points, block_size)), dtype)
    obs = (jnp.einsum('pkb,pb->pk', A, q_true)
           + jnp.einsum('pkc,c->pk', B, c_true))
    if noise:
        obs = obs + jnp.asarray(
            rng.normal(size=obs.shape) * noise, dtype)
    p_true = jnp.concatenate([c_true, q_true.ravel()])
    return BAProblem(A=A, B=B, obs=obs, p_true=p_true, nc=nc,
                     n_points=n_points, block_size=block_size)
