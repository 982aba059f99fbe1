"""2-D grid Markov-random-field model family: large block-sparse problems.

The workload class the reference's sparse path exists for (CHOLMOD-backed
calibration/SLAM-style problems, reference README.pod:17-38): many small
state blocks coupled on a sparse graph. Here a W x H grid of b-dimensional
node states with per-node priors and 4-neighbor relative measurements:

    prior residual  r_v    = sqrt(w_prior) * (p_v - z_v)
    edge  residual  r_(uv) = sqrt(w_edge)  * ((p_v - p_u) - z_uv)

The Jacobian is block-CSR (one block row per prior, two blocks per edge
row); JtJ's block pattern is the grid adjacency + diagonal, which is where
the fill-reducing ordering (libdogleg_tpu.ordering) earns its keep — the
natural ordering of a W x H grid fills O(W) per column, minimum degree
substantially less.

The problem is linear (one GN step from anywhere), so it isolates exactly
the sparse machinery: JtJ block formation + the level-scheduled Cholesky.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from libdogleg_tpu.ops.bcsr import BCSRStructure
from libdogleg_tpu.problems import SparseProblem


class GridMRF(NamedTuple):
    width: int
    height: int
    block_size: int
    structure: BCSRStructure
    edges: np.ndarray        # (n_edges, 2) node indices (u, v)
    z_prior: jnp.ndarray     # (n_nodes, b) prior targets
    z_edge: jnp.ndarray      # (n_edges, b) relative targets
    w_prior: float
    w_edge: float
    p_true: jnp.ndarray      # (n_nodes * b,)
    # optional per-edge mixing matrices (n_edges, b, b): edge residual
    # r_(uv) = sqrt(w_edge) * (M_e p_v - p_u - z_uv). None = identity
    # (the classic diagonal coupling, where JtJ's off-diagonal blocks are
    # secretly diagonal and the scalar problem decouples per component);
    # dense M_e is the pose-graph-like regime the block-sparse machinery
    # exists for (dense 6x6-ish inter-node blocks).
    mix: jnp.ndarray = None

    @property
    def n_nodes(self) -> int:
        return self.width * self.height

    @property
    def nstate(self) -> int:
        return self.n_nodes * self.block_size

    def problem(self, jtj: str = "sparse",
                ordering="mindeg") -> SparseProblem:
        b = self.block_size
        n_nodes, n_edges = self.n_nodes, self.edges.shape[0]
        # Python-float weights and a data-typed identity keep a float32
        # problem float32 when float64 is enabled
        sp_w, se_w = float(np.sqrt(self.w_prior)), float(np.sqrt(self.w_edge))
        eu = jnp.asarray(self.edges[:, 0])
        ev = jnp.asarray(self.edges[:, 1])
        eye = jnp.eye(b, dtype=self.z_prior.dtype)
        # static block values: priors sqrt(wp) I; edges [-sqrt(we) I,
        # +sqrt(we) M_e] in (u, v) column order per row (see structure
        # build); M_e = I unless mix is set
        if self.mix is None:
            v_blocks = jnp.tile(jnp.stack([-se_w * eye, se_w * eye]),
                                (n_edges, 1, 1))
        else:
            v_blocks = jnp.stack(
                [jnp.broadcast_to(-se_w * eye, (n_edges, b, b)),
                 se_w * self.mix], axis=1).reshape(2 * n_edges, b, b)
        values = jnp.concatenate([
            jnp.broadcast_to(sp_w * eye, (n_nodes, b, b)), v_blocks])

        def f(p):
            pb = p.reshape(n_nodes, b)
            r_prior = sp_w * (pb - self.z_prior)
            pv = pb[ev] if self.mix is None else jnp.einsum(
                'ebc,ec->eb', self.mix, pb[ev])
            r_edge = se_w * (pv - pb[eu] - self.z_edge)
            x = jnp.concatenate([r_prior.reshape(-1), r_edge.reshape(-1)])
            return x, values

        return SparseProblem(f=f, structure=self.structure, jtj=jtj,
                             ordering=ordering)


def make_grid_mrf(width: int = 32, height: int = 32, block_size: int = 4,
                  w_prior: float = 0.01, w_edge: float = 1.0,
                  noise: float = 0.05, seed: int = 0,
                  coupling: str = "diag",
                  dtype=jnp.float64) -> GridMRF:
    if coupling not in ("diag", "dense"):
        raise ValueError(f"coupling must be 'diag' or 'dense', "
                         f"got {coupling!r}")
    rng = np.random.default_rng(seed)
    n_nodes = width * height
    b = block_size
    node = lambda ix, iy: iy * width + ix
    edges = []
    for iy in range(height):
        for ix in range(width):
            if ix + 1 < width:
                edges.append((node(ix, iy), node(ix + 1, iy)))
            if iy + 1 < height:
                edges.append((node(ix, iy), node(ix, iy + 1)))
    edges = np.asarray(edges, np.int64)
    n_edges = edges.shape[0]

    p_true = rng.normal(size=(n_nodes, b))
    z_prior = p_true + rng.normal(size=(n_nodes, b)) * noise
    if coupling == "dense":
        # well-conditioned dense per-edge mixing: M_e = I + 0.3 G_e
        mix = (np.eye(b)[None]
               + 0.3 * rng.normal(size=(n_edges, b, b)) / np.sqrt(b))
        pv = np.einsum('ebc,ec->eb', mix, p_true[edges[:, 1]])
    else:
        mix = None
        pv = p_true[edges[:, 1]]
    z_edge = (pv - p_true[edges[:, 0]]
              + rng.normal(size=(n_edges, b)) * noise)

    # BCSR: block rows = priors then edges; priors touch 1 block (their
    # node), edges touch 2 (u then v if u < v — grid edges always have
    # u < v, keeping indices sorted per row)
    indptr = np.empty(n_nodes + n_edges + 1, np.int32)
    indptr[0] = 0
    indptr[1:n_nodes + 1] = np.arange(1, n_nodes + 1)
    indptr[n_nodes + 1:] = n_nodes + 2 * np.arange(1, n_edges + 1)
    indices = np.concatenate([
        np.arange(n_nodes, dtype=np.int32),
        edges.astype(np.int32).reshape(-1)])
    structure = BCSRStructure(
        nmeas=(n_nodes + n_edges) * b, nstate=n_nodes * b,
        block_rows=b, block_cols=b, indptr=indptr, indices=indices)

    return GridMRF(width=width, height=height, block_size=b,
                   structure=structure, edges=edges,
                   z_prior=jnp.asarray(z_prior, dtype),
                   z_edge=jnp.asarray(z_edge, dtype),
                   w_prior=w_prior, w_edge=w_edge,
                   p_true=jnp.asarray(p_true.reshape(-1), dtype),
                   mix=None if mix is None else jnp.asarray(mix, dtype))
