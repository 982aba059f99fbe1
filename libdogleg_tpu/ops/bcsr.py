"""Block-CSR Jacobian storage and products.

The reference stores sparse Jacobians in scalar CSR (CHOLMOD's CSC-of-Jt,
reference dogleg.h:11-20) and hand-rolls O(nnz) scalar-loop products
(mul_spmatrix_densevector / norm2_mul_spmatrix_t_densevector, reference
dogleg.c:249-281). Scalar CSR is the wrong shape for an accelerator: gathers
of single doubles leave its vector units idle. Here the Jacobian is *block*-CSR — a static block
sparsity pattern (the one-time "symbolic analysis", mirroring the reference's
single cholmod_analyze at dogleg.c:649-654) plus a dense (nnzb, bm, bn) value
tensor — so every product is a batch of dense block contractions plus a
segment-sum, all static-shaped.

The structure (numpy, host-side) is fixed per problem; only `values` is traced.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class BCSRStructure(NamedTuple):
    """Static block sparsity pattern of a (nmeas x nstate) Jacobian tiled into
    (block_rows x block_cols) blocks. Host-side metadata, fixed per problem —
    the equivalent of the reference's one-time symbolic analysis
    (dogleg.c:649-654: "the pattern of zeros will remain the same")."""
    nmeas: int
    nstate: int
    block_rows: int                 # bm: measurement rows per block
    block_cols: int                 # bn: state cols per block
    indptr: np.ndarray              # (nbrow + 1,) int32: CSR over block rows
    indices: np.ndarray             # (nnzb,) int32: block-col of each block

    @property
    def nbrow(self) -> int:
        return self.nmeas // self.block_rows

    @property
    def nbcol(self) -> int:
        return self.nstate // self.block_cols

    @property
    def nnzb(self) -> int:
        return int(self.indices.shape[0])

    def row_of_block(self) -> np.ndarray:
        """(nnzb,) block-row index of each stored block."""
        counts = np.diff(self.indptr)
        return np.repeat(np.arange(self.nbrow, dtype=np.int32),
                         counts).astype(np.int32)

    def jtj_pairs(self) -> tuple[np.ndarray, np.ndarray]:
        """All ordered pairs (i, j) of stored blocks sharing a block row —
        the static schedule for forming J^T J block-by-block."""
        pi, pj = [], []
        for r in range(self.nbrow):
            blocks = np.arange(self.indptr[r], self.indptr[r + 1])
            for a in blocks:
                for b in blocks:
                    pi.append(a)
                    pj.append(b)
        return (np.asarray(pi, np.int32), np.asarray(pj, np.int32))


class BCSRJacobian(NamedTuple):
    """A block-CSR Jacobian: static structure + traced block values."""
    structure: BCSRStructure
    values: jnp.ndarray  # (nnzb, block_rows, block_cols)


def dense_to_bcsr_values(J: jnp.ndarray, s: BCSRStructure) -> jnp.ndarray:
    """Extract the stored blocks of a dense (nmeas, nstate) J (test helper)."""
    Jb = J.reshape(s.nbrow, s.block_rows, s.nbcol, s.block_cols)
    Jb = jnp.transpose(Jb, (0, 2, 1, 3))  # (nbrow, nbcol, bm, bn)
    rows = s.row_of_block()
    return Jb[rows, s.indices]


def bcsr_to_dense(J: BCSRJacobian) -> jnp.ndarray:
    """Densify (test/analysis helper; O(nmeas * nstate) memory)."""
    s = J.structure
    rows = s.row_of_block()
    out = jnp.zeros((s.nbrow, s.nbcol, s.block_rows, s.block_cols),
                    J.values.dtype)
    out = out.at[rows, s.indices].add(J.values)
    out = jnp.transpose(out, (0, 2, 1, 3))
    return out.reshape(s.nmeas, s.nstate)


def bcsr_jt_x(J: BCSRJacobian, x: jnp.ndarray) -> jnp.ndarray:
    """J^T x: per-block (bm,bn)^T @ (bm,) contractions + segment-sum over
    block columns (replaces reference mul_spmatrix_densevector,
    dogleg.c:249-261)."""
    s = J.structure
    xb = x.reshape(s.nbrow, s.block_rows)
    xg = xb[s.row_of_block()]                       # (nnzb, bm)
    partial = jnp.einsum('bmn,bm->bn', J.values, xg,
                         preferred_element_type=J.values.dtype)
    out = jax.ops.segment_sum(partial, jnp.asarray(s.indices),
                              num_segments=s.nbcol)
    return out.reshape(s.nstate)


def bcsr_matvec(J: BCSRJacobian, v: jnp.ndarray) -> jnp.ndarray:
    """J v: the forward product (used by norm2(J v) and analysis paths;
    replaces reference norm2_mul_spmatrix_t_densevector's inner loop,
    dogleg.c:262-281)."""
    s = J.structure
    vb = v.reshape(s.nbcol, s.block_cols)
    vg = vb[jnp.asarray(s.indices)]                 # (nnzb, bn)
    partial = jnp.einsum('bmn,bn->bm', J.values, vg,
                         preferred_element_type=J.values.dtype)
    out = jax.ops.segment_sum(partial, jnp.asarray(s.row_of_block()),
                              num_segments=s.nbrow)
    return out.reshape(s.nmeas)


class JtJSchedule(NamedTuple):
    """Static (host-side) work list for block-JtJ formation: for every pair
    of stored blocks sharing a block row, one block contraction; pairs
    sorted by output block so each output block is one contiguous run.
    This is the symbolic-analysis artifact, computed once per structure
    (mirroring the reference's single cholmod_analyze, dogleg.c:649-654)."""
    pair_i: np.ndarray    # (npairs,) int32 index into values
    pair_j: np.ndarray    # (npairs,) int32 index into values
    out_idx: np.ndarray   # (npairs,) int32 index into the output block list
    out_ci: np.ndarray    # (nnzb_out,) block-row (state) coordinate
    out_cj: np.ndarray    # (nnzb_out,) block-col (state) coordinate


def build_jtj_schedule(s: BCSRStructure) -> JtJSchedule:
    """The JtJ pair schedule of `s`: the native (C++) builder for large
    patterns, else the numpy form below (identical output)."""
    from libdogleg_tpu.native.symbolic import jtj_schedule_native
    nat = jtj_schedule_native(s.indptr, s.indices, s.nbcol)
    if nat is not None:
        pi, pj, out_idx, out_ci, out_cj = nat
        return JtJSchedule(pair_i=pi, pair_j=pj, out_idx=out_idx,
                           out_ci=out_ci, out_cj=out_cj)
    pi, pj = s.jtj_pairs()
    ci = s.indices[pi]
    cj = s.indices[pj]
    order = np.lexsort((cj, ci))
    pi, pj, ci, cj = pi[order], pj[order], ci[order], cj[order]
    keys = ci.astype(np.int64) * s.nbcol + cj
    uniq, out_idx = np.unique(keys, return_inverse=True)
    return JtJSchedule(pair_i=pi.astype(np.int32),
                       pair_j=pj.astype(np.int32),
                       out_idx=out_idx.astype(np.int32),
                       out_ci=(uniq // s.nbcol).astype(np.int32),
                       out_cj=(uniq % s.nbcol).astype(np.int32))


class JtJLowerSchedule(NamedTuple):
    """Static schedule for forming the lower triangle of J^T J as
    block-sparse values in the input layout of sparse_cholesky.analyze:
    block k of the output holds JtJ[rows[k], cols[k]] (block coords,
    rows >= cols). The one-time symbolic artifact for the large-Nstate
    sparse path (the other half of the reference's cholmod_analyze,
    dogleg.c:649-654)."""
    rows: np.ndarray      # (nnzb_jtj,) output block-row (state) coords
    cols: np.ndarray      # (nnzb_jtj,) output block-col, rows >= cols
    pair_i: np.ndarray    # (npairs,) index into J.values
    pair_j: np.ndarray    # (npairs,) index into J.values
    out_idx: np.ndarray   # (npairs,) output block per pair


def jtj_lower_schedule(s: BCSRStructure) -> JtJLowerSchedule:
    """Lower-triangle JtJ block pattern + pair schedule for `s`
    (build_jtj_schedule filtered to rows >= cols)."""
    sch = build_jtj_schedule(s)
    keep_block = sch.out_ci >= sch.out_cj
    new_id = np.cumsum(keep_block) - 1
    keep_pair = keep_block[sch.out_idx]
    return JtJLowerSchedule(
        rows=sch.out_ci[keep_block].astype(np.int64),
        cols=sch.out_cj[keep_block].astype(np.int64),
        pair_i=sch.pair_i[keep_pair],
        pair_j=sch.pair_j[keep_pair],
        out_idx=new_id[sch.out_idx[keep_pair]].astype(np.int32))


def bcsr_jtj_lower_blocks(J: BCSRJacobian,
                          sched: JtJLowerSchedule) -> jnp.ndarray:
    """The stored lower-triangle blocks of J^T J: (nnzb_jtj, bn, bn) in the
    schedule's (rows, cols) order — the direct input of
    sparse_cholesky.factorize. One batched contraction + one
    segment-sum; JtJ never densifies."""
    pi = jnp.asarray(sched.pair_i)
    pj = jnp.asarray(sched.pair_j)
    contrib = jnp.einsum('pmi,pmj->pij', J.values[pi], J.values[pj],
                         preferred_element_type=J.values.dtype)
    return jax.ops.segment_sum(contrib, jnp.asarray(sched.out_idx),
                               num_segments=int(sched.rows.shape[0]))


def bcsr_jtj_dense(J: BCSRJacobian) -> jnp.ndarray:
    """J^T J as a dense (nstate, nstate) matrix, formed block-by-block.

    Enumerates the static list of same-row block pairs (symbolic schedule),
    batches the (bn, bm) x (bm, bn) products, and scatter-adds
    into block coordinates. Replaces the reference's implicit JtJ inside
    CHOLMOD (dogleg.c:659) / packed outer-product accumulation
    (dogleg.c:709-714). Suitable while nstate is moderate; a block-sparse JtJ
    + blocked sparse Cholesky path covers large-state problems.
    """
    s = J.structure
    pi, pj = s.jtj_pairs()
    contrib = jnp.einsum('pmi,pmj->pij', J.values[pi], J.values[pj],
                         preferred_element_type=J.values.dtype)
    ci = jnp.asarray(s.indices[pi])
    cj = jnp.asarray(s.indices[pj])
    out = jnp.zeros((s.nbcol, s.nbcol, s.block_cols, s.block_cols),
                    J.values.dtype)
    out = out.at[ci, cj].add(contrib)
    out = jnp.transpose(out, (0, 2, 1, 3))
    return out.reshape(s.nstate, s.nstate)
