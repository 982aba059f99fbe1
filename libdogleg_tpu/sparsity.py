"""Symbolic (structure-only) analysis for block-sparse Jacobians.

The reference performs symbolic analysis exactly once per problem via
cholmod_analyze (reference dogleg.c:649-654) because "the pattern of zeros
will remain the same throughout". The equivalent here is precomputing a
static block sparsity pattern on the host, which then parameterizes all jitted
block-sparse kernels with static shapes. This module holds those host-side,
numpy-only routines. (A C++ fast path for very large patterns lives in csrc/.)
"""

from __future__ import annotations

import numpy as np

from libdogleg_tpu.ops.bcsr import BCSRStructure


def bcsr_from_scalar_csr(rowptr: np.ndarray,
                         colidx: np.ndarray,
                         nmeas: int,
                         nstate: int,
                         block_rows: int = 1,
                         block_cols: int = 1) -> BCSRStructure:
    """Derive a block sparsity pattern from a scalar CSR pattern.

    The scalar pattern is the reference's Jt CSC / J CSR layout
    (reference dogleg.h:11-20, sample.c:89-125). A block (br, bc) is stored
    iff any scalar nnz falls inside it. nmeas/nstate must be divisible by the
    block sizes (pad the problem otherwise).
    """
    assert nmeas % block_rows == 0 and nstate % block_cols == 0
    from libdogleg_tpu.native.symbolic import bcsr_pattern_native
    nat = bcsr_pattern_native(rowptr, colidx, nmeas, nstate,
                              block_rows, block_cols)
    if nat is not None:
        indptr, indices = nat
        return BCSRStructure(nmeas=nmeas, nstate=nstate,
                             block_rows=block_rows, block_cols=block_cols,
                             indptr=indptr, indices=indices)
    nbrow = nmeas // block_rows
    indptr = np.zeros(nbrow + 1, dtype=np.int32)
    indices_per_row = []
    rowptr = np.asarray(rowptr)
    colidx = np.asarray(colidx)
    for br in range(nbrow):
        lo = rowptr[br * block_rows]
        hi = rowptr[(br + 1) * block_rows]
        cols = np.unique(colidx[lo:hi] // block_cols)
        indices_per_row.append(cols.astype(np.int32))
        indptr[br + 1] = indptr[br] + len(cols)
    indices = (np.concatenate(indices_per_row) if indices_per_row
               else np.zeros(0, np.int32))
    return BCSRStructure(nmeas=nmeas, nstate=nstate,
                         block_rows=block_rows, block_cols=block_cols,
                         indptr=indptr, indices=indices)


def dense_structure(nmeas: int, nstate: int,
                    block_rows: int = 1,
                    block_cols: int = 1) -> BCSRStructure:
    """Fully-dense block pattern (every block stored)."""
    assert nmeas % block_rows == 0 and nstate % block_cols == 0
    nbrow = nmeas // block_rows
    nbcol = nstate // block_cols
    indptr = np.arange(nbrow + 1, dtype=np.int32) * nbcol
    indices = np.tile(np.arange(nbcol, dtype=np.int32), nbrow)
    return BCSRStructure(nmeas=nmeas, nstate=nstate,
                         block_rows=block_rows, block_cols=block_cols,
                         indptr=indptr, indices=indices)
