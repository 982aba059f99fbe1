"""ctypes wrappers over the native symbolic-analysis kernels, with numpy
signatures identical to the pure-Python versions they accelerate."""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from libdogleg_tpu.native.loader import get_lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def jtj_schedule_native(indptr: np.ndarray, indices: np.ndarray,
                        nbcol: int) -> Optional[Tuple[np.ndarray, ...]]:
    """Sorted JtJ pair schedule (pair_i, pair_j, out_idx, out_ci, out_cj),
    identical to ops.bcsr.build_jtj_schedule's numpy output. None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    nbrow = len(indptr) - 1
    npairs = lib.jtj_pair_count(_i32p(indptr), nbrow)
    pair_i = np.empty(npairs, np.int32)
    pair_j = np.empty(npairs, np.int32)
    out_idx = np.empty(npairs, np.int32)
    out_ci = np.empty(max(npairs, 1), np.int32)
    out_cj = np.empty(max(npairs, 1), np.int32)
    nblocks = lib.jtj_schedule(_i32p(indptr), _i32p(indices), nbrow,
                               int(nbcol), _i32p(pair_i), _i32p(pair_j),
                               _i32p(out_idx), _i32p(out_ci), _i32p(out_cj))
    return (pair_i, pair_j, out_idx,
            out_ci[:nblocks].copy(), out_cj[:nblocks].copy())


def chol_symbolic_native(rows: np.ndarray, cols: np.ndarray, nb: int):
    """Native symbolic factorization (fill + ASAP op levels + solve levels)
    for the block-sparse Cholesky; identical outputs to
    sparse_cholesky._symbolic_python. Returns
    (rows, cols, a_slot_of_input, OpSchedule, fwd SolveSchedule,
    bwd SolveSchedule) or None if the native library is unavailable."""
    from libdogleg_tpu.sparse_cholesky import OpSchedule, SolveSchedule
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    h = lib.chol_symbolic_build(_i32p(rows), _i32p(cols),
                                np.int64(rows.shape[0]), np.int32(nb))
    try:
        counts = np.empty(12, np.int64)
        lib.chol_symbolic_counts(ctypes.c_void_p(h), _i64p(counts))
        (nslots, nlevels, n_upd, n_fac, n_sol, n_fwd_lv, n_fwd_p, n_fwd_d,
         n_bwd_lv, n_bwd_p, n_bwd_d, n_input) = (int(c) for c in counts)
        e = lambda n: np.empty(n, np.int32)
        out_rows, out_cols, a_slot = e(nslots), e(nslots), e(n_input)
        ut, ui, uj, uoff = e(n_upd), e(n_upd), e(n_upd), e(nlevels + 1)
        fac, foff = e(n_fac), e(nlevels + 1)
        st, sd, soff = e(n_sol), e(n_sol), e(nlevels + 1)
        fpj, fpk, fps, fpoff = (e(n_fwd_p), e(n_fwd_p), e(n_fwd_p),
                                e(n_fwd_lv + 1))
        fdr, fds, fdoff = e(n_fwd_d), e(n_fwd_d), e(n_fwd_lv + 1)
        bpj, bpk, bps, bpoff = (e(n_bwd_p), e(n_bwd_p), e(n_bwd_p),
                                e(n_bwd_lv + 1))
        bdr, bds, bdoff = e(n_bwd_d), e(n_bwd_d), e(n_bwd_lv + 1)
        lib.chol_symbolic_export(
            ctypes.c_void_p(h), _i32p(out_rows), _i32p(out_cols),
            _i32p(a_slot), _i32p(ut), _i32p(ui), _i32p(uj), _i32p(uoff),
            _i32p(fac), _i32p(foff), _i32p(st), _i32p(sd), _i32p(soff),
            _i32p(fpj), _i32p(fpk), _i32p(fps), _i32p(fpoff),
            _i32p(fdr), _i32p(fds), _i32p(fdoff),
            _i32p(bpj), _i32p(bpk), _i32p(bps), _i32p(bpoff),
            _i32p(bdr), _i32p(bds), _i32p(bdoff))
    finally:
        lib.chol_symbolic_free(ctypes.c_void_p(h))
    sched = OpSchedule(upd_tgt=ut, upd_i=ui, upd_j=uj, upd_off=uoff,
                       fac=fac, fac_off=foff,
                       sol_tgt=st, sol_diag=sd, sol_off=soff)
    fwd = SolveSchedule(pair_j=fpj, pair_k=fpk, pair_slot=fps,
                        pair_off=fpoff, diag_rows=fdr, diag_slot=fds,
                        diag_off=fdoff)
    bwd = SolveSchedule(pair_j=bpj, pair_k=bpk, pair_slot=bps,
                        pair_off=bpoff, diag_rows=bdr, diag_slot=bds,
                        diag_off=bdoff)
    return out_rows, out_cols, a_slot, sched, fwd, bwd


def bcsr_pattern_native(rowptr: np.ndarray, colidx: np.ndarray,
                        nmeas: int, nstate: int,
                        block_rows: int, block_cols: int
                        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(indptr, indices) block pattern from a scalar CSR pattern; None if
    the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rowptr = np.ascontiguousarray(rowptr, np.int64)
    colidx = np.ascontiguousarray(colidx, np.int32)
    nbrow = nmeas // block_rows
    indptr = np.empty(nbrow + 1, np.int32)
    null = ctypes.cast(None, ctypes.POINTER(ctypes.c_int32))
    nnzb = lib.bcsr_block_pattern(_i64p(rowptr), _i32p(colidx), nmeas,
                                  nstate, block_rows, block_cols,
                                  _i32p(indptr), null)
    indices = np.empty(nnzb, np.int32)
    lib.bcsr_block_pattern(_i64p(rowptr), _i32p(colidx), nmeas, nstate,
                           block_rows, block_cols, _i32p(indptr),
                           _i32p(indices))
    return indptr, indices
