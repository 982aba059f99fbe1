"""Native (C++) symbolic-analysis kernels vs the numpy implementations."""

import os
import time

import numpy as np
import pytest

from libdogleg_tpu.native import native_available
from libdogleg_tpu.native.symbolic import (bcsr_pattern_native,
                                           jtj_schedule_native)
from libdogleg_tpu.ops.bcsr import (BCSRStructure, JtJSchedule,
                                    build_jtj_schedule)
from libdogleg_tpu.sparsity import bcsr_from_scalar_csr

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="no native toolchain")


def _random_structure(seed, nbrow=200, nbcol=40, density=0.1):
    rng = np.random.default_rng(seed)
    indptr = np.zeros(nbrow + 1, np.int32)
    cols = []
    for r in range(nbrow):
        k = max(1, rng.binomial(nbcol, density))
        c = np.sort(rng.choice(nbcol, size=k, replace=False)).astype(np.int32)
        cols.append(c)
        indptr[r + 1] = indptr[r] + k
    return BCSRStructure(nmeas=nbrow * 4, nstate=nbcol * 3,
                         block_rows=4, block_cols=3,
                         indptr=indptr, indices=np.concatenate(cols))


def _numpy_schedule(s):
    """The pure-numpy build (duplicated here so the test compares against it
    even while build_jtj_schedule prefers the native path)."""
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


def test_jtj_schedule_matches_numpy():
    s = _random_structure(0)
    nat = jtj_schedule_native(s.indptr, s.indices, s.nbcol)
    ref = _numpy_schedule(s)
    np.testing.assert_array_equal(nat[0], ref.pair_i)
    np.testing.assert_array_equal(nat[1], ref.pair_j)
    np.testing.assert_array_equal(nat[2], ref.out_idx)
    np.testing.assert_array_equal(nat[3], ref.out_ci)
    np.testing.assert_array_equal(nat[4], ref.out_cj)


def test_build_jtj_schedule_uses_native_transparently():
    s = _random_structure(1)
    sched = build_jtj_schedule(s)  # native path
    ref = _numpy_schedule(s)
    np.testing.assert_array_equal(sched.pair_i, ref.pair_i)
    np.testing.assert_array_equal(sched.out_idx, ref.out_idx)


def test_bcsr_pattern_matches_python():
    rng = np.random.default_rng(2)
    nmeas, nstate = 64, 24
    rowptr = [0]
    colidx = []
    for _ in range(nmeas):
        k = rng.integers(1, 6)
        colidx.extend(np.sort(rng.choice(nstate, size=k, replace=False)))
        rowptr.append(len(colidx))
    rowptr = np.asarray(rowptr)
    colidx = np.asarray(colidx, np.int32)

    s_any = bcsr_from_scalar_csr(rowptr, colidx, nmeas, nstate, 4, 3)
    os.environ["LIBDOGLEG_TPU_NATIVE"] = "0"
    try:
        # loader caches; call the pure-python branch directly by monkeypatch
        nat = bcsr_pattern_native(rowptr, colidx, nmeas, nstate, 4, 3)
    finally:
        os.environ.pop("LIBDOGLEG_TPU_NATIVE")
    # nat is None when disabled via env (loader already cached -> may still
    # return). Compare native output against the python loop implementation.
    indptr_n, indices_n = (nat if nat is not None
                           else (s_any.indptr, s_any.indices))
    # python loop reference
    nbrow = nmeas // 4
    indptr_p = np.zeros(nbrow + 1, np.int32)
    per_row = []
    for br in range(nbrow):
        lo, hi = rowptr[br * 4], rowptr[(br + 1) * 4]
        cols = np.unique(colidx[lo:hi] // 3)
        per_row.append(cols.astype(np.int32))
        indptr_p[br + 1] = indptr_p[br] + len(cols)
    np.testing.assert_array_equal(indptr_n, indptr_p)
    np.testing.assert_array_equal(indices_n, np.concatenate(per_row))


def test_native_is_much_faster_on_large_patterns():
    s = _random_structure(3, nbrow=3000, nbcol=300, density=0.03)
    t0 = time.perf_counter()
    nat = jtj_schedule_native(s.indptr, s.indices, s.nbcol)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = _numpy_schedule(s)
    t_numpy = time.perf_counter() - t0
    np.testing.assert_array_equal(nat[2], ref.out_idx)
    assert t_native < t_numpy  # typically 10-100x
