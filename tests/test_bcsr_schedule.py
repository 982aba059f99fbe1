"""Block-sparse Jacobian products (ops/bcsr.py) and the JtJ pair schedule,
checked against dense numpy products of the same matrix."""

import jax.numpy as jnp
import numpy as np

from libdogleg_tpu.ops import bcsr as bops


def _block_sparse(seed, nbrow=5, nbcol=4, bm=8, bn=16, density=0.5):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(nbrow, nbcol)) < density
    mask[:, 0] = True
    indptr = np.zeros(nbrow + 1, np.int32)
    cols = []
    for r in range(nbrow):
        c = np.nonzero(mask[r])[0].astype(np.int32)
        cols.append(c)
        indptr[r + 1] = indptr[r] + len(c)
    s = bops.BCSRStructure(nmeas=nbrow * bm, nstate=nbcol * bn,
                           block_rows=bm, block_cols=bn,
                           indptr=indptr, indices=np.concatenate(cols))
    values = jnp.asarray(rng.normal(size=(s.nnzb, bm, bn)), jnp.float64)
    return bops.BCSRJacobian(structure=s, values=values)


def _dense(J):
    return np.asarray(bops.bcsr_to_dense(J), np.float64)


def test_schedule_is_sorted_and_complete():
    J = _block_sparse(0)
    sched = bops.build_jtj_schedule(J.structure)
    keys = sched.out_idx
    assert np.all(np.diff(keys) >= 0)  # contiguous runs
    # every same-row pair appears exactly once
    pi, pj = J.structure.jtj_pairs()
    assert len(sched.pair_i) == len(pi)


def test_schedule_output_blocks_are_the_jtj_pattern():
    J = _block_sparse(7)
    s = J.structure
    sched = bops.build_jtj_schedule(s)
    D = _dense(J)
    nz = np.abs(D.T @ D).reshape(s.nbcol, s.block_cols,
                                 s.nbcol, s.block_cols).sum((1, 3)) > 0
    got = np.zeros_like(nz)
    got[sched.out_ci, sched.out_cj] = True
    np.testing.assert_array_equal(got, nz)


def test_jtj_lower_blocks_match_dense():
    J = _block_sparse(1)
    s = J.structure
    sched = bops.jtj_lower_schedule(s)
    assert np.all(sched.rows >= sched.cols)
    blocks = np.asarray(bops.bcsr_jtj_lower_blocks(J, sched))
    D = _dense(J)
    JtJ = (D.T @ D).reshape(s.nbcol, s.block_cols, s.nbcol, s.block_cols)
    want = JtJ[sched.rows, :, sched.cols, :]
    np.testing.assert_allclose(blocks, want, rtol=1e-12, atol=1e-12)


def test_jtj_dense_matches_numpy():
    J = _block_sparse(2, nbrow=3, nbcol=2)
    D = _dense(J)
    np.testing.assert_allclose(np.asarray(bops.bcsr_jtj_dense(J)),
                               D.T @ D, rtol=1e-12, atol=1e-12)


def test_matvec_matches_numpy():
    J = _block_sparse(3)
    v = np.random.default_rng(4).normal(size=(J.structure.nstate,))
    got = bops.bcsr_matvec(J, jnp.asarray(v))
    np.testing.assert_allclose(np.asarray(got), _dense(J) @ v,
                               rtol=1e-12, atol=1e-12)


def test_jt_x_matches_numpy():
    J = _block_sparse(5)
    x = np.random.default_rng(6).normal(size=(J.structure.nmeas,))
    got = bops.bcsr_jt_x(J, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), _dense(J).T @ x,
                               rtol=1e-12, atol=1e-12)
