"""Block-sparse Cholesky (the CHOLMOD replacement) vs dense oracles, and an
end-to-end solve through the driver with SparseNewtonSolver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libdogleg_tpu import DoglegParameters, solve_products
from libdogleg_tpu.ops.newton import SparseNewtonSolver
from libdogleg_tpu.solver import Products
from libdogleg_tpu import sparse_cholesky as sc


def _random_spd_pattern(seed, nb, b, extra_offdiag):
    """A random sparse SPD block matrix: its dense form, stored lower blocks,
    and the pattern coordinate lists."""
    rng = np.random.default_rng(seed)
    n = nb * b
    # sparse symmetric pattern: diagonal + random strictly-lower blocks
    pairs = {(j, j) for j in range(nb)}
    while len(pairs) < nb + extra_offdiag:
        i = rng.integers(1, nb)
        j = rng.integers(0, i)
        pairs.add((int(i), int(j)))
    rows, cols = map(np.asarray, zip(*sorted(pairs, key=lambda t: (t[1],
                                                                   t[0]))))
    dense = np.zeros((n, n))
    blocks = []
    for i, j in zip(rows, cols):
        blk = rng.normal(size=(b, b))
        if i == j:
            blk = blk @ blk.T + b * np.eye(b) * (2 + nb * 0.5)
        else:
            blk = blk * 0.3
        dense[i * b:(i + 1) * b, j * b:(j + 1) * b] = blk
        if i != j:
            dense[j * b:(j + 1) * b, i * b:(i + 1) * b] = blk.T
        blocks.append(blk)
    # ensure SPD
    w = np.linalg.eigvalsh(dense)
    assert w.min() > 0, "test matrix not SPD; adjust construction"
    return dense, jnp.asarray(np.stack(blocks)), rows, cols


@pytest.mark.parametrize("nb,b,extra", [(8, 1, 10), (8, 3, 10), (12, 2, 20),
                                        (5, 4, 6)])
@pytest.mark.parametrize("ordering", ["natural", "mindeg", "nd"])
def test_factorization_matches_dense(nb, b, extra, ordering):
    dense, blocks, rows, cols = _random_spd_pattern(0, nb, b, extra)
    sym = sc.analyze(rows, cols, nb, b, ordering)
    L, ok = sc.factorize(sym, blocks, jnp.asarray(0.0))
    assert bool(ok)
    # reassemble L in the permuted space and check L L^T == P A P^T
    n = nb * b
    Lfull = np.zeros((n, n))
    for k in range(sym.nslots):
        i, j = int(sym.rows[k]), int(sym.cols[k])
        Lfull[i * b:(i + 1) * b, j * b:(j + 1) * b] = np.asarray(L[k])
    # zero strict upper of diagonal blocks
    Lfull = np.tril(Lfull)
    sperm = (sym.perm[:, None] * b + np.arange(b)[None]).reshape(-1)
    np.testing.assert_allclose(Lfull @ Lfull.T, dense[sperm][:, sperm],
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("nb,b,extra", [(8, 1, 10), (10, 3, 18)])
@pytest.mark.parametrize("ordering", ["natural", "mindeg", "nd"])
def test_solve_matches_dense(nb, b, extra, ordering):
    dense, blocks, rows, cols = _random_spd_pattern(1, nb, b, extra)
    sym = sc.analyze(rows, cols, nb, b, ordering)
    L, ok = sc.factorize(sym, blocks, jnp.asarray(0.0))
    assert bool(ok)
    rhs = jnp.asarray(np.random.default_rng(2).normal(size=(nb * b,)))
    x = sc.solve(sym, L, rhs)
    np.testing.assert_allclose(dense @ np.asarray(x), np.asarray(rhs),
                               rtol=1e-8, atol=1e-10)


def test_mindeg_kills_arrow_fill():
    """An arrow matrix with the dense hub FIRST fills completely in natural
    order; the minimum-degree ordering (the cholmod_analyze-equivalent,
    reference dogleg.c:649-654) eliminates the hub last, restoring zero
    fill."""
    nb, b = 24, 2
    rows = np.concatenate([np.arange(nb), np.arange(1, nb)])
    cols = np.concatenate([np.arange(nb), np.zeros(nb - 1, np.int64)])
    order = np.lexsort((rows, cols))
    rows, cols = rows[order], cols[order]

    nat = sc.analyze(rows, cols, nb, b, ordering="natural")
    amd = sc.analyze(rows, cols, nb, b, ordering="mindeg")
    assert nat.nslots == nb * (nb + 1) // 2      # full fill
    assert amd.nslots == rows.shape[0]           # zero fill
    # the hub is not eliminated while it still has high degree
    assert int(amd.perm[0]) != 0

    # numerics agree with the dense oracle under the permutation
    rng = np.random.default_rng(3)
    blocks = []
    dense = np.zeros((nb * b, nb * b))
    for i, j in zip(rows, cols):
        blk = rng.normal(size=(b, b)) * 0.1
        if i == j:
            blk = blk @ blk.T + np.eye(b) * (3 + nb * 0.2)
        dense[i * b:(i + 1) * b, j * b:(j + 1) * b] = blk
        if i != j:
            dense[j * b:(j + 1) * b, i * b:(i + 1) * b] = blk.T
        blocks.append(blk)
    blocks = jnp.asarray(np.stack(blocks))
    L, ok = sc.factorize(amd, blocks, jnp.asarray(0.0))
    assert bool(ok)
    rhs = jnp.asarray(rng.normal(size=(nb * b,)))
    x = sc.solve(amd, L, rhs)
    np.testing.assert_allclose(dense @ np.asarray(x), np.asarray(rhs),
                               rtol=1e-8, atol=1e-10)


def test_symbolic_native_matches_python_builder(monkeypatch):
    """The C++ symbolic builder (csrc/chol_symbolic.cpp) and the pure-Python
    fallback must produce bit-identical schedules."""
    from libdogleg_tpu.native.loader import native_available
    if not native_available():
        pytest.skip("native library unavailable")
    dense, blocks, rows, cols = _random_spd_pattern(9, 14, 2, 30)
    nat = sc.analyze(rows, cols, 14, 2, ordering="mindeg")
    import libdogleg_tpu.native.symbolic as nsym
    monkeypatch.setattr(nsym, "chol_symbolic_native",
                        lambda *a, **k: None)
    py = sc.analyze(rows, cols, 14, 2, ordering="mindeg")
    np.testing.assert_array_equal(nat.rows, py.rows)
    np.testing.assert_array_equal(nat.cols, py.cols)
    np.testing.assert_array_equal(nat.a_slot_of_input, py.a_slot_of_input)
    for field in sc.OpSchedule._fields:
        np.testing.assert_array_equal(getattr(nat.sched, field),
                                      getattr(py.sched, field), err_msg=field)
    for phase in ("fwd", "bwd"):
        for field in sc.SolveSchedule._fields:
            np.testing.assert_array_equal(
                getattr(getattr(nat, phase), field),
                getattr(getattr(py, phase), field),
                err_msg=f"{phase}.{field}")


def test_mindeg_native_matches_python_fallback():
    from libdogleg_tpu import ordering as od
    from libdogleg_tpu.native.loader import native_available
    rng = np.random.default_rng(11)
    nb = 40
    pairs = {(j, j) for j in range(nb)}
    while len(pairs) < nb + 70:
        i = int(rng.integers(1, nb))
        j = int(rng.integers(0, i))
        pairs.add((i, j))
    rows, cols = map(np.asarray, zip(*sorted(pairs)))
    py = od._mindeg_python(rows, cols, nb)
    full = od.mindeg_ordering(rows, cols, nb)
    if native_available():
        np.testing.assert_array_equal(py, full)
    assert np.array_equal(np.sort(full), np.arange(nb))


def test_lambda_escalation_on_singular():
    dense, blocks, rows, cols = _random_spd_pattern(3, 6, 2, 8)
    # zero out one diagonal block -> singular
    kill = 2
    idx = [k for k, (i, j) in enumerate(zip(rows, cols))
           if i == j == kill][0]
    blocks = blocks.at[idx].set(jnp.zeros((2, 2)))
    sym = sc.analyze(rows, cols, 6, 2)
    L, lam, ok = sc.factorize_with_lambda(sym, blocks, jnp.asarray(0.0))
    assert bool(ok) and float(lam) > 0


def test_jittable():
    dense, blocks, rows, cols = _random_spd_pattern(4, 8, 2, 12)
    sym = sc.analyze(rows, cols, 8, 2)
    rhs = jnp.asarray(np.random.default_rng(5).normal(size=(16,)))

    @jax.jit
    def f(blocks, rhs):
        L, ok = sc.factorize(sym, blocks, jnp.asarray(0.0))
        return sc.solve(sym, L, rhs), ok

    x, ok = f(blocks, rhs)
    assert bool(ok)
    np.testing.assert_allclose(dense @ np.asarray(x), np.asarray(rhs),
                               rtol=1e-8, atol=1e-10)


def test_sparse_newton_end_to_end():
    """A sparse nonlinear problem solved through the trust-region driver
    with the block-sparse factorization: chain of coupled oscillators
    (tridiagonal block JtJ)."""
    nb, b = 10, 2
    n = nb * b
    rng = np.random.default_rng(7)
    target = jnp.asarray(rng.normal(size=(n,)))
    # residuals: r_i = p_i - target_i (diag) and coupling
    # r2_k = 0.3*(p_blk[k] - p_blk[k+1]) -> tridiagonal block JtJ
    rows = list(range(nb)) + list(range(1, nb))
    cols = list(range(nb)) + list(range(0, nb - 1))
    rows, cols = np.asarray(rows), np.asarray(cols)
    order = np.lexsort((rows, cols))
    rows, cols = rows[order], cols[order]
    ns = SparseNewtonSolver.analyze(rows, cols, nb, b)

    def products(p):
        pb = p.reshape(nb, b)
        r1 = p - target
        d = pb[:-1] - pb[1:]
        r2 = 0.3 * d.reshape(-1)
        norm2_x = jnp.dot(r1, r1) + jnp.dot(r2, r2)
        # gradient
        g = r1.reshape(nb, b)
        g = g.at[:-1].add(0.3 * 0.3 * d)
        g = g.at[1:].add(-0.3 * 0.3 * d)
        # JtJ blocks on the tridiagonal pattern
        eye = jnp.eye(b)
        diag = jnp.stack([eye * (1 + 0.09 * ((0 < k) + (k < nb - 1)))
                          for k in range(nb)])
        off = jnp.stack([-0.09 * eye for _ in range(nb - 1)])
        blocks_map = {}
        for k in range(nb):
            blocks_map[(k, k)] = diag[k]
        for k in range(nb - 1):
            blocks_map[(k + 1, k)] = off[k]
        blocks = jnp.stack([blocks_map[(int(i), int(j))]
                            for i, j in zip(rows, cols)])
        return Products(norm2_x=norm2_x, Jt_x=g.reshape(-1), JtJ=blocks)

    r = solve_products(products, jnp.zeros(n), DoglegParameters(),
                       newton_solver=ns)
    # quadratic problem: one GN step to optimum; optimum solves
    # (I + 0.09 D^T D) p = target
    assert int(r.step_count) <= 2
    # verify gradient is ~0 at solution
    assert float(jnp.max(jnp.abs(r.Jt_x))) < 1e-10


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("ordering", ["rcm", "natural"])
def test_amalgamated_matches_dense(S, ordering):
    """Supernodal amalgamation (libdogleg_tpu.supernodal) factors the same
    matrix exactly, including the nb % S != 0 virtual-padding case."""
    from libdogleg_tpu import supernodal as sn
    dense, blocks, rows, cols = _random_spd_pattern(21, 13, 3, 22)
    rhs = jnp.asarray(np.random.default_rng(5).normal(size=(13 * 3,)))
    sym = sn.analyze(rows, cols, 13, 3, ordering=ordering, amalgamate=S)
    L, ok = sn.factorize(sym, blocks, jnp.asarray(0.0))
    assert bool(ok)
    x = sn.solve(sym, L, rhs)
    np.testing.assert_allclose(dense @ np.asarray(x), np.asarray(rhs),
                               rtol=1e-8, atol=1e-10)


def test_amalgamated_lambda_escalation():
    from libdogleg_tpu import supernodal as sn
    dense, blocks, rows, cols = _random_spd_pattern(22, 6, 2, 8)
    idx = [k for k, (i, j) in enumerate(zip(rows, cols)) if i == j == 1][0]
    blocks = blocks.at[idx].set(jnp.zeros((2, 2)))
    sym = sn.analyze(rows, cols, 6, 2, amalgamate=2)
    L, lam, ok = sn.factorize_with_lambda(sym, blocks, jnp.asarray(0.0))
    assert bool(ok) and float(lam) > 0


def test_rcm_is_valid_and_banded():
    """RCM returns a permutation and reduces bandwidth on a shuffled band."""
    from libdogleg_tpu.ordering import rcm_ordering
    rng = np.random.default_rng(3)
    nb, band = 60, 3
    shuffle = rng.permutation(nb)
    rows, cols = [], []
    for j in range(nb):
        for i in range(j, min(nb, j + band)):
            a, b = int(shuffle[i]), int(shuffle[j])
            rows.append(max(a, b))
            cols.append(min(a, b))
    rows, cols = np.asarray(rows), np.asarray(cols)
    perm = rcm_ordering(rows, cols, nb)
    assert np.array_equal(np.sort(perm), np.arange(nb))
    iperm = np.empty(nb, np.int64)
    iperm[perm] = np.arange(nb)
    bw_before = int(np.max(np.abs(rows - cols)))
    bw_after = int(np.max(np.abs(iperm[rows] - iperm[cols])))
    assert bw_after <= band + 1 < bw_before


def test_sparse_problem_amalgamated_end_to_end():
    """SparseProblem(jtj='sparse', ordering='rcm', amalgamate=4) takes the
    same trajectory as the dense-JtJ mode."""
    import jax
    from libdogleg_tpu import DoglegParameters, optimize
    from libdogleg_tpu.models import grid_mrf
    from libdogleg_tpu.problems import SparseProblem

    m = grid_mrf.make_grid_mrf(width=6, height=5, block_size=3)
    base = m.problem(jtj="dense")
    amal = SparseProblem(f=base.f, structure=base.structure, jtj="sparse",
                         ordering="rcm", amalgamate=4)
    prm = DoglegParameters()
    p0 = jnp.zeros(m.nstate)
    r_d = optimize(base, p0, prm)
    r_s = jax.jit(lambda q: optimize(
        amal, q, prm, newton_solver=amal.default_newton_solver()))(p0)
    assert int(r_s.step_count) == int(r_d.step_count)
    np.testing.assert_allclose(np.asarray(r_s.p), np.asarray(r_d.p),
                               rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("backend", ["simplicial", "supernodal"])
def test_multi_rhs_solve(backend):
    """Multi-RHS solves against the sparse factors (the covariance/
    outlierness regime; reference chunks of 4 through cholmod_solve,
    dogleg.c:2427)."""
    from libdogleg_tpu import supernodal as sn
    dense, blocks, rows, cols = _random_spd_pattern(31, 10, 3, 16)
    rng = np.random.default_rng(6)
    RHS = jnp.asarray(rng.normal(size=(30, 7)))
    if backend == "simplicial":
        sym = sc.analyze(rows, cols, 10, 3)
        L, ok = sc.factorize(sym, blocks, jnp.asarray(0.0))
        X = sc.solve(sym, L, RHS)
    else:
        sym = sn.analyze(rows, cols, 10, 3, amalgamate=4)
        L, ok = sn.factorize(sym, blocks, jnp.asarray(0.0))
        X = sn.solve(sym, L, RHS)
    assert bool(ok)
    np.testing.assert_allclose(dense @ np.asarray(X), np.asarray(RHS),
                               rtol=1e-8, atol=1e-10)


def test_outlierness_with_sparse_factor():
    """The outlierness suite runs off a block-sparse factorization via
    solve_fn (no dense JtJ factor), matching the dense-factor result."""
    from libdogleg_tpu.analysis import get_outlierness_factors
    from libdogleg_tpu.models import grid_mrf
    from libdogleg_tpu.ops.bcsr import jtj_lower_schedule
    from libdogleg_tpu.ops.cholesky import factorize_jtj

    m = grid_mrf.make_grid_mrf(width=5, height=4, block_size=2)
    prob = m.problem(jtj="sparse")
    p = jnp.asarray(np.random.default_rng(2).normal(size=(m.nstate,)) * .1)
    x, Jd = prob.full(p)
    # dense-factor reference
    fac = factorize_jtj(jnp.asarray(np.asarray(Jd).T @ np.asarray(Jd)),
                        jnp.asarray(0.0))
    f_ref, _ = get_outlierness_factors(x, Jd, fac.L, feature_size=2)
    # sparse factor via solve_fn
    ns = prob.default_newton_solver()
    _, values = prob.f(p)
    from libdogleg_tpu.ops.bcsr import BCSRJacobian, bcsr_jtj_lower_blocks
    blocks = bcsr_jtj_lower_blocks(
        BCSRJacobian(structure=prob.structure, values=values),
        prob._jtj_sched)
    L, lam, ok = sc.factorize_with_lambda(ns.symbolic, blocks,
                                          jnp.asarray(0.0))
    assert bool(ok)
    f_sp, _ = get_outlierness_factors(
        x, Jd, None, feature_size=2,
        solve_fn=lambda r: sc.solve(ns.symbolic, L, r))
    np.testing.assert_allclose(np.asarray(f_sp), np.asarray(f_ref),
                               rtol=1e-8, atol=1e-10)


def test_vmapped_sparse_solves():
    """The level-scheduled factorization vmaps: a batch of problems sharing
    one sparsity pattern (the batched-SLAM regime) solves in one program,
    each lane exact vs its dense oracle."""
    batch = 4
    dense0, blocks0, rows, cols = _random_spd_pattern(40, 9, 3, 14)
    sym = sc.analyze(rows, cols, 9, 3)
    rng = np.random.default_rng(41)

    denses, blockss, rhss = [], [], []
    for _ in range(batch):
        scalefac = 1.0 + rng.uniform(0.1, 2.0)
        blk = np.asarray(blocks0) * scalefac
        # rebuild the dense oracle for the scaled blocks
        d = np.zeros_like(dense0)
        b = 3
        for k, (i, j) in enumerate(zip(rows, cols)):
            d[i*b:(i+1)*b, j*b:(j+1)*b] = blk[k]
            if i != j:
                d[j*b:(j+1)*b, i*b:(i+1)*b] = blk[k].T
        denses.append(d)
        blockss.append(blk)
        rhss.append(rng.normal(size=(27,)))
    blockss = jnp.asarray(np.stack(blockss))
    rhss = jnp.asarray(np.stack(rhss))

    def solve_one(blocks, rhs):
        L, ok = sc.factorize(sym, blocks, jnp.asarray(0.0))
        return sc.solve(sym, L, rhs), ok

    xs, oks = jax.jit(jax.vmap(solve_one))(blockss, rhss)
    assert bool(np.asarray(oks).all())
    for i in range(batch):
        np.testing.assert_allclose(denses[i] @ np.asarray(xs[i]), rhss[i],
                                   rtol=1e-8, atol=1e-10)


def test_vmapped_supernodal_solves():
    """Amalgamated factorization also vmaps (batched shared-pattern
    problems through the supernodal path)."""
    from libdogleg_tpu import supernodal as sn
    dense0, blocks0, rows, cols = _random_spd_pattern(50, 9, 3, 14)
    sym = sn.analyze(rows, cols, 9, 3, amalgamate=4)
    rng = np.random.default_rng(51)
    scales = jnp.asarray(1.0 + rng.uniform(0.1, 2.0, size=3))
    blockss = blocks0[None] * scales[:, None, None, None]
    rhss = jnp.asarray(rng.normal(size=(3, 27)))

    def solve_one(blocks, rhs):
        L, ok = sn.factorize(sym, blocks, jnp.asarray(0.0))
        return sn.solve(sym, L, rhs), ok

    xs, oks = jax.jit(jax.vmap(solve_one))(blockss, rhss)
    assert bool(np.asarray(oks).all())
    for i in range(3):
        d = np.asarray(dense0) * float(scales[i])
        np.testing.assert_allclose(d @ np.asarray(xs[i]),
                                   np.asarray(rhss[i]),
                                   rtol=1e-8, atol=1e-10)


def test_grid_mrf_dense_coupling():
    """coupling='dense' (pose-graph-like dense per-edge mixing blocks —
    the regime where JtJ's off-diagonal blocks are genuinely dense
    instead of secretly diagonal): sparse and dense-JtJ modes agree on
    products and trajectory, and the solve recovers the linear optimum
    in one GN step."""
    import jax
    from libdogleg_tpu import DoglegParameters, optimize
    from libdogleg_tpu.models import grid_mrf
    from libdogleg_tpu.problems import SparseProblem

    m = grid_mrf.make_grid_mrf(width=6, height=5, block_size=3,
                               coupling="dense")
    assert m.mix is not None and m.mix.shape == (m.edges.shape[0], 3, 3)
    base = m.problem(jtj="dense")
    spp = SparseProblem(f=base.f, structure=base.structure, jtj="sparse",
                        ordering="rcm", amalgamate=4)
    p0 = jnp.zeros(m.nstate)
    pr_d = base.products(p0)
    pr_s = spp.products(p0)
    np.testing.assert_allclose(float(pr_s.norm2_x), float(pr_d.norm2_x),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(pr_s.Jt_x),
                               np.asarray(pr_d.Jt_x),
                               rtol=1e-10, atol=1e-12)
    prm = DoglegParameters()
    r_d = optimize(base, p0, prm)
    r_s = jax.jit(lambda q: optimize(
        spp, q, prm, newton_solver=spp.default_newton_solver()))(p0)
    assert int(r_s.step_count) == int(r_d.step_count) == 1
    np.testing.assert_allclose(np.asarray(r_s.p), np.asarray(r_d.p),
                               rtol=1e-8, atol=1e-9)


# ---------------------------------------------------------------------------
# Nested-dissection inner ordering (round 5: the diag-coupled grid regime)
# ---------------------------------------------------------------------------


def _grid_pattern(W):
    idx = lambda i, j: i * W + j
    rows, cols = [], []
    for i in range(W):
        for j in range(W):
            v = idx(i, j)
            rows.append(v); cols.append(v)
            if j + 1 < W:
                rows.append(idx(i, j + 1)); cols.append(v)
            if i + 1 < W:
                rows.append(idx(i + 1, j)); cols.append(v)
    return np.asarray(rows), np.asarray(cols)


def test_nd_collapses_chain_levels():
    """A 64-node chain eliminates in 63 sequential levels naturally; the
    nested-dissection ordering collapses it to O(log n) — the level
    COUNT is the factorization's cost on an accelerator (one batched
    dispatch per level)."""
    n = 64
    rows = np.concatenate([np.arange(n), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(0, n - 1)])
    nat = sc.analyze(rows, cols, n, 1, ordering="natural")
    nd = sc.analyze(rows, cols, n, 1, ordering="nd")
    assert nd.sched.nlevels <= 3 * int(np.ceil(np.log2(n))) + 3
    assert nd.sched.nlevels < nat.sched.nlevels / 4
    # exactness on a random SPD chain matrix
    rng = np.random.default_rng(0)
    nin = rows.shape[0]
    off = rng.normal(size=n - 1) * 0.4
    diag = 2.0 + np.abs(rng.normal(size=n))
    dense = np.diag(diag)
    dense[np.arange(1, n), np.arange(n - 1)] = off
    dense[np.arange(n - 1), np.arange(1, n)] = off
    blocks = np.concatenate([diag, off]).reshape(nin, 1, 1)
    L, ok = sc.factorize(nd, jnp.asarray(blocks), jnp.asarray(0.0))
    assert bool(ok)
    rhs = jnp.asarray(rng.normal(size=n))
    x = sc.solve(nd, L, rhs)
    np.testing.assert_allclose(dense @ np.asarray(x), np.asarray(rhs),
                               rtol=1e-9, atol=1e-10)


def test_supernodal_inner_auto_picks_nd_on_grid():
    """supernodal.analyze(inner_ordering='auto') must pick the ordering
    with fewer sequential levels on the grid pattern, and stay exact."""
    from libdogleg_tpu import supernodal as sn
    W, b, S = 16, 2, 8
    rows, cols = _grid_pattern(W)
    nb = W * W
    nat = sn.analyze(rows, cols, nb, b, ordering="rcm", amalgamate=S,
                     inner_ordering="natural")
    auto = sn.analyze(rows, cols, nb, b, ordering="rcm", amalgamate=S,
                      inner_ordering="auto")
    assert auto.inner.sched.nlevels < nat.inner.sched.nlevels
    # exactness: factorize + solve against a dense assembly
    rng = np.random.default_rng(1)
    nin = rows.shape[0]
    blocks = rng.normal(size=(nin, b, b)) * 0.2
    n = nb * b
    dense = np.zeros((n, n))
    for k in range(nin):
        i, j = int(rows[k]), int(cols[k])
        B = blocks[k]
        dense[i * b:(i + 1) * b, j * b:(j + 1) * b] += B
        dense[j * b:(j + 1) * b, i * b:(i + 1) * b] += B.T
    dense += np.eye(n) * (np.abs(dense).sum(1).max() + 1.0)
    inb = np.empty((nin, b, b))
    for k in range(nin):
        i, j = int(rows[k]), int(cols[k])
        inb[k] = dense[i * b:(i + 1) * b, j * b:(j + 1) * b]
    for sym in (nat, auto):
        L, ok = sn.factorize(sym, jnp.asarray(inb), jnp.asarray(0.0))
        assert bool(ok)
        rhs = jnp.asarray(rng.normal(size=n))
        x = sn.solve(sym, L, rhs)
        np.testing.assert_allclose(dense @ np.asarray(x),
                                   np.asarray(rhs), rtol=1e-9, atol=1e-9)
