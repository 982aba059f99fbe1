"""Block-sparse Cholesky: this library's replacement for CHOLMOD.

The reference factors sparse JtJ with CHOLMOD's simplicial Cholesky
(supernodal disabled for license purity at a 25% speed cost, reference
dogleg.c:1595-1599), with a one-time symbolic analysis (dogleg.c:649-654).
XLA has no sparse direct solver; this module builds one from the two
primitives an accelerator is good at — batched dense block ops and static
schedules:

  symbolic (host, once per pattern):
    * a fill-reducing minimum-degree ordering (libdogleg_tpu.ordering — the
      AMD step inside cholmod_analyze)
    * symbolic fill on the block pattern (elimination in block-column order)
    * an operation DAG — UPDATE(i,j,k): C_ij -= L_ik L_jk^T,
      FACTOR(j): L_jj = chol(C_jj), SOLVE(i,j): L_ij = C_ij L_jj^{-T} —
      scheduled into ASAP dependency levels
    * level schedules for the forward/backward block-triangular solves
    The builder is native C++ (csrc/chol_symbolic.cpp) with an
    identical-output pure-Python fallback.

  numeric (jitted, per factorization):
    * one pass over the levels; each level is a *batch* of independent block
      ops: gathered blocks -> vmapped Cholesky / batched triangular solve /
      batched matmul -> scatter(-add) back. Parallelism = level width,
      exactly the elimination-tree parallelism CHOLMOD exploits with
      threads, here expressed as batched XLA ops.

Failure (non-SPD pivot) is detected per FACTOR op and or-reduced, feeding
the same permanent escalating-lambda loop as the dense path (reference
dogleg.c:670-676). Works for any uniform block size b >= 1 (b == 1 is a
scalar simplicial factorization, CHOLMOD's regime; b in matrix-tile sizes is
the supernodal-style regime).

Why the numeric factorization is deliberately SINGLE-DEVICE (round-2
analysis of SURVEY.md section 7 hard part 1 / "sharded supernodal"):
measured level-width statistics on the RCM+amalgamated grid-MRF family —
nstate=8192: 127 levels, mean 1.3 / max 3 update ops per level;
nstate=32768: 511 levels, mean 3.4 / p90 10 / max 10 update ops per level.
Sharding a width-<=10 batch of 128-wide block ops over a mesh leaves <=2
ops per device and inserts a collective (or a resharding of gathered
slots) into EVERY one of the ~500 SEQUENTIAL levels; per-level compute
(~10 blocks x 2*128^3 flops ~ microseconds at matrix-unit rate) is the
same order as one collective's latency, so the mesh would at best break
even. The factorization's bottleneck is the
elimination-tree critical path (level COUNT), which no data sharding
shortens. The distributed answer for huge nstate is structural
decomposition instead — Schur elimination over pytree states with the
point/camera shards on the mesh (ops/newton.TreeSchurNewtonSolver,
parallel/sharded.MeasurementShardedSparseProblem), which communicates
once per products evaluation, not once per elimination level.

Two batched-factorization swap attempts are also recorded: replacing the
per-level lax.linalg block ops with ops/blockchol's unrolled panels never
finished compiling inside the level scan (>15 min at super-block 128 AND
64, vs ~80 s baseline — the unrolled DAG multiplies across the scan's
gather/scatter structure). The lax.linalg block ops stay.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from libdogleg_tpu.ops import smallchol


# --------------------------------------------------------------------------
# Symbolic phase (host; native C++ with Python fallback; once per pattern)
# --------------------------------------------------------------------------

class OpSchedule(NamedTuple):
    """Factorization ops flattened with per-level offsets: level k's ops are
    slice(off[k], off[k+1]) of each flat array. The three op kinds share one
    level axis."""
    upd_tgt: np.ndarray   # (n_upd,) L-slot receiving C_ij -= L_ik L_jk^T
    upd_i: np.ndarray     # (n_upd,) L-slot of L_ik
    upd_j: np.ndarray     # (n_upd,) L-slot of L_jk
    upd_off: np.ndarray   # (nlevels + 1,)
    fac: np.ndarray       # (n_fac,) L-slots of diagonal blocks to factor
    fac_off: np.ndarray   # (nlevels + 1,)
    sol_tgt: np.ndarray   # (n_sol,) L-slots of off-diagonal blocks to solve
    sol_diag: np.ndarray  # (n_sol,) L-slots of the corresponding L_jj
    sol_off: np.ndarray   # (nlevels + 1,)

    @property
    def nlevels(self) -> int:
        return int(self.upd_off.shape[0]) - 1


class SolveSchedule(NamedTuple):
    """One triangular-substitution direction, flattened with offsets."""
    pair_j: np.ndarray    # (n_pairs,) destination block-row
    pair_k: np.ndarray    # (n_pairs,) source block-row (already final)
    pair_slot: np.ndarray  # (n_pairs,) L-slot of the coupling block
    pair_off: np.ndarray  # (nlevels + 1,)
    diag_rows: np.ndarray  # (n_diag,) block-rows finalized per level
    diag_slot: np.ndarray  # (n_diag,) L-slots of their diagonal blocks
    diag_off: np.ndarray  # (nlevels + 1,)


@dataclasses.dataclass(frozen=True)
class SparseCholeskySymbolic:
    """The one-time analysis artifact (the cholmod_analyze equivalent).

    All structural fields live in the *permuted* (elimination-order) space;
    perm maps back: permuted block row j is original block perm[j]. The
    numeric entry points (factorize / solve) apply the permutation
    internally, so callers always pass data in the original order — the same
    contract as CHOLMOD, whose factor carries its own fill-reducing
    permutation."""
    nb: int                       # number of block rows/cols
    b: int                        # block size
    # Filled lower pattern in (row, col) coordinate lists, diagonal included;
    # slot k of the numeric values array holds block (rows[k], cols[k]).
    rows: np.ndarray
    cols: np.ndarray
    diag_slot_of: np.ndarray      # (nb,) slot of each diagonal block
    sched: OpSchedule
    fwd: SolveSchedule
    bwd: SolveSchedule
    # scatter map for loading A's blocks into the filled slots:
    a_slot_of_input: np.ndarray   # (n_input_blocks,) slot per input block
    # whether each input block lands transposed (its unordered (i, j) pair
    # flipped triangles under the permutation):
    a_transpose: np.ndarray       # (n_input_blocks,) bool
    # fill-reducing permutation: perm[k] = original block eliminated k-th.
    perm: np.ndarray              # (nb,)
    # the input (unfilled) pattern in ORIGINAL coordinates, for quad-form
    # style consumers:
    in_rows: np.ndarray
    in_cols: np.ndarray

    @property
    def nslots(self) -> int:
        return int(self.rows.shape[0])


def _flatten_level_lists(per_level: List[Dict[str, list]],
                         keys: Tuple[str, ...]) -> Tuple[np.ndarray, ...]:
    """Concatenate per-level python lists into flat arrays + one offsets
    array (shared across the given keys' counts... each key gets its own)."""
    out = []
    for key in keys:
        flat = np.asarray(
            [v for d in per_level for v in d[key]], np.int32)
        off = np.zeros(len(per_level) + 1, np.int32)
        for k, d in enumerate(per_level):
            off[k + 1] = off[k] + len(d[key])
        out.append((flat, off))
    return tuple(out)


def _bucket_solve_schedule(nb, level_of, slot, pairs_of) -> "SolveSchedule":
    """Build a SolveSchedule by emitting rows in ascending-j order and
    stably bucketing by level (avoids the O(nlevels * nb) level scan)."""
    nl = int(level_of.max()) + 1 if nb else 0
    pj, pk, ps, p_lv = [], [], [], []
    dr, ds, d_lv = [], [], []
    for j in range(nb):
        lv = int(level_of[j])
        dr.append(j)
        ds.append(slot[(j, j)])
        d_lv.append(lv)
        for k, sl in pairs_of(j):
            pj.append(j)
            pk.append(k)
            ps.append(sl)
            p_lv.append(lv)

    def bucket(arrs, lv_list):
        lv = np.asarray(lv_list, np.int64)
        order = np.argsort(lv, kind="stable")
        off = np.zeros(nl + 1, np.int32)
        np.add.at(off, lv + 1, 1)
        off = np.cumsum(off).astype(np.int32)
        return [np.asarray(a, np.int32)[order] for a in arrs] + [off]

    pj, pk, ps, poff = bucket((pj, pk, ps), p_lv)
    dr, ds, doff = bucket((dr, ds), d_lv)
    return SolveSchedule(pair_j=pj, pair_k=pk, pair_slot=ps, pair_off=poff,
                         diag_rows=dr, diag_slot=ds, diag_off=doff)


def _symbolic_python(rows: np.ndarray, cols: np.ndarray, nb: int):
    """Pure-Python symbolic builder; same outputs as the native kernel."""
    # --- symbolic fill: column j's below-diagonal structure propagates to
    # its elimination parent (classic simplicial fill).
    colsets: List[set] = [set() for _ in range(nb)]   # i > j entries
    for i, j in zip(rows, cols):
        if i != j:
            colsets[j].add(int(i))
    for j in range(nb):
        s = colsets[j]
        if s:
            parent = min(s)
            colsets[parent] |= {i for i in s if i != parent}

    # --- slot layout: all diagonal blocks, then column-major off-diagonals.
    out_rows, out_cols = [], []
    slot = {}
    for j in range(nb):
        slot[(j, j)] = len(out_rows)
        out_rows.append(j)
        out_cols.append(j)
    for j in range(nb):
        for i in sorted(colsets[j]):
            slot[(i, j)] = len(out_rows)
            out_rows.append(i)
            out_cols.append(j)

    a_slot_of_input = np.array([slot[(int(i), int(j))]
                                for i, j in zip(rows, cols)], np.int32)

    # --- operation DAG with ASAP levels.
    sol_level = {}
    per_level_ops: List[dict] = []

    def level_dict(lv):
        while len(per_level_ops) <= lv:
            per_level_ops.append({"ut": [], "ui": [], "uj": [],
                                  "f": [], "st": [], "sd": []})
        return per_level_ops[lv]

    # upd_ready[slot] = level after which the C block at `slot` has
    # received all its updates from columns k < its column.
    upd_ready = np.zeros(len(out_rows), np.int64)

    for j in range(nb):
        # FACTOR(j): after every update targeting (j, j).
        fl = int(upd_ready[slot[(j, j)]])
        level_dict(fl)["f"].append(slot[(j, j)])

        struct_j = sorted(colsets[j])
        # SOLVE(i, j) for each i in column j's structure.
        for i in struct_j:
            sl = max(fl, int(upd_ready[slot[(i, j)]])) + 1
            sol_level[(i, j)] = sl
            d = level_dict(sl)
            d["st"].append(slot[(i, j)])
            d["sd"].append(slot[(j, j)])
        # UPDATE ops from column j: for every pair (a <= c) in struct_j,
        # C_{c,a} -= L_{c,j} L_{a,j}^T. (Targets exist by the fill property.)
        for ai, a in enumerate(struct_j):
            for c in struct_j[ai:]:
                ul = max(sol_level[(a, j)], sol_level[(c, j)]) + 1
                tgt = slot[(c, a)]
                d = level_dict(ul)
                d["ut"].append(tgt)
                d["ui"].append(slot[(c, j)])
                d["uj"].append(slot[(a, j)])
                upd_ready[tgt] = max(upd_ready[tgt], ul)

    ((ut, uoff), (ui, _), (uj, _), (f, foff),
     (st, soff), (sd, _)) = _flatten_level_lists(
        per_level_ops, ("ut", "ui", "uj", "f", "st", "sd"))
    sched = OpSchedule(upd_tgt=ut, upd_i=ui, upd_j=uj, upd_off=uoff,
                       fac=f, fac_off=foff,
                       sol_tgt=st, sol_diag=sd, sol_off=soff)

    # --- forward-substitution levels: y_j finalized after all y_k it reads.
    row_struct: List[List[int]] = [[] for _ in range(nb)]  # (j, k) k<j
    for j in range(nb):
        for i in colsets[j]:
            row_struct[i].append(j)
    f_level = np.zeros(nb, np.int64)
    for j in range(nb):
        f_level[j] = (max((f_level[k] for k in row_struct[j]), default=-1)
                      + 1)
    fwd = _bucket_solve_schedule(
        nb, f_level, slot,
        pairs_of=lambda j: [(k, slot[(j, k)]) for k in row_struct[j]])

    # --- backward-substitution levels: x_j after all x_i with i in col j.
    b_level = np.zeros(nb, np.int64)
    for j in range(nb - 1, -1, -1):
        b_level[j] = (max((b_level[i] for i in colsets[j]), default=-1) + 1)
    bwd = _bucket_solve_schedule(
        nb, b_level, slot,
        pairs_of=lambda j: [(i, slot[(i, j)]) for i in sorted(colsets[j])])

    return (np.asarray(out_rows, np.int32), np.asarray(out_cols, np.int32),
            a_slot_of_input, sched, fwd, bwd)


def analyze(rows: np.ndarray, cols: np.ndarray, nb: int,
            b: int = 1, ordering="mindeg") -> SparseCholeskySymbolic:
    """Symbolic analysis of a symmetric block pattern.

    Args:
      rows, cols: block coordinates of the stored lower triangle of JtJ
        (i >= j), diagonal blocks required present.
      nb: number of block rows/cols; b: block size.
      ordering: fill-reducing ordering — "mindeg"/"amd" (default; the
        CHOLMOD-analyze equivalent, see libdogleg_tpu.ordering), "natural",
        or an explicit permutation array perm[k] = original block k-th in
        elimination order.
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    assert np.all(rows >= cols), "pass the lower triangle (i >= j)"
    in_rows, in_cols = rows, cols

    # --- fill-reducing permutation, then map the pattern into elimination
    # order. An input block whose (i, j) pair flips triangles lands
    # transposed (B at (i, j) is B^T at (j, i)).
    from libdogleg_tpu.ordering import resolve_ordering
    perm = resolve_ordering(ordering, rows, cols, nb)
    iperm = np.empty(nb, np.int64)
    iperm[perm] = np.arange(nb)
    pi, pj = iperm[rows], iperm[cols]
    a_transpose = pi < pj
    rows = np.where(a_transpose, pj, pi)
    cols = np.where(a_transpose, pi, pj)

    from libdogleg_tpu.native.symbolic import chol_symbolic_native
    built = chol_symbolic_native(rows, cols, nb)
    if built is None:
        built = _symbolic_python(rows, cols, nb)
    out_rows, out_cols, a_slot_of_input, sched, fwd, bwd = built

    return SparseCholeskySymbolic(
        nb=nb, b=b, rows=out_rows, cols=out_cols,
        diag_slot_of=np.arange(nb, dtype=np.int64),
        sched=sched, fwd=fwd, bwd=bwd,
        a_slot_of_input=a_slot_of_input, a_transpose=a_transpose,
        perm=perm.astype(np.int64), in_rows=in_rows, in_cols=in_cols)


# --------------------------------------------------------------------------
# Numeric phase (jitted)
# --------------------------------------------------------------------------

def _chol_blocks(blocks):
    """Batched dense Cholesky of (k, b, b) blocks; per-block ok flags."""
    b = blocks.shape[-1]
    if b <= smallchol.SMALL_N_MAX:
        return smallchol.small_cholesky(blocks)
    L = jnp.linalg.cholesky(blocks)
    diag = jnp.diagonal(L, axis1=-2, axis2=-1)
    ok = (jnp.all(jnp.isfinite(L), axis=(-2, -1))
          & jnp.all(diag > 0, axis=-1))
    return L, ok


def _pad(flat: np.ndarray, off: np.ndarray, fill: int) -> np.ndarray:
    """Stack flat+offsets into a rectangular (nlevels, max_width) int32
    array so the numeric phase is one lax.scan instead of an unrolled
    program. Padding entries hold `fill` (a trash slot/row index)."""
    nl = off.shape[0] - 1
    counts = np.diff(off)
    width = max(int(counts.max(initial=0)), 1)
    out = np.full((nl, width), fill, np.int32)
    mask = np.arange(width)[None, :] < counts[:, None]
    out[mask] = flat
    return out


def _chunk_boundaries(weights: np.ndarray, max_chunks: int = 16):
    """Split the level axis into contiguous runs so each run is padded to
    its own max width. Level widths vary by orders of magnitude along the
    elimination (thin chain levels vs wide supernodal fronts); one global
    pad wastes up to ~70x (measured on a 24x24 grid MRF). Runs start where
    the log2 width class changes; adjacent runs are then merged
    cheapest-first until at most max_chunks remain (bounding compile time
    to max_chunks scans)."""
    n = weights.shape[0]
    if n == 0:
        return [(0, 0)]
    classes = np.floor(np.log2(np.maximum(weights, 1))).astype(np.int64)
    bounds = [0] + [i for i in range(1, n)
                    if classes[i] != classes[i - 1]] + [n]
    chunks = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]

    def cost(lo, hi):
        return (hi - lo) * int(weights[lo:hi].max(initial=0))

    while len(chunks) > max_chunks:
        best, best_inc = None, None
        for i in range(len(chunks) - 1):
            lo, mid = chunks[i]
            _, hi = chunks[i + 1]
            inc = cost(lo, hi) - cost(lo, mid) - cost(mid, hi)
            if best_inc is None or inc < best_inc:
                best, best_inc = i, inc
        lo, _ = chunks[best]
        _, hi = chunks.pop(best + 1)
        chunks[best] = (lo, hi)
    return chunks


def _slice_sched(s: OpSchedule, lo: int, hi: int) -> OpSchedule:
    """The sub-schedule of levels [lo, hi) with rebased offsets."""
    def cut(flat, off):
        return flat[off[lo]:off[hi]], (off[lo:hi + 1] - off[lo])
    ut, uoff = cut(s.upd_tgt, s.upd_off)
    ui, _ = cut(s.upd_i, s.upd_off)
    uj, _ = cut(s.upd_j, s.upd_off)
    f, foff = cut(s.fac, s.fac_off)
    st, soff = cut(s.sol_tgt, s.sol_off)
    sd, _ = cut(s.sol_diag, s.sol_off)
    return OpSchedule(upd_tgt=ut, upd_i=ui, upd_j=uj, upd_off=uoff,
                      fac=f, fac_off=foff,
                      sol_tgt=st, sol_diag=sd, sol_off=soff)


def _sched_chunks(s: OpSchedule, max_chunks: int = 16):
    # flop-weighted width proxy: UPDATE ~2 b^3, SOLVE ~b^3, FACTOR ~b^3/3
    w = (2 * np.diff(s.upd_off) + np.diff(s.sol_off)
         + np.maximum(np.diff(s.fac_off), 1))
    return [_slice_sched(s, lo, hi)
            for lo, hi in _chunk_boundaries(w, max_chunks)]


def _slice_solve(s: SolveSchedule, lo: int, hi: int) -> SolveSchedule:
    def cut(flat, off):
        return flat[off[lo]:off[hi]], (off[lo:hi + 1] - off[lo])
    pj, poff = cut(s.pair_j, s.pair_off)
    pk, _ = cut(s.pair_k, s.pair_off)
    ps, _ = cut(s.pair_slot, s.pair_off)
    dr, doff = cut(s.diag_rows, s.diag_off)
    ds, _ = cut(s.diag_slot, s.diag_off)
    return SolveSchedule(pair_j=pj, pair_k=pk, pair_slot=ps, pair_off=poff,
                         diag_rows=dr, diag_slot=ds, diag_off=doff)


def _solve_chunks(s: SolveSchedule, max_chunks: int = 8):
    w = np.diff(s.pair_off) + np.diff(s.diag_off)
    return [_slice_solve(s, lo, hi)
            for lo, hi in _chunk_boundaries(w, max_chunks)]


def _pad_levels(sched: OpSchedule, nslots: int):
    """Rectangular (nlevels, max_k) tensors for the factorization scan.
    Padding ops target a trash slot (index nslots) and are masked where they
    matter. Vectorized numpy — O(total ops), no Python per-level loop."""
    upd_tgt = _pad(sched.upd_tgt, sched.upd_off, nslots)
    upd_i = _pad(sched.upd_i, sched.upd_off, 0)
    upd_j = _pad(sched.upd_j, sched.upd_off, 0)
    fac = _pad(sched.fac, sched.fac_off, nslots)
    fac_valid = fac != nslots
    sol_tgt = _pad(sched.sol_tgt, sched.sol_off, nslots)
    sol_diag = _pad(sched.sol_diag, sched.sol_off, 0)
    return (upd_tgt, upd_i, upd_j, fac, fac_valid, sol_tgt, sol_diag)


def _pad_solve_levels(ss: SolveSchedule, nb: int):
    pair_j = _pad(ss.pair_j, ss.pair_off, nb)       # trash row
    pair_k = _pad(ss.pair_k, ss.pair_off, 0)
    pair_slot = _pad(ss.pair_slot, ss.pair_off, 0)
    diag_rows = _pad(ss.diag_rows, ss.diag_off, nb)  # trash row
    diag_slot = _pad(ss.diag_slot, ss.diag_off, 0)
    return (pair_j, pair_k, pair_slot, diag_rows, diag_slot)


def _tri_solve_right(Ldiag, C):
    """X such that X Ldiag^T = C  (batched over leading axis)."""
    # solve Ldiag Y = C^T  => X = Y^T
    Y = jax.lax.linalg.triangular_solve(Ldiag, jnp.swapaxes(C, -1, -2),
                                        left_side=True, lower=True)
    return jnp.swapaxes(Y, -1, -2)


def factorize(sym: SparseCholeskySymbolic,
              input_blocks: jnp.ndarray,
              lam) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Numeric factorization of the block matrix whose stored lower-triangle
    blocks (in the order passed to analyze) are input_blocks (n_input, b, b),
    damped by lam on the diagonal. Returns (L_blocks (nslots, b, b), ok)."""
    b = sym.b
    dtype = input_blocks.dtype
    # Blocks whose (i, j) pair flipped triangles under the fill-reducing
    # permutation enter transposed.
    if b > 1 and bool(np.any(sym.a_transpose)):
        input_blocks = jnp.where(
            jnp.asarray(sym.a_transpose)[:, None, None],
            jnp.swapaxes(input_blocks, -1, -2), input_blocks)
    # one extra trash slot absorbs the padded (inactive) ops of the scan
    vals = jnp.zeros((sym.nslots + 1, b, b), dtype)
    vals = vals.at[jnp.asarray(sym.a_slot_of_input)].add(input_blocks)
    eye = jnp.eye(b, dtype=dtype)
    vals = vals.at[jnp.asarray(sym.diag_slot_of)].add(lam * eye)

    def level_step(carry, xs):
        vals, ok = carry
        ut, ui, uj, fc, fv, st, sd = xs
        Li = vals[ui]
        Lj = vals[uj]
        contrib = jnp.einsum('kab,kcb->kac', Li, Lj,
                             preferred_element_type=dtype)
        vals = vals.at[ut].add(-contrib)
        blocks = vals[fc]
        L, blk_ok = _chol_blocks(blocks)
        vals = vals.at[fc].set(L)
        ok = ok & jnp.all(jnp.where(fv, blk_ok, True))
        C = vals[st]
        D = vals[sd]
        vals = vals.at[st].set(_tri_solve_right(D, C))
        return (vals, ok), None

    # one scan per contiguous width class: level widths vary by orders of
    # magnitude along the elimination, and padding every level to the
    # global max wastes up to ~70x of the batched-op work
    carry = (vals, jnp.asarray(True))
    for chunk in _sched_chunks(sym.sched):
        xs = tuple(jnp.asarray(a) for a in _pad_levels(chunk, sym.nslots))
        carry, _ = jax.lax.scan(level_step, carry, xs)
    vals, ok = carry
    return vals[:sym.nslots], ok


def solve(sym: SparseCholeskySymbolic,
          L_blocks: jnp.ndarray,
          rhs: jnp.ndarray) -> jnp.ndarray:
    """Solve (P^T L L^T P) x = rhs with the block-sparse factor, P being the
    fill-reducing permutation baked into the symbolic analysis. rhs is in
    the caller's original block order: (nb*b,), or (nb*b, k) for k
    right-hand sides at once (the covariance/outlierness regime — the
    reference pushes chunks of 4 through cholmod_solve, dogleg.c:2427)."""
    b = sym.b
    dtype = rhs.dtype
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[:, None]
    k = rhs.shape[1]
    perm = jnp.asarray(sym.perm)
    # extra trash row absorbs padded ops
    y = jnp.concatenate([rhs.reshape(sym.nb, b, k)[perm],
                         jnp.zeros((1, b, k), dtype)], axis=0)

    def tri(Ld, v, transpose):
        return jax.lax.linalg.triangular_solve(
            Ld, v, left_side=True, lower=True, transpose_a=transpose)

    def phase(y, ss, transpose, transpose_coupling):
        def step(y, lev):
            pj, pk, ps, dr, ds = lev
            blk = L_blocks[ps]
            if transpose_coupling:
                # backward: subtract L_{i,j}^T x_i from row j
                contrib = jnp.einsum('nba,nbr->nar', blk, y[pk],
                                     preferred_element_type=dtype)
            else:
                contrib = jnp.einsum('nab,nbr->nar', blk, y[pk],
                                     preferred_element_type=dtype)
            y = y.at[pj].add(-contrib)
            y = y.at[dr].set(tri(L_blocks[ds], y[dr], transpose))
            return y, None

        for chunk in _solve_chunks(ss):
            xs = tuple(jnp.asarray(a)
                       for a in _pad_solve_levels(chunk, sym.nb))
            y, _ = jax.lax.scan(step, y, xs)
        return y

    y = phase(y, sym.fwd, transpose=False, transpose_coupling=False)
    y = phase(y, sym.bwd, transpose=True, transpose_coupling=True)
    # un-permute: original block perm[j] holds permuted solution block j
    out = jnp.zeros((sym.nb, b, k), dtype).at[perm].set(y[:sym.nb])
    out = out.reshape(sym.nb * b, k)
    return out[:, 0] if squeeze else out


def factorize_with_lambda(sym: SparseCholeskySymbolic,
                          input_blocks: jnp.ndarray,
                          lam,
                          *,
                          lambda_initial: float = 1e-10,
                          lambda_max_tries: int = 60):
    """The permanent escalating-lambda loop around the sparse factorization
    (same semantics as the dense path / reference dogleg.c:656-677)."""
    from libdogleg_tpu.ops.cholesky import escalating_lambda
    return escalating_lambda(
        lambda lm: factorize(sym, input_blocks, lm), lam,
        input_blocks.dtype, lambda_initial=lambda_initial,
        lambda_max_tries=lambda_max_tries, trace_once=True)
