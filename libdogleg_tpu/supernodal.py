"""Supernodal amalgamation for the block-sparse Cholesky.

CHOLMOD's supernodal mode (which the reference disables for license purity
at a measured 25% cost, reference dogleg.c:1595-1599) merges columns with
similar structure into dense panels so the factorization runs on BLAS3. The
An accelerator needs the same medicine more urgently: the level-scheduled simplicial
factorization (sparse_cholesky) issues one batch of b-sized block ops per
dependency level, and for small b the levels are dispatch-bound, not
FLOP-bound.

Amalgamation here is a *pattern coarsening*: after the fill-reducing
ordering, S consecutive elimination-order block columns are merged into one
super-column of size S*b. Any super-block containing a stored sub-block is
stored whole (explicit zeros included — the fill-by-blocking trade). The
result is the SAME matrix factored with the existing uniform-block
machinery at block size S*b: levels shrink ~S-fold and each batched op
grows S^2-fold. Exactness is preserved (the merged diagonal
supers are principal submatrices of the permuted JtJ, so SPD-ness and the
factorization are those of the original matrix, padded with decoupled
identity states when nb % S != 0).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from libdogleg_tpu import sparse_cholesky as sc


@dataclasses.dataclass(frozen=True)
class AmalgamatedSymbolic:
    """Analysis artifact for the amalgamated factorization."""
    inner: sc.SparseCholeskySymbolic   # super-block symbolic (size S*b)
    S: int                             # columns merged per super-column
    nb: int                            # original block count
    b: int                             # original block size
    nb_pad: int                        # nb rounded up to a multiple of S
    perm: np.ndarray                   # (nb,) fill-reducing order (b-level)
    # elementwise scatter of the input (n_input, b, b) values into the
    # (n_super_input, Sb, Sb) super-block tensor (flattened):
    scatter_idx: np.ndarray            # (n_input * b * b,) int64
    # mirror copies for off-diagonal sub-blocks inside diagonal supers:
    mirror_src: np.ndarray             # (n_mirror * b * b,) into flat input
    mirror_idx: np.ndarray             # (n_mirror * b * b,) into flat supers
    ones_idx: np.ndarray               # virtual-padding unit diagonal
    n_super_input: int
    # original input pattern (for quad-form consumers)
    in_rows: np.ndarray
    in_cols: np.ndarray

    @property
    def sb(self) -> int:
        return self.S * self.b


def analyze(rows: np.ndarray, cols: np.ndarray, nb: int, b: int = 1,
            ordering="rcm", amalgamate: int = 4,
            inner_ordering="auto") -> AmalgamatedSymbolic:
    """Symbolic analysis with supernodal amalgamation.

    Args: as sparse_cholesky.analyze, plus amalgamate = S, the number of
    consecutive (post-ordering) block columns merged per supernode. The
    default ordering is "rcm": amalgamation needs consecutive elimination
    columns to be graph-adjacent; minimum degree scatters them (measured
    7x slower than RCM when grouped).

    inner_ordering orders the SUPER pattern's elimination. RCM leaves the
    supers a (near-)chain — O(nb/S) sequential elimination levels, and on
    an accelerator the factorization cost is the level COUNT, not the
    flops (the diag-coupled grid regime runs 511 levels of <=3 block ops
    each). "nd" re-orders
    the supers by nested dissection, collapsing a chain to a log-depth
    elimination tree at modest extra fill. "auto" (default) analyzes both
    and keeps the schedule with fewer total sequential levels (ties to
    "natural"); the super pattern is small, so the double analysis is
    cheap next to the b-level work. Exactness is ordering-invariant.
    """
    S = int(amalgamate)
    assert S >= 1
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    assert np.all(rows >= cols), "pass the lower triangle (i >= j)"
    in_rows, in_cols = rows, cols

    from libdogleg_tpu.ordering import resolve_ordering
    perm = resolve_ordering(ordering, rows, cols, nb).astype(np.int64)
    iperm = np.empty(nb, np.int64)
    iperm[perm] = np.arange(nb)

    nb_pad = ((nb + S - 1) // S) * S
    nb_s = nb_pad // S
    sb = S * b

    # map input blocks into permuted coords, lower triangle at b-level
    pi, pj = iperm[rows], iperm[cols]
    flip = pi < pj
    pi2 = np.where(flip, pj, pi)
    pj2 = np.where(flip, pi, pj)
    si, sj = pi2 // S, pj2 // S
    oi, oj = pi2 % S, pj2 % S

    # super pattern: stored pairs + every diagonal super
    keys = si * nb_s + sj
    uniq_keys = np.unique(np.concatenate(
        [keys, np.arange(nb_s) * nb_s + np.arange(nb_s)]))
    sup_rows = (uniq_keys // nb_s).astype(np.int64)
    sup_cols = (uniq_keys % nb_s).astype(np.int64)
    pair_index = {int(k): idx for idx, k in enumerate(uniq_keys)}
    input_super = np.fromiter((pair_index[int(k)] for k in keys),
                              np.int64, count=keys.shape[0])
    n_super_input = uniq_keys.shape[0]

    # inner symbolic on the super pattern (the b-level fill-reducing
    # ordering is already applied; inner_ordering only re-orders supers)
    def total_levels(s):
        return (s.sched.nlevels + len(s.fwd.pair_off) - 1
                + len(s.bwd.pair_off) - 1)

    if inner_ordering == "auto":
        candidates = ("natural", "nd")
    else:
        candidates = (inner_ordering,)
    inner = None
    for o in candidates:
        cand = sc.analyze(sup_rows, sup_cols, nb_s, sb, ordering=o)
        if inner is None or total_levels(cand) < total_levels(inner):
            inner = cand

    # elementwise scatter: source element (r, c) of input block e lands at
    # super element (oi*b + (c if flip else r), oj*b + (r if flip else c))
    # — flipping transposes the block for pairs that swapped triangles
    rr = np.arange(b)
    e_r = np.broadcast_to(rr[None, :, None], (keys.shape[0], b, b))
    e_c = np.broadcast_to(rr[None, None, :], (keys.shape[0], b, b))
    land_r = oi[:, None, None] * b + np.where(flip[:, None, None], e_c, e_r)
    land_c = oj[:, None, None] * b + np.where(flip[:, None, None], e_r, e_c)
    scatter_idx = (input_super[:, None, None] * (sb * sb)
                   + land_r * sb + land_c).reshape(-1)

    # mirror: off-diagonal sub-blocks inside a DIAGONAL super need their
    # transpose in the upper half of that super (the factorizer treats
    # diagonal blocks as full symmetric matrices)
    need_mirror = (si == sj) & (pi2 != pj2)
    me = np.nonzero(need_mirror)[0]
    if me.size:
        m_land_r = oj[me][:, None, None] * b + np.where(
            flip[me][:, None, None], e_r[me], e_c[me])
        m_land_c = oi[me][:, None, None] * b + np.where(
            flip[me][:, None, None], e_c[me], e_r[me])
        mirror_idx = (input_super[me][:, None, None] * (sb * sb)
                      + m_land_r * sb + m_land_c).reshape(-1)
        mirror_src = ((me[:, None, None] * (b * b)
                       + e_r[me] * b + e_c[me]).reshape(-1))
    else:
        mirror_idx = np.zeros(0, np.int64)
        mirror_src = np.zeros(0, np.int64)

    # virtual padding states (permuted b-rows nb..nb_pad-1) get a unit
    # diagonal so the factor stays SPD and they decouple exactly
    virt = np.arange(nb, nb_pad)
    if virt.size:
        vsup = virt // S
        vo = (virt % S) * b
        vslot = np.asarray([pair_index[int(s * nb_s + s)] for s in vsup],
                           np.int64)
        ones_idx = (vslot[:, None] * (sb * sb)
                    + (vo[:, None] + rr[None, :]) * sb
                    + (vo[:, None] + rr[None, :])).reshape(-1)
    else:
        ones_idx = np.zeros(0, np.int64)

    return AmalgamatedSymbolic(
        inner=inner, S=S, nb=nb, b=b, nb_pad=nb_pad, perm=perm,
        scatter_idx=scatter_idx, mirror_src=mirror_src,
        mirror_idx=mirror_idx, ones_idx=ones_idx,
        n_super_input=n_super_input, in_rows=in_rows, in_cols=in_cols)


def _super_blocks(sym: AmalgamatedSymbolic, input_blocks: jnp.ndarray):
    sb = sym.sb
    dtype = input_blocks.dtype
    flat = jnp.zeros((sym.n_super_input * sb * sb,), dtype)
    flat = flat.at[jnp.asarray(sym.scatter_idx)].add(
        input_blocks.reshape(-1))
    if sym.mirror_idx.size:
        flat = flat.at[jnp.asarray(sym.mirror_idx)].add(
            input_blocks.reshape(-1)[jnp.asarray(sym.mirror_src)])
    if sym.ones_idx.size:
        flat = flat.at[jnp.asarray(sym.ones_idx)].add(1.0)
    return flat.reshape(sym.n_super_input, sb, sb)


def factorize(sym: AmalgamatedSymbolic, input_blocks: jnp.ndarray,
              lam) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Numeric factorization; input_blocks are the ORIGINAL (n_input, b, b)
    lower-triangle blocks, exactly as for sparse_cholesky.factorize."""
    return sc.factorize(sym.inner, _super_blocks(sym, input_blocks), lam)


def solve(sym: AmalgamatedSymbolic, L_blocks: jnp.ndarray,
          rhs: jnp.ndarray) -> jnp.ndarray:
    """rhs: (n,) or (n, k) for k right-hand sides at once."""
    b = sym.b
    dtype = rhs.dtype
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[:, None]
    k = rhs.shape[1]
    yb = rhs.reshape(sym.nb, b, k)[jnp.asarray(sym.perm)]
    yb = jnp.concatenate(
        [yb, jnp.zeros((sym.nb_pad - sym.nb, b, k), dtype)], axis=0)
    x = sc.solve(sym.inner, L_blocks, yb.reshape(sym.nb_pad * b, k))
    xb = x.reshape(sym.nb_pad, b, k)[:sym.nb]
    out = jnp.zeros((sym.nb, b, k), dtype).at[
        jnp.asarray(sym.perm)].set(xb)
    out = out.reshape(sym.nb * b, k)
    return out[:, 0] if squeeze else out


def factorize_with_lambda(sym: AmalgamatedSymbolic,
                          input_blocks: jnp.ndarray, lam, *,
                          lambda_initial: float = 1e-10,
                          lambda_max_tries: int = 60):
    """Escalating-lambda wrapper (reference dogleg.c:656-677 semantics).
    The super blocks are built once; retries only refactor. NOTE: lam lands
    on the FULL super diagonal, including the virtual unit-padding states —
    harmless (they stay decoupled)."""
    from libdogleg_tpu.ops.cholesky import escalating_lambda
    blocks = _super_blocks(sym, input_blocks)
    return escalating_lambda(
        lambda lm: sc.factorize(sym.inner, blocks, lm), lam, blocks.dtype,
        lambda_initial=lambda_initial, lambda_max_tries=lambda_max_tries,
        trace_once=True)
