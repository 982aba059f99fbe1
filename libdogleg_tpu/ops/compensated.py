"""Error-free transformations: double-f32 residual accumulation.

Why this exists: iterative refinement (ops/newton._refine) can only
correct errors its residual can SEE. A residual r = b - A u computed in
working precision carries rounding noise ~ n*eps*|A||u| — the same order
as the solve error it is trying to measure — so fixed-precision
refinement improves backward stability but barely moves forward error.
The reference never faces this because it is C doubles end-to-end
(reference dogleg.c:125-127 sets 1e-8 thresholds on that assumption).
On f32 device paths the route back toward that contract is a residual
accumulated in ~2x working precision using only f32 hardware ops:
classical compensated arithmetic (Dekker splitting / Knuth two-sum,
Ogita-Rump-Oishi cascaded summation).

All building blocks are elementwise ops — exact f32 adds/multiplies
of split operands — so they are dtype-generic (f32 on the device, f64 under the
x64 test config, where they yield ~quad-precision residuals) and XLA
does not reassociate float arithmetic, so the transformations survive
compilation. The pairwise reduction is log2(n) vectorized rounds, cheap
enough that a refinement pass stays a tiny fraction of a factorization.

Accuracy: each value is represented as a non-overlapping (hi, lo) pair;
products are exact via two_prod, sums keep every rounding term in a
compensation accumulator whose own rounding is O(eps^2) — the collapsed
hi+lo residual is accurate to ~eps RELATIVE TO THE RESIDUAL'S OWN
MAGNITUDE, which is exactly what refinement needs to converge to the
f32 representation floor instead of stalling at cond*eps.
"""

from __future__ import annotations

import jax.numpy as jnp


def two_sum(a, b):
    """Knuth: s + e == a + b exactly, s = fl(a+b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    """Dekker split: a == hi + lo with mantissas short enough that
    products of parts are exact. Split factor 2^ceil(p/2)+1 for the
    dtype's p-bit mantissa (f32: 4097, f64: 2^27+1)."""
    f = 4097.0 if a.dtype == jnp.float32 else float(2 ** 27 + 1)
    c = f * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker/Veltkamp: p + e == a * b exactly, p = fl(a*b).
    (No FMA exposed in JAX, so the 4-part split form.)"""
    p = a * b
    a1, a2 = _split(a)
    b1, b2 = _split(b)
    e = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, e


def comp_reduce(p, e, axis):
    """Sum p along `axis` with a cascaded pairwise two_sum, folding every
    rounding term plus the incoming elementwise error tensor e into a
    compensation. Returns (hi, lo) with hi = fl-pairwise-sum and
    hi + lo ~= the exact sum to O(eps^2)."""
    p = jnp.moveaxis(p, axis, -1)
    c = jnp.sum(jnp.moveaxis(e, axis, -1), axis=-1)
    n = p.shape[-1]
    m = 1 << max(0, n - 1).bit_length()
    if m != n:
        p = jnp.pad(p, [(0, 0)] * (p.ndim - 1) + [(0, m - n)])
    while p.shape[-1] > 1:
        s, err = two_sum(p[..., 0::2], p[..., 1::2])
        c = c + jnp.sum(err, axis=-1)
        p = s
    return p[..., 0], c


def pair_add(h1, l1, h2, l2):
    """(h1+l1) + (h2+l2) as a compensated pair."""
    s, e = two_sum(h1, h2)
    return s, l1 + l2 + e


def pair_add_prod(hi, lo, a, b):
    """(hi+lo) + a*b as a compensated pair (a*b exact via two_prod)."""
    p, pe = two_prod(a, b)
    s, e = two_sum(hi, p)
    return s, lo + pe + e


def comp_matvec(A, u):
    """A @ u as a compensated pair: exact elementwise products, pairwise
    compensated row sums. Materializes one (m, n) error tensor — fine for
    refinement-scale matvecs, not meant for the factorization hot path."""
    p, e = two_prod(A, u[None, :])
    return comp_reduce(p, e, axis=-1)


def comp_contract(A, v, reduce_axes, broadcast):
    """einsum-style compensated contraction: multiply A elementwise by v
    broadcast to A's shape (per `broadcast`: an index expression applied
    to v, e.g. lambda v: v[:, None, None, :]), then compensated-reduce
    over reduce_axes (a tuple, reduced innermost-last via reshape)."""
    vb = jnp.broadcast_to(broadcast(v), A.shape)
    p, e = two_prod(A, vb)
    keep = [d for d in range(A.ndim) if d not in reduce_axes]
    perm = keep + list(reduce_axes)
    p = jnp.transpose(p, perm).reshape(
        tuple(A.shape[d] for d in keep) + (-1,))
    e = jnp.transpose(e, perm).reshape(p.shape)
    return comp_reduce(p, e, axis=-1)


def comp_matvec_pair(Ahi, Alo, u):
    """(Ahi + Alo) @ u as a compensated pair, for matrices stored as
    double-f32 pairs (e.g. Gram matrices whose exact entries exceed f32's
    24-bit integers): exact products with the hi part, the lo-part
    products join the error channel."""
    p, e = two_prod(Ahi, u[None, :])
    return comp_reduce(p, e + Alo * u[None, :], axis=-1)


def pair_dot_pair(u, vhi, vlo):
    """u . (vhi + vlo) as a compensated pair (u plain f32)."""
    p, e = two_prod(u, vhi)
    return comp_reduce(p, e + u * vlo, axis=-1)


def collapse(hi, lo):
    """The f32 value closest to hi + lo."""
    return hi + lo


def residual(b, hi, lo):
    """fl(b - (hi + lo)) accurate to ~eps of the residual's own size:
    the collapsed double-f32 value of b - hi - lo."""
    s, e = two_sum(b, -hi)
    return s + (e - lo)
