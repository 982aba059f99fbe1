"""Packed-triangle <-> full symmetric matrix converters.

The reference's dense-products mode accepts JtJ in LAPACK packed-triangle
storage (row-first packed upper or lower, reference dogleg.h:121-132,
dogleg.c:309-332). Packed storage is a CPU-cache idiom with no benefit on an accelerator
— the solver always works on full symmetric matrices — but these converters
provide API parity for users migrating packed-JtJ callbacks, and are used by
the parity tests.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _triu_indices(n: int):
    return np.triu_indices(n)


def _tril_indices(n: int):
    return np.tril_indices(n)


def packed_to_full(packed: jnp.ndarray, n: int, upper: bool = True
                   ) -> jnp.ndarray:
    """Expand a row-first packed triangle (len n(n+1)/2) to a full symmetric
    (n, n) matrix. `upper=True` matches the reference's packed-upper layout
    [A B C D E F] for [[A B C],[B D E],[C E F]] (dogleg.h:122-129)."""
    rows, cols = _triu_indices(n) if upper else _tril_indices(n)
    full = jnp.zeros(packed.shape[:-1] + (n, n), packed.dtype)
    full = full.at[..., rows, cols].set(packed)
    full = full.at[..., cols, rows].set(packed)
    return full


def full_to_packed(full: jnp.ndarray, upper: bool = True) -> jnp.ndarray:
    """Pack one triangle of a symmetric (n, n) matrix row-first."""
    n = full.shape[-1]
    rows, cols = _triu_indices(n) if upper else _tril_indices(n)
    return full[..., rows, cols]
