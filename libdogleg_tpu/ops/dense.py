"""Dense step-computation primitives.

The reference implements these as scalar C loops over packed/CSR storage
(reference dogleg.c:186-347, 529-617, 927-998, 1085-1165, 1300-1356). Here
they are expressed as whole-array jnp ops so XLA can fuse them and tile the
contractions onto the matrix units. All functions are shape-polymorphic over a leading
batch via vmap and contain no Python control flow on traced values.

The central design difference from the reference: every quantity the
trust-region iteration needs is derived from the products (norm2_x, Jt_x, JtJ)
— e.g. norm2(J v) is computed as the quadratic form v^T (J^T J) v (the
identity the reference uses only in its DENSE_PRODUCTS mode, reference
dogleg.c:580-602, 1129-1163) instead of a second pass over the measurement
axis. This makes the measurement axis disappear after one contraction, which
is what lets solves batch and shard.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


def build_jtj(J: jnp.ndarray) -> jnp.ndarray:
    """J^T J for a dense (Nmeasurements, Nstate) Jacobian.

    Replaces the reference's packed-upper outer-product accumulation
    (accum_outerproduct_packed_upper, reference dogleg.c:283-307, used at
    dogleg.c:709-714) with a single matmul.
    """
    return jnp.matmul(J.T, J, preferred_element_type=J.dtype)


def jt_dot(J: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """J^T x (the gradient direction; reference mul_matrix_t_densevector,
    dogleg.c:249-261 sparse / dense variant at dogleg.c:1045)."""
    return jnp.matmul(J.T, x, preferred_element_type=J.dtype)


def quad_form(JtJ: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """v^T (J^T J) v == norm2(J v) (reference mul_xt_A_x, dogleg.c:335-347)."""
    return jnp.dot(v, jnp.matmul(JtJ, v, preferred_element_type=JtJ.dtype))


def norm2(v: jnp.ndarray) -> jnp.ndarray:
    """Sum of squares (reference norm2, dogleg.c:193-199)."""
    return jnp.dot(v, v)


class CauchyStep(NamedTuple):
    step: jnp.ndarray        # (Nstate,)
    norm2_step: jnp.ndarray  # scalar
    k: jnp.ndarray           # scalar: step = k * Jt_x


def cauchy_step(Jt_x: jnp.ndarray, JtJ: jnp.ndarray) -> CauchyStep:
    """Steepest-descent minimizer of the local quadratic model.

    k = -norm2(Jt x) / norm2(J Jt x), step = k * Jt x (derivation in the
    reference at dogleg.c:536-550; computed at dogleg.c:556-610). The
    denominator uses the quadratic-form identity norm2(J v) = v^T JtJ v
    (reference dogleg.c:580-602).
    """
    n2_jtx = norm2(Jt_x)
    n2_j_jtx = quad_form(JtJ, Jt_x)
    k = -n2_jtx / n2_j_jtx
    return CauchyStep(step=k * Jt_x, norm2_step=k * k * n2_jtx, k=k)


class InterpolatedStep(NamedTuple):
    step: jnp.ndarray        # (Nstate,)
    norm2_step: jnp.ndarray  # scalar
    k: jnp.ndarray           # scalar in [0, 1]: cauchy -> gn interpolation


def interpolated_step(cauchy: jnp.ndarray,
                      norm2_cauchy: jnp.ndarray,
                      gn: jnp.ndarray,
                      trustregion: jnp.ndarray) -> InterpolatedStep:
    """Dog-leg interpolation: the point on the segment cauchy -> gn that
    crosses the trust-region sphere.

    Solves norm2(a + k (b - a)) = tr^2 for k via the closed-form quadratic,
    taking the + root and clamping a (numerically) negative discriminant to
    zero, exactly as the reference (dogleg.c:936-987). `a` is the Cauchy step
    (guaranteeing a nonnegative discriminant, reference dogleg.c:945-947).
    """
    from libdogleg_tpu.ops.treevec import (tree_add, tree_dot, tree_scale,
                                           tree_sub)
    d = tree_sub(cauchy, gn)
    l2 = tree_dot(d, d)
    neg_c = tree_dot(d, cauchy)
    dsq = trustregion * trustregion
    discriminant = jnp.maximum(neg_c * neg_c - l2 * (norm2_cauchy - dsq), 0.0)
    k = (neg_c + jnp.sqrt(discriminant)) / l2
    step = tree_add(cauchy, tree_scale(k, tree_sub(gn, cauchy)))
    return InterpolatedStep(step=step, norm2_step=tree_dot(step, step), k=k)


def expected_improvement(Jt_x: jnp.ndarray,
                         JtJ: jnp.ndarray,
                         step: jnp.ndarray) -> jnp.ndarray:
    """Linearized model decrease for a candidate step.

    F(0) - F(step) = -2 inner(Jt_x, step) - norm2(J step), with norm2(J step)
    as the JtJ quadratic form (reference dogleg.c:1085-1165; products form at
    dogleg.c:1129-1163).
    """
    return -2.0 * jnp.dot(Jt_x, step) - quad_form(JtJ, step)


def trust_region_update(rho: jnp.ndarray,
                        trustregion: jnp.ndarray,
                        stepped_to_edge: jnp.ndarray,
                        norm2_update_gn: jnp.ndarray,
                        *,
                        decrease_factor: float,
                        decrease_threshold: float,
                        increase_factor: float,
                        increase_threshold: float) -> jnp.ndarray:
    """New trust-region radius given the gain ratio rho.

    Exactly the reference's rule (dogleg.c:1322-1350):
      - rho < decrease_threshold: if the attempted step was *interior* (the
        full GN step — the only way not to touch the edge, reference
        dogleg.c:1235), first snap the radius to the GN step length, then
        multiply by decrease_factor (reference dogleg.c:1332-1343).
      - rho > increase_threshold and the step reached the edge: multiply by
        increase_factor (reference dogleg.c:1345-1350).
      - otherwise unchanged. NaN rho fails every comparison and leaves the
        radius unchanged, matching C comparison semantics.
    """
    snapped = jnp.where(stepped_to_edge, trustregion, jnp.sqrt(norm2_update_gn))
    decreased = snapped * decrease_factor
    increased = jnp.where(stepped_to_edge & (rho > increase_threshold),
                          trustregion * increase_factor,
                          trustregion)
    return jnp.where(rho < decrease_threshold, decreased, increased)
