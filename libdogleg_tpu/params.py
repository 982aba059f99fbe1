"""Solver parameters.

Mirrors the knob set and exact defaults of the reference parameter system
(reference dogleg.c:115-181, dogleg.h:112-152): max_iterations, the initial
trust region, the four trust-region update factors/thresholds, and the three
termination thresholds. The reference keeps both a process-global parameter
set and a reentrant per-call struct (dogleg.h:108-111); here there are no
globals — parameters are an immutable dataclass passed per solve.

The packed-triangle storage flags (JtJ_packed/JtJ_upper, dogleg.h:121-132) are
a CPU-cache/LAPACK idiom and are not solver parameters here: JtJ is always a
full symmetric matrix. Packed<->full converters live in
libdogleg_tpu.utils.packed for API-parity testing.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DoglegParameters:
    """Trust-region solver parameters.

    Defaults match the reference exactly (reference dogleg.c:117-128).

    Attributes:
      max_iterations: stop after this many *accepted* steps (reference
        dogleg.c:1376 counts accepted steps only).
      trustregion0: initial trust-region radius. Cheap to reject a too-large
        region, so the default is "large" (reference dogleg.h:134-139).
      trustregion_decrease_factor / trustregion_decrease_threshold: if the
        gain ratio rho < decrease_threshold, shrink the region by
        decrease_factor — after first snapping the radius to the Gauss-Newton
        step length when the attempted step was interior (reference
        dogleg.c:1324-1343).
      trustregion_increase_factor / trustregion_increase_threshold: if
        rho > increase_threshold and the step reached the region edge, grow
        the region (reference dogleg.c:1345-1350).
      Jt_x_threshold: converged when max_i |(J^T x)_i| <= this (inf-norm
        gradient test, reference dogleg.c:1071-1082).
      update_threshold: converged when max_i |step_i| <= this (reference
        dogleg.c:1287-1296).
      trustregion_threshold: give up when, after a rejected step, the
        trust-region radius falls below this (reference dogleg.c:1460-1466).
      max_attempts: safety cap on total step attempts (accepted + rejected).
        The reference has no such cap and can spin forever on NaN residuals
        (NaN rho fails every comparison at reference dogleg.c:1324-1354, so
        the region never shrinks); a bounded loop is required for batched
        solves. 0 means "derive from max_iterations".
      lambda_initial: first Tikhonov lambda applied when JtJ is singular
        (reference dogleg.c:137-138). Escalates x10 per failure and is
        permanent for the rest of the solve (reference dogleg.h:197-201).
      lambda_max_tries: cap on lambda escalations within one factorization.
    """

    max_iterations: int = 100
    trustregion0: float = 1.0e3
    trustregion_decrease_factor: float = 0.1
    trustregion_decrease_threshold: float = 0.25
    trustregion_increase_factor: float = 2.0
    trustregion_increase_threshold: float = 0.75
    Jt_x_threshold: float = 1e-8
    update_threshold: float = 1e-8
    trustregion_threshold: float = 1e-8

    # Framework-specific knobs (no reference equivalent; see docstring).
    max_attempts: int = 0
    lambda_initial: float = 1e-10
    lambda_max_tries: int = 60

    def resolved_max_attempts(self) -> int:
        if self.max_attempts > 0:
            return self.max_attempts
        # Each accept consumes one iteration; rejects shrink the region
        # geometrically toward trustregion_threshold, so per accepted step the
        # number of rejects is bounded by the decade count from trustregion0
        # down to the threshold. 64 covers the default 1e3 -> 1e-8 schedule
        # (11 decades) with a wide margin.
        return self.max_iterations * 64

    def replace(self, **kw) -> "DoglegParameters":
        return dataclasses.replace(self, **kw)


def get_default_parameters() -> DoglegParameters:
    """Returns the default parameter set (reference dogleg_getDefaultParameters,
    dogleg.c:132-135)."""
    return DoglegParameters()
