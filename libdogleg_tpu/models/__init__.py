"""Problem-family models: ready-made nonlinear least-squares problems.

The reference ships exactly one demo problem (sample.c's quadratic surface);
this package keeps that one as the golden integration problem and adds the
families the benchmarks exercise:

  quadratic_surface  — the reference sample.c problem (6 params, 100
                       measurements), all four solve modes
  curve_fit          — small dense-Jacobian exponential curve fit
                       (BASELINE.md config 2)
  bundle_adjustment  — synthetic BA-style arrow systems: dense global
                       block + many small point blocks, solved via
                       Schur-complement elimination (BASELINE.md config 4)
  pinhole_ba         — NONLINEAR pinhole-camera bundle adjustment
                       (reprojection errors, autodiff per-observation
                       Jacobians, pytree states) — the problem class
                       libdogleg was actually written for
"""

from libdogleg_tpu.models import (bundle_adjustment, curve_fit, grid_mrf,
                                  pinhole_ba)
from libdogleg_tpu.models import quadratic_surface

__all__ = ["quadratic_surface", "curve_fit", "bundle_adjustment",
           "grid_mrf", "pinhole_ba"]
