"""Diagnostics: the vnlog per-iteration metrics stream.

The reference emits two diagnostic streams selected by debug bits (reference
dogleg.h:221-227): a human stream to stderr and a machine-parseable vnlog
table to stdout with one row per step attempt and 14 metric fields generated
by X-macros (reference dogleg.c:42-113). Here the solver records the same
schema into a fixed-size History buffer inside the jitted loop
(solver.History), and this module renders it as vnlog text — byte-compatible
field names and '-' placeholders — plus a human summary. Diffable against the
reference's `sample --diag vnlog` output for decision-by-decision trace
comparison (SURVEY.md section 7, hard part 4).
"""

from __future__ import annotations

import io
import math
from typing import Optional

import numpy as np

from libdogleg_tpu.solver import History, SolveResult, StepType, StopReason

# Field order matches the reference exactly (dogleg.c:50-64).
_FIELDS = (
    "norm2x_before", "norm2x_after", "step_len_cauchy",
    "step_len_gauss_newton", "step_len_interpolated", "k_cauchy_to_gn",
    "step_len", "step_type", "step_direction_change_deg",
    "expected_improvement", "observed_improvement", "rho",
    "trustregion_before", "trustregion_after",
)

_STEP_TYPE_NAMES = {
    int(StepType.CAUCHY): "cauchy",
    int(StepType.GAUSSNEWTON): "gaussnewton",
    int(StepType.INTERPOLATED): "interpolated",
    int(StepType.FAILED): "failed",
}


def vnlog_legend() -> str:
    """The header row (reference vnlog_debug_emit_legend, dogleg.c:75-81)."""
    return "# iteration step_accepted " + " ".join(_FIELDS)


def _fmt(v) -> str:
    # The reference prints '-' for unset (INFINITY) fields (dogleg.c:83-87)
    # and %g otherwise.
    f = float(v)
    if math.isinf(f):
        return "-"
    return f"{f:g}"


def format_vnlog(history: History, n_attempts: Optional[int] = None) -> str:
    """Render a recorded History as a vnlog table (one row per attempt)."""
    out = io.StringIO()
    print(vnlog_legend(), file=out)
    n = (int(n_attempts) if n_attempts is not None
         else int(np.sum(np.asarray(history.iteration) >= 0)))
    n = min(n, len(np.asarray(history.iteration)))
    h = {k: np.asarray(getattr(history, k)) for k in History._fields}
    for i in range(n):
        row = [str(int(h["iteration"][i])), str(int(h["step_accepted"][i]))]
        for name in _FIELDS:
            if name == "step_type":
                row.append(_STEP_TYPE_NAMES.get(int(h[name][i]), "-"))
            else:
                row.append(_fmt(h[name][i]))
        print(" ".join(row), file=out)
    return out.getvalue()


def print_vnlog(result: SolveResult) -> None:
    """Print the solve's vnlog stream (requires record_history=True)."""
    if result.history is None:
        raise ValueError("solve was run without record_history=True")
    print(format_vnlog(result.history, result.n_attempts), end="")


def explain_result(result: SolveResult) -> str:
    """Human-oriented one-line summary (the reference scatters this through
    stderr via SAY_IF_VERBOSE; here it is a single structured line)."""
    reason = StopReason(int(result.reason)).name
    return (f"dogleg: {int(result.step_count)} accepted steps "
            f"({int(result.n_attempts)} attempts), stop={reason}, "
            f"norm2_x={float(result.norm2_x):.6g}, "
            f"trustregion={float(result.trustregion):.6g}, "
            f"lambda={float(result.lam):.3g}")


def profile_op_summary(fn, *args, logdir: str = None,
                       top: int = 15) -> str:
    """Profile one warm execution of fn(*args) with jax.profiler and
    return a per-op device-time summary of the GPU planes (the reference
    has no profiling at all, SURVEY.md section 5.1). Each run ends with
    block_until_ready, so the trace holds the whole execution. logdir
    defaults to a fresh temporary directory."""
    import collections
    import glob
    import tempfile

    import jax
    from jax.profiler import ProfileData

    logdir = logdir or tempfile.mkdtemp(prefix="libdogleg_trace_")
    jax.block_until_ready(fn(*args))          # compile outside the trace
    with jax.profiler.trace(logdir):
        jax.block_until_ready(fn(*args))

    files = sorted(glob.glob(f"{logdir}/**/*.xplane.pb", recursive=True))
    if not files:
        return "no trace captured"
    planes = [pl for pl in ProfileData.from_file(files[-1]).planes
              if pl.name.startswith("/device:GPU")]
    if not planes:
        return "no GPU device plane in the trace"
    agg = collections.defaultdict(float)
    cnt = collections.Counter()
    for pl in planes:
        lines = [ln for ln in pl.lines if ln.name == "XLA Ops"] or pl.lines
        for ln in lines:
            for e in ln.events:
                agg[e.name] += e.duration_ns
                cnt[e.name] += 1
    out = [f"{'ms':>9}  {'calls':>6}  op"]
    for name, dur in sorted(agg.items(), key=lambda t: -t[1])[:top]:
        out.append(f"{dur / 1e6:9.3f}  {cnt[name]:6d}  {name[:80]}")
    return "\n".join(out)
