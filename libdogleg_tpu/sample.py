"""Demo / self-checking integration test CLI — the reference's sample.c.

Usage (mirrors reference sample.c:248-249):
    python -m libdogleg_tpu.sample [--check] [--diag vnlog|human]
        [--test-gradients] sparse|dense|dense-products-packed-upper|
        dense-products-unpacked|residual

Solves the 6-parameter quadratic-surface fit (sample.c:24-39) in the chosen
mode; --check asserts convergence and per-parameter recovery within 5e-2
(sample.c:424-457); --diag vnlog emits the per-attempt table to stdout;
--test-gradients prints the gradient-check table for every variable
(sample.c:392-405). The two dense-products spellings exercise the
packed-upper and unpacked JtJ layouts through the packed<->full converters.
`residual` is the autodiff mode the C reference cannot offer.
"""

from __future__ import annotations

import argparse
import sys


GREEN = "\x1b[32m"
RED = "\x1b[31m"
RESET = "\x1b[0m"

MODES = ("sparse", "dense", "dense-products-packed-upper",
         "dense-products-unpacked", "residual", "factored")


def make_problem(mode: str, meas):
    """The sample problem in one of MODES for these measurements."""
    import libdogleg_tpu.sample_problem as sp
    from libdogleg_tpu import ProductsProblem
    from libdogleg_tpu.utils.packed import full_to_packed, packed_to_full

    if mode == "sparse":
        return sp.make_sparse_problem(meas)
    if mode == "dense":
        return sp.make_dense_problem(meas)
    if mode == "residual":
        return sp.make_residual_problem(meas)
    if mode == "factored":
        # sufficient-statistics formulation (FactoredBasisProblem): same
        # optimum, per-attempt cost independent of the measurement count
        return sp.make_factored_problem(meas)
    # Exercise the packed-triangle API layouts end to end: the user
    # callback produces packed JtJ; the adapter expands it
    # (sample.c:165-237 exercises packed-upper and unpacked).
    base = sp.make_products_problem(meas)
    if not mode.endswith("packed-upper"):
        return base

    def f(p):
        n2, jtx, jtj = base.f(p)
        packed = full_to_packed(jtj, upper=True)
        return n2, jtx, packed_to_full(packed, sp.NSTATE, upper=True)
    return ProductsProblem(f=f)


def check_result(result, max_iterations: int):
    """The --check gate (sample.c:424-457): at most max_iterations
    accepted steps and every parameter within 5e-2 of the truth.
    Returns (ok, [(good, message), ...])."""
    import numpy as np

    import libdogleg_tpu.sample_problem as sp

    if int(result.step_count) > max_iterations:
        return False, [(False, "ERROR: the optimization did not converge")]
    lines = [(True, "OK: the optimization converged to an optimum  "
                    f"of norm2(x)={float(result.norm2_x):.1f}")]
    for i, (pi, pref) in enumerate(zip(np.asarray(result.p), sp.P_TRUE)):
        err = pi - pref
        good = bool(abs(err) < 5e-2)
        lines.append((good, f"{'OK' if good else 'ERROR'}: parameter {i} "
                            f"{'recovered' if good else 'was NOT recovered'}"
                            f": psolved={pi:.3f} pref={pref:.3f} "
                            f"perr={err:.3f}"))
    return all(g for g, _ in lines), lines


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="libdogleg_tpu.sample",
        description="libdogleg_tpu demo (the reference sample.c problem)")
    ap.add_argument("--check", action="store_true",
                    help="self-check mode: assert convergence + recovery")
    ap.add_argument("--diag", choices=("vnlog", "human"),
                    help="diagnostic stream")
    ap.add_argument("--test-gradients", action="store_true",
                    help="print gradient-check tables and exit")
    ap.add_argument("--f32", action="store_true",
                    help="solve in float32 instead of float64")
    ap.add_argument("--platform", choices=("cpu", "gpu"), default=None,
                    help="force a jax platform (default: environment choice)")
    ap.add_argument("mode", choices=MODES)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.check and args.test_gradients:
        print("--check and --test-gradients are exclusive", file=sys.stderr)
        return 1

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if not args.f32:
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np

    import libdogleg_tpu.sample_problem as sp
    from libdogleg_tpu import DoglegParameters, optimize
    from libdogleg_tpu.analysis import check_gradients, format_gradient_table
    from libdogleg_tpu.diagnostics import explain_result, print_vnlog

    dtype = jnp.float32 if args.f32 else jnp.float64
    meas = sp.simulate(jax.random.PRNGKey(0), dtype=dtype)
    p0 = sp.initial_state(jax.random.PRNGKey(1), dtype=dtype)
    problem = make_problem(args.mode, meas)

    if not args.check:
        print(f"Using {args.mode} math", file=sys.stderr)
        print("starting state:", file=sys.stderr)
        for i, v in enumerate(np.asarray(p0)):
            print(f"  p[{i}] = {v:f}", file=sys.stderr)

    if args.test_gradients:
        if args.mode.startswith("dense-products"):
            from libdogleg_tpu.analysis.gradients import (
                check_gradients_products)
            print("# ivar gradient_reported gradient_observed error "
                  "error_relative")
            for ivar in range(sp.NSTATE):
                rep, obs, err, rel = check_gradients_products(
                    problem, p0, ivar)
                print(f"{ivar} {float(rep):.6g} {float(obs):.6g} "
                      f"{float(err):.6g} {float(rel):.6g}")
        else:
            for ivar in range(sp.NSTATE):
                print(f"checking gradients for variable {ivar}",
                      file=sys.stderr)
                print(format_gradient_table(
                    check_gradients(problem, p0, ivar)), end="")
        return 0

    # This is an easy problem; solvable in this many iterations
    # (sample.c:364-365).
    prm = DoglegParameters(max_iterations=8)
    record = args.diag == "vnlog"
    result = optimize(problem, p0, prm, record_history=record,
                      debug=args.diag == "human")

    if record:
        print_vnlog(result)
    if args.diag == "human":
        print(explain_result(result), file=sys.stderr)

    optimum = float(result.norm2_x)

    if args.check:
        ok, lines = check_result(result, prm.max_iterations)
        for good, line in lines:
            print((GREEN if good else RED) + line + RESET)
        return 0 if ok else 1

    print(f"Done. Optimum = {optimum:f}", file=sys.stderr)
    print("optimal state:", file=sys.stderr)
    for i, v in enumerate(np.asarray(result.p)):
        print(f"  p[{i}] = {v:f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
