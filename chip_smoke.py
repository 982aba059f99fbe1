"""Smoke run of the dog-leg solver on one GPU, through the public API.

    python chip_smoke.py               # phases a-d on one card
    python chip_smoke.py --four-cards  # the mesh paths on four cards

Phases (one card), each at the size its users run it:

  a. the reference's sample problem in float64 on the device, every
     check.sh mode through `optimize` at DoglegParameters() (1e-8
     thresholds); gate: <= 8 accepted steps, every parameter within 5e-2
     (sample.py --check);
  b. the batched headline through `batched_optimize`: 8192 instances of
     the sample problem in float32 (the whole-solve kernel on a GPU);
     gate: >= 99% of instances within 0.2 of the truth. Each instance's
     step_count and reason are compared with a float64 solve of the same
     instance on the device, and the agreement is printed;
  c. large sparse single solves: nonlinear pinhole bundle adjustment
     through the Schur solver (32 cameras x 20k points) and the 64x64
     supernodal grid MRF (32k states), float32; gate: the benchmark's own
     rule, and final cost within FINAL_COST_RTOL of a float64 solve of
     the same instance on the host CPU;
  d. batched mid-size dense (n=64, batch 512, the blocked Cholesky path);
     gate: >= 95% of instances within 0.05 of the truth.

Every phase prints one JSON line: gate result, warm wall time (host clock
around block_until_ready, median of warm calls), first-call and compile
time, and the device's peak_bytes_in_use since the process started.
Matrix products run at JAX's default precision; the f32 gates are stated
above and the float64 comparisons are exact-math references.

The script exits 3 without a GPU (it never runs on the CPU), 1 if a gate
fails, and otherwise prints as its last line
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import sys

# f32 final cost relative to the f64 optimum of the same instance: the
# device solve stops at the benchmark's relaxed thresholds (gradient
# 1e-3), which leaves the cost above the optimum by far less than this.
FINAL_COST_RTOL = 1e-4


def _relaxed():
    from libdogleg_tpu import DoglegParameters
    return DoglegParameters(max_iterations=10, Jt_x_threshold=1e-3,
                            update_threshold=1e-5,
                            trustregion_threshold=1e-5)


def _cast64(tree):
    """Every floating leaf as a float64 array on the current default
    device; other leaves unchanged."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    def cast(a):
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating):
            return jnp.asarray(np.asarray(a), jnp.float64)
        return a
    return jax.tree_util.tree_map(cast, tree)


def _on_host_f64():
    """Context: float64 enabled, default device the host CPU."""
    import contextlib

    import jax

    stack = contextlib.ExitStack()
    stack.enter_context(jax.enable_x64(True))
    stack.enter_context(jax.default_device(jax.devices("cpu")[0]))
    return stack


def _timing(t) -> dict:
    return {"warm_s": t.warm_s, "first_call_s": t.first_s,
            "compile_s": max(t.first_s - t.warm_s, 0.0)}


def _sample_problem_data(batch, dtype):
    import jax

    import libdogleg_tpu.sample_problem as sp
    meas = jax.vmap(lambda k: sp.simulate(k, dtype=dtype))(
        jax.random.split(jax.random.PRNGKey(0), batch))
    p0s = jax.vmap(lambda k: sp.initial_state(k, dtype=dtype))(
        jax.random.split(jax.random.PRNGKey(1), batch))
    return meas, p0s


def _sample_products(dtype):
    import libdogleg_tpu.sample_problem as sp
    from libdogleg_tpu import Products

    gx, gy = sp.make_grid(dtype)

    def products(p, m):
        x = sp.model(p, gx, gy) - m
        J = sp.jacobian(p, gx, gy)
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    return products


# ---------------------------------------------------------------------------
# phases: each returns a dict with "gate_ok" and its measurements
# ---------------------------------------------------------------------------


def phase_sample(modes=("sparse", "dense", "dense-products-packed-upper",
                        "dense-products-unpacked", "residual"), reps=3):
    """a. Every check.sh mode in float64 on the default device."""
    import jax
    import jax.numpy as jnp

    import libdogleg_tpu.sample_problem as sp
    from libdogleg_tpu import DoglegParameters, optimize
    from libdogleg_tpu.sample import check_result, make_problem
    from libdogleg_tpu.utils.benchtime import measure

    prm = DoglegParameters(max_iterations=8)
    out = {"gate_ok": True, "modes": {}}
    with jax.enable_x64(True):
        meas = sp.simulate(jax.random.PRNGKey(0), dtype=jnp.float64)
        p0 = sp.initial_state(jax.random.PRNGKey(1), dtype=jnp.float64)
        for mode in modes:
            problem = make_problem(mode, meas)
            f = jax.jit(lambda q, _pr=problem: optimize(_pr, q, prm))
            t = measure(f, p0, reps=reps)
            ok, _ = check_result(t.out, prm.max_iterations)
            out["modes"][mode] = {"gate_ok": ok,
                                  "steps": int(t.out.step_count),
                                  "dtype": str(t.out.p.dtype),
                                  **_timing(t)}
            out["gate_ok"] &= ok
    return out


def phase_batched(batch=8192, reps=5):
    """b. The batched headline through batched_optimize, float32."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import libdogleg_tpu.sample_problem as sp
    from libdogleg_tpu.parallel.batched import batched_optimize
    from libdogleg_tpu.parallel.mega_auto import plan_megakernel
    from libdogleg_tpu.utils.benchtime import measure

    prm = _relaxed()
    meas, p0s = _sample_problem_data(batch, jnp.float32)
    products = _sample_products(jnp.float32)
    kernel = plan_megakernel(products, p0s, prm, problem_data=meas)
    f = jax.jit(lambda q, m: batched_optimize(products, q, prm,
                                              problem_data=m))
    t = measure(f, p0s, meas, reps=reps)
    r = t.out
    err = np.abs(np.asarray(r.p) - sp.P_TRUE[None])
    rec = float(np.mean(np.all(err < 0.2, axis=1)))

    with jax.enable_x64(True):
        r64 = batched_optimize(_sample_products(jnp.float64),
                               _cast64(p0s), prm,
                               problem_data=_cast64(meas),
                               use_megakernel=False)
        steps64 = np.asarray(r64.step_count)
        reason64 = np.asarray(r64.reason)
    agree = float(np.mean((np.asarray(r.step_count) == steps64)
                          & (np.asarray(r.reason) == reason64)))
    return {"gate_ok": rec >= 0.99, "batch": batch,
            "path": "megakernel" if kernel is not None else "xla",
            "recovered_frac": rec, "solves_per_s": batch / t.warm_s,
            "f64_decision_agreement": agree, **_timing(t)}


def _pinhole_solve(ba, prm):
    import jax

    from libdogleg_tpu import solve_products
    return jax.jit(lambda pc, pq: solve_products(
        ba.products, {"c": pc, "q": pq}, prm,
        newton_solver=ba.newton_solver()))


def phase_pinhole(ncam=32, npts=20000, reps=3):
    """c1. Nonlinear pinhole bundle adjustment through the Schur solver."""
    import jax
    import jax.numpy as jnp

    from libdogleg_tpu import DoglegParameters
    from libdogleg_tpu.models import pinhole_ba
    from libdogleg_tpu.utils.benchtime import measure

    ba = pinhole_ba.make_synthetic(seed=0, ncam=ncam, npts=npts,
                                   dtype=jnp.float32)
    p0 = ba.p0(jax.random.PRNGKey(2), jitter=0.02)
    t = measure(_pinhole_solve(ba, _relaxed()), p0["c"], p0["q"], reps=reps)
    cost = float(t.out.norm2_x)
    converged = cost < 1.0 * 2 * ba.nobs
    with _on_host_f64():
        ba64, p064 = _cast64(ba), _cast64(p0)
        cost64 = float(_pinhole_solve(ba64, DoglegParameters())(
            p064["c"], p064["q"]).norm2_x)
    rel = abs(cost - cost64) / cost64
    return {"gate_ok": bool(converged and rel <= FINAL_COST_RTOL),
            "nstate": ba.nstate, "nobs": ba.nobs, "cost": cost,
            "cost_f64_cpu": cost64, "cost_rel_diff": rel,
            "steps": int(t.out.step_count), **_timing(t)}


def _grid_solve(m, prm, amalgamate):
    import jax
    import jax.numpy as jnp

    from libdogleg_tpu import SparseProblem, optimize
    base = m.problem(jtj="dense")
    prob = SparseProblem(f=base.f, structure=base.structure, jtj="sparse",
                         ordering="rcm", amalgamate=amalgamate)
    ns = prob.default_newton_solver()
    f = jax.jit(lambda p0: optimize(prob, p0, prm, newton_solver=ns))
    return f, jnp.zeros(m.nstate, m.z_prior.dtype)


def phase_grid(width=64, height=64, b=8, amalgamate=16, reps=3):
    """c2. The supernodal grid MRF (config 6b)."""
    import jax.numpy as jnp
    import numpy as np

    from libdogleg_tpu import DoglegParameters
    from libdogleg_tpu.models import grid_mrf
    from libdogleg_tpu.utils.benchtime import measure

    m = grid_mrf.make_grid_mrf(width=width, height=height, block_size=b,
                               dtype=jnp.float32)
    f, p0 = _grid_solve(m, _relaxed(), amalgamate)
    t = measure(f, p0, reps=reps)
    cost = float(t.out.norm2_x)
    with _on_host_f64():
        f64, p064 = _grid_solve(_cast64(m), DoglegParameters(), amalgamate)
        cost64 = float(f64(p064).norm2_x)
    rel = abs(cost - cost64) / cost64
    return {"gate_ok": bool(np.isfinite(cost) and rel <= FINAL_COST_RTOL),
            "nstate": m.nstate, "cost": cost, "cost_f64_cpu": cost64,
            "cost_rel_diff": rel, "steps": int(t.out.step_count),
            **_timing(t)}


def phase_midsize(nstate=64, batch=512, reps=3):
    """d. Batched mid-size dense problems (BlockedDenseNewtonSolver)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from libdogleg_tpu import Products
    from libdogleg_tpu.parallel.batched import _auto_newton, batched_optimize
    from libdogleg_tpu.utils.benchtime import measure

    dtype = jnp.float32
    nmeas = 4 * nstate
    rng = np.random.default_rng(8)
    A = jnp.asarray(rng.normal(size=(batch, nmeas, nstate)), dtype)
    Bm = jnp.asarray(rng.normal(size=(batch, nstate, nstate)) * 0.5
                     / np.sqrt(nstate), dtype)
    C = jnp.asarray(rng.normal(size=(batch, nmeas, nstate)) * 0.3, dtype)
    p_true = rng.normal(size=(batch, nstate))
    d = (np.einsum("bms,bs->bm", np.asarray(A),
                   np.tanh(np.einsum("bst,bt->bs", np.asarray(Bm), p_true)))
         + np.einsum("bms,bs->bm", np.asarray(C), p_true)
         + rng.normal(size=(batch, nmeas)) * 0.01)
    d = jnp.asarray(d, dtype)
    p0s = jnp.asarray(p_true + rng.normal(size=(batch, nstate)) * 0.1, dtype)

    def products(p, data):
        Ab, Bb, Cb, db = data
        tt = jnp.tanh(Bb @ p)
        x = Ab @ tt + Cb @ p - db
        J = Ab @ ((1.0 - tt * tt)[:, None] * Bb) + Cb
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)

    data = (A, Bm, C, d)
    solver = _auto_newton(products, p0s, data)
    f = jax.jit(lambda q, dd: batched_optimize(products, q, _relaxed(),
                                               problem_data=dd))
    t = measure(f, p0s, data, reps=reps)
    err = np.abs(np.asarray(t.out.p) - p_true)
    rec = float(np.mean(np.all(err < 0.05, axis=1)))
    return {"gate_ok": rec >= 0.95, "nstate": nstate, "batch": batch,
            "newton_solver": type(solver).__name__ if solver else "default",
            "recovered_frac": rec, "solves_per_s": batch / t.warm_s,
            **_timing(t)}


def phase_dp4(batch=8192, n_devices=4):
    """Four cards: batched_optimize(mesh=) at dp=n_devices against the
    one-card solve; step counts must be identical."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from libdogleg_tpu.parallel import make_mesh, shard_batch
    from libdogleg_tpu.parallel.batched import batched_optimize
    from libdogleg_tpu.utils.benchtime import measure

    prm = _relaxed()
    meas, p0s = _sample_problem_data(batch, jnp.float32)
    products = _sample_products(jnp.float32)
    one = jax.jit(lambda q, m: batched_optimize(products, q, prm,
                                                problem_data=m))
    t1 = measure(one, p0s, meas)
    mesh = make_mesh(("dp",), shape=(n_devices,))
    q, m = shard_batch((p0s, meas), mesh)
    many = jax.jit(lambda q, m: batched_optimize(products, q, prm,
                                                 problem_data=m, mesh=mesh))
    t4 = measure(many, q, m)
    same = bool(np.array_equal(np.asarray(t1.out.step_count),
                               np.asarray(t4.out.step_count)))
    return {"gate_ok": same, "batch": batch, "devices": n_devices,
            "solves_per_s_one": batch / t1.warm_s,
            "solves_per_s_mesh": batch / t4.warm_s,
            "step_count_identical": same, **_timing(t4)}


def phase_meas4(n_devices=4):
    """Four cards: the sample problem with its measurement rows sharded
    over n_devices (psum of the products) against the one-card solve, in
    float64; final costs within 1e-9 relative (only the order of the
    psum differs)."""
    import jax
    import jax.numpy as jnp

    import libdogleg_tpu.sample_problem as sp
    from libdogleg_tpu import DoglegParameters, optimize
    from libdogleg_tpu.parallel import MeasurementShardedProblem, make_mesh
    from libdogleg_tpu.utils.benchtime import measure

    prm = DoglegParameters(max_iterations=8)
    with jax.enable_x64(True):
        meas = sp.simulate(jax.random.PRNGKey(0), dtype=jnp.float64)
        p0 = sp.initial_state(jax.random.PRNGKey(1), dtype=jnp.float64)
        gx, gy = sp.make_grid(jnp.float64)
        one = jax.jit(lambda q: optimize(sp.make_dense_problem(meas), q,
                                         prm))(p0)
        mesh = make_mesh(("meas",), shape=(n_devices,))
        problem = MeasurementShardedProblem(
            f=lambda p, d: (sp.model(p, d[0], d[1]) - d[2],
                            sp.jacobian(p, d[0], d[1])),
            data=(gx, gy, meas), mesh=mesh, axis_name="meas")
        t = measure(jax.jit(lambda q: optimize(problem, q, prm)), p0)
        c1, c4 = float(one.norm2_x), float(t.out.norm2_x)
    rel = abs(c4 - c1) / c1
    return {"gate_ok": rel <= 1e-9, "devices": n_devices, "cost_one": c1,
            "cost_mesh": c4, "cost_rel_diff": rel,
            "steps": int(t.out.step_count), **_timing(t)}


PHASES = (("a-sample-f64", phase_sample), ("b-batched", phase_batched),
          ("c1-pinhole-ba", phase_pinhole), ("c2-grid-mrf-64", phase_grid),
          ("d-batched-midsize", phase_midsize))
FOUR_CARD_PHASES = (("dp4-batched", phase_dp4),
                    ("meas4-sample", phase_meas4))


def run_phases(phases) -> bool:
    """Run each phase, print its JSON line, return whether all passed."""
    import time

    import jax

    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        res = fn()
        stats = jax.devices()[0].memory_stats() or {}
        line = {"phase": name, **res,
                "phase_wall_s": time.perf_counter() - t0,
                "peak_bytes_in_use": stats.get("peak_bytes_in_use")}
        print(json.dumps(line), flush=True)
        ok &= bool(res["gate_ok"])
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh paths, on four cards")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found "
              f"{devices[0].platform}", file=sys.stderr)
        return 3
    n_cards = 4 if args.four_cards else 1
    if len(devices) < n_cards:
        print(f"--four-cards needs 4 GPUs; JAX found {len(devices)}",
              file=sys.stderr)
        return 3

    from libdogleg_tpu.native import native_available
    from libdogleg_tpu.utils.benchtime import card_line
    from libdogleg_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    print(f"card: {card_line()}", flush=True)
    print("host symbolic analysis: "
          + ("native library built with g++" if native_available()
             else "numpy (no g++ build)"), flush=True)
    ok = run_phases(FOUR_CARD_PHASES if args.four_cards else PHASES)
    if not ok:
        print("a phase failed its gate", file=sys.stderr)
        return 1
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
