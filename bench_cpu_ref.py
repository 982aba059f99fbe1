"""Head-to-head: libdogleg_tpu (this framework) vs the compiled C reference.

BASELINE.md's batched target is "cost parity vs libdogleg CPU". Round 1
beat an abstract 1e4 solves/s constant; this harness measures the actual
reference library on the SAME problem instances:

  - builds the reference (dogleg.c + the minichol functional CHOLMOD
    subset — same build as the parity oracle) plus bench_ref.c, a
    pure-C driver whose model callbacks are native C (no Python/ctypes in
    the measured loop);
  - generates the exact instance sets bench_all.py times and hands them to
    both sides byte-identically (f32 values widened to f64 for the C side,
    which only does f64):
      * config 3: 8192 quadratic-surface instances (bench.py's headline),
        throughput;
      * config 1/2 analog: single-solve LATENCY on the quadratic-surface
        and curve-fit problems;
  - times the reference in dense and dense-products modes, with its stock
    stopping rule and with the relaxed rule bench.py uses on the device
    (max_iterations=10, thresholds 1e-3/1e-5/1e-5) — the relaxed run is
    the apples-to-apples row;
  - times this framework's headline path (batched_optimize_compacted) and
    single-solve latencies on the current backend, and optionally on the
    XLA CPU backend in a subprocess (``--ours-cpu``). Every child
    process is started with JAX_PLATFORMS=cpu, so it never opens the
    device the parent holds.

Prints one JSON line per measurement.
Reference entry points: dogleg_optimize_dense2 /
dogleg_optimize_dense_products (reference dogleg.h:294-302); the C
reference's own demo timing loop is sample.c:412.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import struct
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
REF = pathlib.Path("/root/reference")
ORACLE_SRC = REPO / "tests" / "reference_oracle"
BUILD = REPO / "tests" / "_oracle_build"

BATCH = 8192
# children run on the host CPU backend, chosen before JAX is imported
CPU_ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def build_bench_ref() -> pathlib.Path:
    """Compile the pure-C benchmark driver against the reference library."""
    BUILD.mkdir(exist_ok=True)
    shutil.copy(ORACLE_SRC / "minichol.h", BUILD / "cholmod.h")
    exe = BUILD / "bench_ref"
    srcs = [ORACLE_SRC / "bench_ref.c", ORACLE_SRC / "minichol.c",
            REF / "dogleg.c"]
    newest_src = max(s.stat().st_mtime for s in srcs)
    if exe.exists() and exe.stat().st_mtime > newest_src:
        return exe
    cmd = ["gcc", "-O3", "-fopenmp", "-o", str(exe),
           *map(str, srcs), f"-I{BUILD}", f"-I{REF}",
           "-l:liblapack.so.3", "-lm"]
    subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    return exe


def write_instance_file(path, problem_id, aux, meas, p0s):
    n, nmeas = meas.shape
    nstate = p0s.shape[1]
    with open(path, "wb") as f:
        f.write(struct.pack("<4q", problem_id, nstate, nmeas, n))
        np.asarray(aux, np.float64).tofile(f)
        for i in range(n):
            meas[i].astype(np.float64).tofile(f)
            p0s[i].astype(np.float64).tofile(f)


def make_qs_instances(dtype_str="float32"):
    """The exact quadratic-surface instance set bench.py uses (keys 0/1)."""
    import jax
    import jax.numpy as jnp
    import libdogleg_tpu.sample_problem as sp

    dtype = jnp.dtype(dtype_str)
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    meas = np.asarray(jax.vmap(lambda k: sp.simulate(k, dtype=dtype))(keys))
    p0s = np.asarray(jax.vmap(lambda k: sp.initial_state(k, dtype=dtype))(
        jax.random.split(jax.random.PRNGKey(1), BATCH)))
    gx, gy = sp.make_grid(dtype)
    aux = np.concatenate([np.asarray(gx, np.float64),
                          np.asarray(gy, np.float64)])
    return aux, meas, p0s


def make_cf_instances(dtype_str="float32"):
    """The curve-fit instance bench_all.py config 2 uses (keys 0/1)."""
    import jax
    import jax.numpy as jnp
    from libdogleg_tpu.models import curve_fit

    dtype = jnp.dtype(dtype_str)
    meas = np.asarray(curve_fit.simulate(jax.random.PRNGKey(0),
                                         dtype=dtype))[None]
    p0 = np.asarray(curve_fit.initial_state(jax.random.PRNGKey(1),
                                            dtype=dtype))[None]
    t = np.asarray(curve_fit.make_t(meas.shape[1], dtype), np.float64)
    return t, meas, p0


def write_grid_instance_file(path, width, height, b=8, reps=3,
                             coupling="diag"):
    """Problem 2: the config-6 grid MRF, exported for the C driver's
    sparse path (dogleg_optimize2 through minichol's RCM+band
    factorization). The header's n field carries the latency rep count;
    the solve starts from zeros like bench_all.config6_sparse_grid.
    coupling='dense' is the pose-graph-like regime with dense per-edge
    mixing blocks (with 'diag' the scalar problem decouples into b
    independent grids and a scalar CPU factorization is artificially
    cheap — both rows are recorded)."""
    from libdogleg_tpu.models import grid_mrf
    m = grid_mrf.make_grid_mrf(width=width, height=height, block_size=b,
                               coupling=coupling)
    n_nodes, n_edges = m.n_nodes, m.edges.shape[0]
    nmeas = (n_nodes + n_edges) * b
    with open(path, "wb") as f:
        f.write(struct.pack("<4q", 2, m.nstate, nmeas, reps))
        np.asarray([n_nodes, n_edges, b, m.w_prior, m.w_edge,
                    1.0 if coupling == "dense" else 0.0],
                   np.float64).tofile(f)
        m.edges.astype(np.float64).tofile(f)
        np.asarray(m.z_prior, np.float64).reshape(-1).tofile(f)
        np.asarray(m.z_edge, np.float64).reshape(-1).tofile(f)
        if coupling == "dense":
            np.asarray(m.mix, np.float64).reshape(-1).tofile(f)
    return m


def run_reference_grid(exe, inst_file, reps=2):
    """Best-of-reps for the problem-2 sparse latency row."""
    best = None
    for _ in range(reps):
        out = subprocess.run([str(exe), str(inst_file), "dense", "1",
                              "relaxed"],
                             check=True, capture_output=True,
                             timeout=1200, text=True)
        rec = json.loads(out.stdout.strip())
        if best is None or rec["latency_ms"] < best["latency_ms"]:
            best = rec
    return best


def run_ours_grid(width, height, b=8, platform=None, dtype_str="float64",
                  coupling="diag"):
    """Our sparse path on the same grid instance (the bench_all config-6
    program: RCM ordering, supernodal amalgamate=16), relaxed stopping
    rule, timed warm on the current backend."""
    import jax
    if platform:
        jax.config.update("jax_platforms", platform)
    if dtype_str == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from libdogleg_tpu import optimize
    from libdogleg_tpu.models import grid_mrf
    from libdogleg_tpu.problems import SparseProblem
    from libdogleg_tpu.utils.benchtime import measure

    dtype = jnp.dtype(dtype_str)
    m = grid_mrf.make_grid_mrf(width=width, height=height, block_size=b,
                               coupling=coupling, dtype=dtype)
    base = m.problem(jtj="dense")
    sp_prob = SparseProblem(f=base.f, structure=base.structure,
                            jtj="sparse", ordering="rcm", amalgamate=16)
    ns = sp_prob.default_newton_solver()
    prm = _relaxed_prm()
    f = jax.jit(lambda p0: optimize(sp_prob, p0, prm, newton_solver=ns))
    t = measure(f, jnp.zeros(m.nstate, dtype))
    r, dt = t.out, t.warm_s
    return {
        "problem": 2,
        "mode": "ours-sparse-supernodal",
        "backend": jax.default_backend(),
        "dtype": dtype_str,
        "nstate": m.nstate,
        "latency_ms": round(dt * 1e3, 3),
        "norm2_x": float(r.norm2_x),
        "n_attempts": int(r.n_attempts),
    }


def run_reference(exe, inst_file, mode, relaxed, latency=False, reps=10):
    """Best-of-reps wall clock for the C driver (single-threaded: this
    host has one core). The host is shared and noisy — reps=10 and
    best-of keeps the comparison maximally fair to the reference."""
    best = None
    for _ in range(reps):
        args = [str(exe), str(inst_file), mode, "1"]
        if relaxed:
            args.append("relaxed")
        if latency:
            args.append("latency")
        out = subprocess.run(args, check=True, capture_output=True,
                             timeout=600, text=True)
        rec = json.loads(out.stdout.strip())
        if best is None or rec["solves_per_s"] > best["solves_per_s"]:
            best = rec
    return best


def _relaxed_prm():
    from libdogleg_tpu import DoglegParameters
    return DoglegParameters(max_iterations=10, Jt_x_threshold=1e-3,
                            update_threshold=1e-5,
                            trustregion_threshold=1e-5)


def run_ours_batched(platform=None):
    """Time the headline path (same program bench.py times) on the current
    or a forced backend; returns a record shaped like the C driver's."""
    import jax
    if platform:
        jax.config.update("jax_platforms", platform)
    import jax.numpy as jnp
    import libdogleg_tpu.sample_problem as sp
    from libdogleg_tpu.parallel.batched import batched_optimize_compacted
    from libdogleg_tpu.solver import Products
    from libdogleg_tpu.utils.benchtime import measure

    dtype = jnp.float32
    gx, gy = sp.make_grid(dtype)
    prm = _relaxed_prm()

    def products(p, m):
        x = sp.model(p, gx, gy) - m
        J = sp.jacobian(p, gx, gy)
        return Products(norm2_x=x @ x,
                        Jt_x=jnp.matmul(J.T, x, preferred_element_type=dtype),
                        JtJ=jnp.matmul(J.T, J, preferred_element_type=dtype))

    def solve_one_batch(p0s, meas_batch):
        # auto-tuned compaction defaults: exactly the program bench.py
        # times (the head-to-head row must match the advertised headline)
        r = batched_optimize_compacted(
            products, p0s, prm, problem_data=meas_batch)
        return r.p, r.n_attempts

    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    meas = jax.vmap(lambda k: sp.simulate(k, dtype=dtype))(keys)
    p0s = jax.vmap(lambda k: sp.initial_state(k, dtype=dtype))(
        jax.random.split(jax.random.PRNGKey(1), BATCH))

    t = measure(jax.jit(solve_one_batch), p0s, meas)
    (p_sol, n_attempts), dt = t.out, t.warm_s
    err = np.abs(np.asarray(p_sol) - sp.P_TRUE[None, :])
    frac_ok = float(np.mean(np.all(err < 0.2, axis=1)))
    return {
        "problem": 0,
        "mode": "ours-batched-compacted",
        "backend": jax.default_backend(),
        "n": BATCH,
        "wall_s": round(dt, 6),
        "solves_per_s": round(BATCH / dt, 2),
        # +1: the reference counts the initial evaluation as a callback
        "mean_evals": round(float(np.mean(np.asarray(n_attempts))) + 1.0, 3),
        "recovered_frac": round(frac_ok, 4),
    }


def run_ours_latency():
    """Single-solve jitted latency on both problems (bench_all configs
    1/2 analog, dense path, relaxed stopping rule)."""
    import jax
    import jax.numpy as jnp
    import libdogleg_tpu.sample_problem as sp
    from libdogleg_tpu import optimize
    from libdogleg_tpu.models import curve_fit
    from libdogleg_tpu.utils.benchtime import measure

    prm = _relaxed_prm()
    recs = []
    for problem_id, mod in ((0, sp), (1, curve_fit)):
        meas = mod.simulate(jax.random.PRNGKey(0), dtype=jnp.float32)
        p0 = mod.initial_state(jax.random.PRNGKey(1), dtype=jnp.float32)
        problem = mod.make_dense_problem(meas)
        f = jax.jit(lambda q, problem=problem: optimize(problem, q, prm).p)
        t = measure(f, p0)
        out, dt = t.out, t.warm_s
        ok = bool(np.all(np.abs(np.asarray(out) - mod.P_TRUE) < 0.2))
        recs.append({
            "problem": problem_id,
            "mode": "ours-single-solve",
            "backend": jax.default_backend(),
            "latency_us": round(dt * 1e6, 3),
            "solves_per_s": round(1.0 / dt, 2),
            "recovered_frac": 1.0 if ok else 0.0,
        })
    return recs


def run_exported_latency():
    """Single-solve latency of the AOT-exported CPU artifact: the deployment answer to the reference's link-libdogleg.so
    -and-call use case (reference Makefile:7, dogleg.c:1755). The solver
    is traced+serialized ONCE (export.py), then served from bytes with no
    Python tracing; we time sequential `.call(p0)` round trips INCLUDING
    Python dispatch overhead — that is the latency a serving process
    actually observes. Runs pinned to the XLA CPU backend (same silicon
    class as the 21 us C number it is compared against)."""
    import tempfile
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import libdogleg_tpu.sample_problem as sp
    from libdogleg_tpu.export import (export_solver, load_exported,
                                      save_exported)

    prm = _relaxed_prm()
    meas = sp.simulate(jax.random.PRNGKey(0), dtype=jnp.float32)
    products = sp.make_dense_problem(meas).products
    exp = export_solver(products, nstate=sp.NSTATE, parameters=prm,
                        dtype=jnp.float32, outputs="p")
    with tempfile.NamedTemporaryFile(suffix=".bin") as fh:
        save_exported(fh.name, exp)
        artifact_bytes = os.path.getsize(fh.name)
        solve = load_exported(fh.name)
    p0 = sp.initial_state(jax.random.PRNGKey(1), dtype=jnp.float32)
    # serving configuration: AOT-compile the deserialized artifact once
    # (no per-call jit-cache lookup)
    call = jax.jit(solve.call).lower(p0).compile()
    p_sol = jax.block_until_ready(call(p0))   # warmup
    ok = bool(np.all(np.abs(np.asarray(p_sol) - sp.P_TRUE) < 0.2))
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        jax.block_until_ready(call(p0))
    dt = (time.perf_counter() - t0) / n
    return {
        "problem": 0,
        "mode": "single_solve_exported_cpu",
        "backend": "cpu",
        "latency_us": round(dt * 1e6, 3),
        "solves_per_s": round(1.0 / dt, 2),
        "recovered_frac": 1.0 if ok else 0.0,
        "artifact_bytes": artifact_bytes,
        "timing": "wall-clock over 2000 sequential calls incl. Python "
                  "dispatch (what a serving process observes)",
    }


def grid_head_to_head(width, height, reps, coupling="diag"):
    """One grid size, reference + ours + ratio rows (runs in a cpu+x64
    subprocess so the f64 instance export is exact)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    exe = build_bench_ref()
    gf = BUILD / f"bench_instances_grid{width}x{height}_{coupling}.bin"
    write_grid_instance_file(gf, width, height, reps=reps,
                             coupling=coupling)
    ref = run_reference_grid(exe, gf)
    ref.update(side="reference-cpu", ncores=os.cpu_count(),
               grid=f"{width}x{height}x8", coupling=coupling,
               factorization="minichol RCM+band simplicial "
                             "(CSparse-class lower bound for CHOLMOD)")
    ours = run_ours_grid(width, height, coupling=coupling)
    ours.update(side="ours", grid=f"{width}x{height}x8",
                coupling=coupling)
    ratio = {"metric": (f"grid{width}x{height}_{coupling}"
                        "_ours_vs_reference_cpu"),
             "ours_ms": ours["latency_ms"],
             "reference_ms": ref["latency_ms"],
             "speedup": round(ref["latency_ms"] / ours["latency_ms"], 2),
             "cost_match": bool(
                 abs(ours["norm2_x"] - ref["norm2_x"])
                 <= 1e-9 * max(abs(ref["norm2_x"]), 1.0))}
    return [ref, ours, ratio]


def main():
    from libdogleg_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if "--ours-only" in sys.argv:
        platform = sys.argv[sys.argv.index("--ours-only") + 1]
        print(json.dumps(run_ours_batched(platform)))
        return
    if "--exported-latency" in sys.argv:
        # own subprocess: jax must initialize on the CPU backend
        print(json.dumps(run_exported_latency()))
        return
    if "--grid-only" in sys.argv:
        i = sys.argv.index("--grid-only")
        w, h, reps = map(int, sys.argv[i + 1:i + 4])
        coupling = sys.argv[i + 4] if len(sys.argv) > i + 4 else "diag"
        for rec in grid_head_to_head(w, h, reps, coupling):
            print(json.dumps(rec))
        return
    if "--cpu" in sys.argv:
        # run our legs on the XLA CPU backend (before any computation)
        import jax
        jax.config.update("jax_platforms", "cpu")

    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec))

    exe = build_bench_ref()
    qs_file = BUILD / "bench_instances_qs.bin"
    cf_file = BUILD / "bench_instances_cf.bin"
    write_instance_file(qs_file, 0, *make_qs_instances())
    write_instance_file(cf_file, 1, *make_cf_instances())

    # config-3 analog: batched throughput on the quadratic surface
    for mode in ("dense", "products"):
        for relaxed in (False, True):
            rec = run_reference(exe, qs_file, mode, relaxed)
            rec.update(side="reference-cpu", ncores=os.cpu_count())
            emit(rec)

    # config-1/2 analog: single-solve latency on both problems
    for inst_file in (qs_file, cf_file):
        for mode in ("dense", "products"):
            rec = run_reference(exe, inst_file, mode, relaxed=True,
                                latency=True)
            rec.update(side="reference-cpu", ncores=os.cpu_count())
            emit(rec)

    # config-6 analog: the sparse grid-MRF head-to-head — the reference's dogleg_optimize2 sparse path vs our
    # supernodal level-scheduled Cholesky, same instance, same stopping
    # rule, both f64 when ours runs on CPU. The C side's CHOLMOD
    # stand-in is the minichol RCM+band simplicial factorization —
    # CSparse-class; real CHOLMOD (supernodal, AMD/ND ordering) would
    # typically be faster on this class, so read the ratio as a floor
    # for the reference, and the JSON says so.
    if "--skip-grid" not in sys.argv:
        for w, h, reps, coupling in ((32, 32, 3, "diag"),
                                     (32, 32, 3, "dense"),
                                     (64, 64, 2, "diag"),
                                     (64, 64, 2, "dense")):
            out = subprocess.run(
                [sys.executable, __file__, "--grid-only", str(w), str(h),
                 str(reps), coupling],
                check=True, capture_output=True, text=True, timeout=3600,
                env=CPU_ENV)
            ref_ms = None
            for line in out.stdout.strip().splitlines():
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                emit(rec)
                if rec.get("side") == "reference-cpu":
                    ref_ms = rec.get("latency_ms")
            if "--cpu" not in sys.argv:
                # the comparison that matters for BASELINE.md: OUR sparse
                # path on the device vs the reference on the host CPU
                # (the cpu-pinned "ours" leg above is a sanity
                # cross-check, not the product configuration)
                rec = run_ours_grid(w, h, dtype_str="float32",
                                    coupling=coupling)
                rec.update(side="ours-device", grid=f"{w}x{h}x8",
                           coupling=coupling)
                emit(rec)
                if ref_ms:
                    emit({"metric": f"grid{w}x{h}_{coupling}"
                                    "_ours_device_vs_reference_cpu",
                          "ours_device_ms": rec["latency_ms"],
                          "reference_cpu_ms": ref_ms,
                          "speedup": round(ref_ms / rec["latency_ms"],
                                           2)})

    if "--ours-cpu" in sys.argv:
        out = subprocess.run(
            [sys.executable, __file__, "--ours-only", "cpu"],
            check=True, capture_output=True, text=True, timeout=1200,
            env=CPU_ENV)
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        rec["side"] = "ours-cpu"
        emit(rec)

    rec = run_ours_batched()
    rec["side"] = "ours"
    emit(rec)
    for rec in run_ours_latency():
        rec["side"] = "ours"
        emit(rec)

    out = subprocess.run(
        [sys.executable, __file__, "--exported-latency"],
        check=True, capture_output=True, text=True, timeout=1200,
        env=CPU_ENV)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    rec["side"] = "ours"
    emit(rec)

    ref_best = max(r["solves_per_s"] for r in records
                   if r.get("side") == "reference-cpu"
                   and "latency" not in r.get("mode", ""))
    ours = next(r for r in records if r.get("side") == "ours"
                and r.get("mode") == "ours-batched-compacted")
    summary = {
        "metric": "ours_vs_reference_cpu",
        "ours_solves_per_s": ours["solves_per_s"],
        "reference_best_solves_per_s": ref_best,
        "speedup": round(ours["solves_per_s"] / ref_best, 2),
        "batch": BATCH,
        "host_cores": os.cpu_count(),
    }
    emit(summary)


if __name__ == "__main__":
    main()
