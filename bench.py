"""Batched headline: independent small dog-leg solves per second on one GPU.

The workload is BASELINE.md config 3: the reference's sample problem (6
states, 100 measurements, distinct noise and start per instance) at batch
8192 in float32, solved through the public `batched_optimize`. Each
contender is one way that call can run:

  * `mega`: the whole-solve megakernel (ops/pallas_mega.py), which
    `batched_optimize` selects by itself on a GPU;
  * `xla-u<k>`: `use_megakernel=False`, the vmapped `while_loop`, with
    `wavefront_unroll=k`.

Three products forms are timed: `general` (residuals and Jacobian over
the measurements, matrix products at JAX's default precision, which on
the GPU's XLA path is TF32), `general-hi` (the same at
Precision.HIGHEST: float32 products, as the kernel computes them
whatever precision is asked for) and `factored` (sufficient statistics,
models/quadratic_surface.py). `--rows R` keeps R of the measurements of
every instance, spread evenly over the grid, in the general forms (and drops the factored form,
which needs the whole grid): below the adapter's ROLL_MIN_ROWS the
kernel's products are unrolled, which is how the compile time of long
lane code is measured. `--tiles` also times the kernel alone
(`megakernel_optimize`) over tiles of <lanes>x<warps> (the warp count is
the kernel's module constant NUM_WARPS, set for the contender), with the
products adapted from the per-element function and written by hand. `--trace` prints the
per-op device time of one warm call of each contender instead of timing
it (diagnostics.profile_op_summary).

Timing is a host clock around `block_until_ready` (utils/benchtime.py):
the first call (compilation included) apart, then the median of warm
calls. Every contender must recover >= 99% of instances within 0.2 of
the true parameters (at the full 100 measurements); the script exits 1 if
one does not, and 2 without a GPU. The first line names the card and its power limit; then one JSON
line per contender, each naming the device. Kernel lines carry the lane
operations of one products evaluation (`lane_ops`, the adapter's
MAX_LANE_OPS measure).

    python bench.py [--batch 8192] [--rows 100] [--reps 5] [--tiles 64x2,32x1]
                    [--only NAME,...] [--trace]

Contenders are named mega-<form>, xla-u<k>-<form> and, per tile,
kernel-<adapted|hand>-<form>-<lanes>x<warps>.
"""

import argparse
import json
import sys

from libdogleg_tpu.utils.compile_cache import enable_compile_cache


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--rows", type=int, default=100,
                    help="measurements per instance in the general forms")
    ap.add_argument("--tiles", default="",
                    help="comma-separated <lanes>x<warps> kernel tiles")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="",
                    help="comma-separated contender names to run")
    ap.add_argument("--trace", action="store_true",
                    help="print per-op device time instead of timing")
    args = ap.parse_args()

    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    import libdogleg_tpu.models.quadratic_surface as sp
    from libdogleg_tpu import DoglegParameters
    from libdogleg_tpu.diagnostics import profile_op_summary
    import libdogleg_tpu.ops.pallas_mega as pm
    from libdogleg_tpu.parallel.batched import batched_optimize
    from libdogleg_tpu.parallel.mega_auto import (adapt_products_lanes,
                                                  lane_op_count,
                                                  trace_products)
    from libdogleg_tpu.solver import Products
    from libdogleg_tpu.utils.benchtime import card_line, measure

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        sys.exit(2)
    print(f"card: {card_line()}", flush=True)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": jax.device_count()}

    dtype = jnp.float32
    B, R = args.batch, args.rows
    prm = DoglegParameters(max_iterations=10, Jt_x_threshold=1e-3,
                           update_threshold=1e-5, trustregion_threshold=1e-5)
    # R measurements spread evenly over the grid
    rows = np.round(np.linspace(0, sp.NMEAS - 1, R)).astype(int)
    gx, gy = (g[rows] for g in sp.make_grid(dtype))
    meas = jax.vmap(lambda k: sp.simulate(k, dtype=dtype))(
        jax.random.split(jax.random.PRNGKey(0), B))
    p0s = jax.vmap(lambda k: sp.initial_state(k, dtype=dtype))(
        jax.random.split(jax.random.PRNGKey(1), B))
    G_pair = sp.gram_pair(dtype)

    def general_at(precision):
        def products(p, m):
            x = sp.model(p, gx, gy) - m
            J = sp.jacobian(p, gx, gy)
            return Products(norm2_x=jnp.dot(x, x, precision=precision),
                            Jt_x=jnp.dot(J.T, x, precision=precision),
                            JtJ=jnp.dot(J.T, J, precision=precision))
        return products

    def factored(p, st):
        return sp.factored_products(p, st, G_pair)

    forms = {"general": (general_at(None), meas[:, rows]),
             "general-hi": (general_at(jax.lax.Precision.HIGHEST),
                            meas[:, rows])}
    if R == sp.NMEAS:
        forms["factored"] = (factored,
                             jax.vmap(sp.factored_statistics)(meas))
    hand = {"general": sp.products_lanes,
            "factored": sp.factored_products_lanes(G_pair)}

    def adapted(fn, data):
        closed, nd = trace_products(
            fn, jax.ShapeDtypeStruct((sp.NSTATE,), dtype),
            jax.tree_util.tree_map(
                lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype), data))
        lanes, shared = adapt_products_lanes(closed, nd)
        rows = [max(int(np.prod(d.shape[1:])), 1)
                for d in jax.tree_util.tree_leaves(data)]
        return lanes, shared, lane_op_count(lanes, sp.NSTATE, rows, dtype,
                                            shared)

    failed = []

    def gate(rec):
        # fewer measurements recover fewer instances: the cut problem has
        # no recovery bound, and its line reports gate_ok null
        return rec >= 0.99 if R == sp.NMEAS else None
    megakernel_optimize, warps_default = pm.megakernel_optimize, pm.NUM_WARPS

    def run(name, form, fn, data, extra):
        extra = extra()
        if args.trace:
            print(f"== {name}\n{profile_op_summary(fn, p0s, data)}",
                  flush=True)
            return
        # a tile's warp count is the kernel's module constant while its
        # contender traces and runs
        pm.NUM_WARPS = extra.get("warps", warps_default)
        try:
            t = measure(fn, p0s, data, reps=args.reps)
        finally:
            pm.NUM_WARPS = warps_default
        p = np.asarray(t.out.p)
        rec = float(np.mean(np.all(np.abs(p - sp.P_TRUE[None]) < 0.2, -1)))
        line = {"cell": "batched-sample", "contender": name, "form": form,
                "batch": B, "rows": R, "solves_per_s": B / t.warm_s,
                "warm_ms": t.warm_s * 1e3,
                "runs_ms": [r * 1e3 for r in t.runs_s],
                "first_call_s": t.first_s, "recovered_frac": rec,
                "mean_steps": float(np.mean(np.asarray(t.out.step_count))),
                "gate_ok": gate(rec), "device": device, **extra}
        print(json.dumps(line), flush=True)
        if line["gate_ok"] is False:
            failed.append(name)

    contenders = []     # (name, form, jitted fn, data, extra fields fn)
    for spec in filter(None, args.tiles.split(",")):
        bt, warps = (int(v) for v in spec.split("x"))
        for form, (fn, data) in forms.items():
            kinds = [("adapted",) + adapted(fn, data)]
            if form in hand and R == sp.NMEAS:
                kinds.append(("hand", hand[form], (), None))
            for kind, lanes, sh, ops in kinds:
                f = jax.jit(lambda q, d, _l=lanes, _s=sh, _bt=bt:
                            megakernel_optimize(
                                _l, q, prm, problem_data=tuple(
                                    jax.tree_util.tree_leaves(d)),
                                shared_data=_s, block_batch=_bt))
                contenders.append((
                    f"kernel-{kind}-{form}-{spec}", form, f, data,
                    lambda _b=bt, _w=warps, _o=ops: {
                        "lanes": _b, "warps": _w, "lane_ops": _o}))
    for form, (fn, data) in forms.items():
        f = jax.jit(lambda q, d, _fn=fn: batched_optimize(
            _fn, q, prm, problem_data=d, use_megakernel=True))
        contenders.append((f"mega-{form}", form, f, data,
                           lambda _fn=fn, _d=data: {
                               "lane_ops": adapted(_fn, _d)[2]}))
        for unroll in (1, 2):
            f = jax.jit(lambda q, d, _fn=fn, _u=unroll: batched_optimize(
                _fn, q, prm, problem_data=d, use_megakernel=False,
                wavefront_unroll=_u))
            contenders.append((f"xla-u{unroll}-{form}", form, f, data,
                               dict))
    only = set(filter(None, args.only.split(",")))
    for name, form, f, data, extra in contenders:
        if not only or name in only:
            run(name, form, f, data, extra)

    if failed:
        print(f"correctness gate failed: {failed}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
