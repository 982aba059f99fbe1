"""Batched independent solves, sharded across a device mesh.

The data-parallel row of SURVEY.md's parallelism table: the reference solves
one problem per process (dogleg.c:1633); here a batch of independent problem
instances is vmapped into one program and its batch axis sharded across
chips/hosts. There is no cross-problem communication — scaling is
embarrassingly parallel, and each batch element freezes at its own
termination point inside the shared while_loop (cost per wavefront = the
slowest still-running element).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from libdogleg_tpu.params import DoglegParameters
from libdogleg_tpu.solver import SolveResult, solve_products


def shard_batch(tree: Any, mesh: Mesh, axis_name: str = "dp") -> Any:
    """Place a pytree of batch-leading arrays with the batch axis sharded."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, sharding), tree)


# Auto-selection bounds for BlockedDenseNewtonSolver: it only pays in the
# genuinely batched regime (the win is amortized over thousands of vmapped
# instances) and its trace-time unrolling costs tens of seconds of compile
# at Nstate=128 (worse at 256) — so auto-select needs BOTH a real batch
# and a capped Nstate. Explicit opt-in (newton_solver=
# BlockedDenseNewtonSolver()) still covers the full 17..256 window.
AUTO_BLOCKED_MIN_BATCH = 128
AUTO_BLOCKED_MAX_N = 128


def _check_layout(layout: str) -> None:
    if layout not in ("leading", "minor"):
        raise ValueError(
            f"layout must be 'leading' or 'minor', got {layout!r}")


def _minor_spec(mesh: Mesh, axis_name: str):
    """Per-leaf NamedSharding putting axis_name on the LAST axis — the
    batch axis of a layout='minor' carry (leaves are (..., B))."""
    def spec_for(a):
        nd = jnp.ndim(a)
        return NamedSharding(
            mesh, P(*([None] * (nd - 1) + [axis_name])) if nd else P())
    return spec_for


def _auto_newton(products_fn, p0_batch, problem_data):
    """Batch-regime strategy default: for a dense square JtJ with mid-size
    Nstate (17..128) and batch >= 128, the blocked-panel Cholesky beats
    XLA's batched lax.linalg lowering by ~26x
    (ops/newton.BlockedDenseNewtonSolver); below the Nstate window
    smallchol already handles it, above it lax.linalg wins, and small
    batches don't amortize blockchol's long unrolled compile. Returns
    None (solver default) outside that regime or for structured JtJ
    representations (Schur, block-sparse)."""
    from libdogleg_tpu.ops.newton import (BLOCKED_MIN_N,
                                          BlockedDenseNewtonSolver)
    batch = jax.tree_util.tree_leaves(p0_batch)[0].shape[0]
    if batch < AUTO_BLOCKED_MIN_BATCH:
        return None
    try:
        p0 = jax.tree_util.tree_map(lambda a: a[0], p0_batch)
        if problem_data is None:
            jtj = jax.eval_shape(lambda p: products_fn(p).JtJ, p0)
        else:
            d0 = jax.tree_util.tree_map(lambda a: a[0], problem_data)
            jtj = jax.eval_shape(lambda p, d: products_fn(p, d).JtJ, p0, d0)
    except Exception:
        return None
    shp = getattr(jtj, "shape", None)
    if (shp is not None and len(shp) == 2 and shp[0] == shp[1]
            and BLOCKED_MIN_N <= shp[0] <= AUTO_BLOCKED_MAX_N):
        return BlockedDenseNewtonSolver()
    return None


def _try_megakernel(products_fn, p0_batch, prm, *, mesh, axis_name,
                    problem_data, newton_solver, record_history,
                    use_megakernel):
    """Shared selection gate: returns a SolveResult when the whole-solve
    megakernel took the batch, else None (parallel/mega_auto.py)."""
    from libdogleg_tpu.parallel.mega_auto import plan_megakernel
    if use_megakernel is False:
        return None
    forced = bool(use_megakernel)
    if record_history or newton_solver is not None:
        if forced:
            raise ValueError(
                "use_megakernel=True is incompatible with record_history "
                "and custom newton_solver (ops/pallas_mega.py docstring)")
        return None
    plan = plan_megakernel(products_fn, p0_batch, prm,
                           problem_data=problem_data, mesh=mesh,
                           axis_name=axis_name, forced=forced)
    return None if plan is None else plan()


def batched_optimize(products_fn,
                     p0_batch: jnp.ndarray,
                     parameters: Optional[DoglegParameters] = None,
                     *,
                     mesh: Optional[Mesh] = None,
                     axis_name: str = "dp",
                     problem_data: Any = None,
                     newton_solver=None,
                     layout: str = "leading",
                     record_history: bool = False,
                     history_capacity: Optional[int] = None,
                     wavefront_unroll: int = 1,
                     use_megakernel: Optional[bool] = None) -> SolveResult:
    """Solve a batch of independent problems, optionally mesh-sharded.

    Args:
      products_fn: either p -> Products (shared problem data, distinct
        starts), or (p, data_i) -> Products when problem_data is given
        (per-element problem instances — the 10k-problems-per-chip benchmark
        configuration, BASELINE.md config 3).
      p0_batch: (B, Nstate) initial states.
      mesh/axis_name: if given, constrain inputs and results to be sharded
        along the batch axis of this mesh; XLA partitions the whole vmapped
        while_loop with zero communication.
      problem_data: optional pytree with leading batch axis.
      newton_solver: strategy override; None auto-selects
        BlockedDenseNewtonSolver for dense mid-size JtJ (see _auto_newton);
        pass DenseNewtonSolver() to force the XLA lax.linalg path.
      layout: "leading" (default) vmaps over axis 0, so every solver-carry
        tensor is (B, ...). "minor" moves the batch axis to the MINOR dimension inside the
        jitted region (one transpose at entry/exit; carries become
        (..., B)). The public
        interface is unchanged: inputs and results are batch-leading
        either way. Exactness: same program order per element, tested
        identical. Composes with mesh= (the transpose happens inside the
        jitted region; boundary shardings stay batch-leading).
      record_history / history_capacity: keep the per-attempt vnlog-schema
        History in the result (one (cap,)-row buffer per batch element,
        leading batch axis like every other result leaf) — the reference's
        only observability stream (dogleg.c:42-113), reachable from the
        production batched path.
      wavefront_unroll: attempts composed per while_loop wavefront
        (exact — the body freezes done lanes). See solver.run_solver.
      use_megakernel: None (default) selects the whole-solve Pallas
        megakernel (ops/pallas_mega.py) when the problem fits its
        regime: GPU backend, (B, n <= 16) f32 states, dense
        JtJ, no history/custom strategy, products the lane interpreter
        covers (parallel/mega_auto.py). The regime is checked before
        anything compiles; a compile fault of the chosen kernel raises.
        True forces it (ValueError outside the regime); False disables
        it. The megakernel computes every
        product in float32, whatever precision the products' matrix
        products ask for, and is then decision-identical to the XLA path
        up to roundoff (tested at Precision.HIGHEST). At JAX's default
        precision the GPU's XLA path forms them in TF32, and the two
        agree on step_count for about two thirds of the instances of the
        sample problem (PERF.md; the precision policy is ROADMAP A7).
        layout and wavefront_unroll are XLA-path tuning knobs it
        ignores.

    Returns a SolveResult whose leaves carry the leading batch axis.
    """
    _check_layout(layout)
    prm = parameters if parameters is not None else DoglegParameters()
    mega = _try_megakernel(products_fn, p0_batch, prm, mesh=mesh,
                           axis_name=axis_name, problem_data=problem_data,
                           newton_solver=newton_solver,
                           record_history=record_history,
                           use_megakernel=use_megakernel)
    if mega is not None:
        return mega
    if newton_solver is None:
        newton_solver = _auto_newton(products_fn, p0_batch, problem_data)

    if problem_data is None:
        solve_one = lambda p0: solve_products(
            products_fn, p0, prm, newton_solver=newton_solver,
            record_history=record_history,
            history_capacity=history_capacity,
            wavefront_unroll=wavefront_unroll)
        args = (p0_batch,)
    else:
        solve_one = lambda p0, data: solve_products(
            lambda p: products_fn(p, data), p0, prm,
            newton_solver=newton_solver, record_history=record_history,
            history_capacity=history_capacity,
            wavefront_unroll=wavefront_unroll)
        args = (p0_batch, problem_data)

    if layout == "minor":
        vf = jax.vmap(solve_one, in_axes=-1, out_axes=-1)

        def fn(*a):
            ta = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1),
                                        a)
            r = vf(*ta)
            return jax.tree_util.tree_map(
                lambda x: jnp.moveaxis(x, -1, 0), r)
    else:
        fn = jax.vmap(solve_one)
    if mesh is not None:
        spec = P(axis_name)
        in_shardings = jax.tree_util.tree_map(
            lambda _: NamedSharding(mesh, spec), args)
        fn = jax.jit(fn, in_shardings=in_shardings,
                     out_shardings=NamedSharding(mesh, spec))
    else:
        fn = jax.jit(fn)
    return fn(*args)


def batched_optimize_compacted(products_fn,
                               p0_batch: jnp.ndarray,
                               parameters: Optional[DoglegParameters] = None,
                               *,
                               mesh: Optional[Mesh] = None,
                               axis_name: str = "dp",
                               problem_data: Any = None,
                               phase1_attempts: Optional[int] = None,
                               compact_capacity: Optional[int] = None,
                               newton_solver=None,
                               layout: str = "leading",
                               record_history: bool = False,
                               history_capacity: Optional[int] = None,
                               wavefront_unroll: int = 1,
                               use_megakernel: Optional[bool] = None):
    """Batched solves with straggler compaction.

    A vmapped while_loop runs until the SLOWEST batch element terminates,
    so the tail of hard problems makes the whole batch pay (measured: mean
    8.5 attempts vs max 15 on the benchmark workload). This variant runs a
    full-width phase 1, gathers the unfinished minority into a
    compact_capacity-sized buffer, finishes only those, scatters back, and
    runs a final full-batch pass as a correctness safety net — a no-op
    when the capacity held, a full finish (same result, no speedup) when
    it did not. Exact in all cases.

    Tuning (auto by default):
      phase1_attempts=None runs phase 1 ADAPTIVELY: a batch-level
        while_loop advances everyone one attempt at a time until the
        not-done count fits compact_capacity (an in-graph reduction per
        attempt — no host sync, so the decision costs nothing on a remote
        backend). An integer pins the legacy fixed-length behavior.
      compact_capacity=None defaults to batch/16: stragglers past the
        ~94th percentile of the attempts distribution go to the compact
        pass, whose per-wavefront cost is 1/16 of full width. Any value
        is exact; this only moves work between phases.

    mesh/axis_name compose compaction with data parallelism (the pod
    deployment shape): inputs/outputs are constrained to shard along the
    batch axis, and the compact straggler buffer is ALSO constrained to
    shard over the same axis — the gather from the full batch into the
    buffer is the one cross-device exchange (an all-gather of straggler
    indices + a resharding gather, cap-sized, once per solve), after
    which the compact pass runs data-parallel like phase 1. Results are
    exact and identical to the unsharded form (tested on the 8-device
    mesh); the adaptive phase-1 stopping reduction is a global psum.

    layout="minor" runs the whole pipeline with the batch as the minor
    dimension inside the jitted region (see batched_optimize.layout).
    It composes with mesh=: boundary shardings stay batch-leading (the
    transpose is inside the jit), and the internal straggler-buffer
    constraint shards the TRAILING axis of every carry leaf instead of
    the leading one.

    record_history / history_capacity: as in batched_optimize. History
    buffers ride the solver-state pytree, so they are gathered into the
    compact pass and scattered back with everything else; re-run lanes
    (duplicate fill indices) are frozen by the solver's done-masking, so
    their rows are rewritten unchanged.

    Returns a SolveResult with the leading batch axis, identical to
    batched_optimize.
    """
    from libdogleg_tpu.solver import (init_solver_state, result_from_state,
                                      run_solver)
    _check_layout(layout)
    prm = parameters if parameters is not None else DoglegParameters()
    # megakernel promotion: when the whole-solve kernel takes the batch,
    # compaction is moot — its wavefront granularity is already the lane
    # tile, so a tile only waits for its own slowest member.
    mega = _try_megakernel(products_fn, p0_batch, prm, mesh=mesh,
                           axis_name=axis_name, problem_data=problem_data,
                           newton_solver=newton_solver,
                           record_history=record_history,
                           use_megakernel=use_megakernel)
    if mega is not None:
        return mega
    batch = jax.tree_util.tree_leaves(p0_batch)[0].shape[0]
    cap = compact_capacity or max(batch // 16, 1)
    if newton_solver is None:
        newton_solver = _auto_newton(products_fn, p0_batch, problem_data)
    minor = layout == "minor"

    def products_of(data):
        if problem_data is None:
            return products_fn
        return lambda p: products_fn(p, data)

    if minor:
        bvmap = lambda f: jax.vmap(f, in_axes=-1, out_axes=-1)
        gather = lambda a, idx: a[..., idx]
        scatter = lambda full, idx, part: full.at[..., idx].set(part)
    else:
        bvmap = jax.vmap
        gather = lambda a, idx: a[idx]
        scatter = lambda full, idx, part: full.at[idx].set(part)

    def run(p0s, data):
        if minor:
            p0s, data = jax.tree_util.tree_map(
                lambda a: jnp.moveaxis(a, 0, -1), (p0s, data))

        def init_one(p0, d):
            return init_solver_state(products_of(d), p0, prm,
                                     record_history=record_history,
                                     history_capacity=history_capacity)

        def seg_one(st, d, k):
            # unroll composes with segmentation: a k=wavefront_unroll
            # budget runs as exactly one unrolled wavefront (the body
            # satisfies the attempt budget in one loop iteration)
            return run_solver(products_of(d), st, prm, max_new_attempts=k,
                              newton_solver=newton_solver,
                              wavefront_unroll=wavefront_unroll)

        st = bvmap(init_one)(p0s, data)
        if phase1_attempts is not None:
            st = bvmap(lambda s, d: seg_one(s, d, phase1_attempts))(
                st, data)
        else:
            # adaptive: stop full-width work when the stragglers fit the
            # compact buffer (or everyone terminated). The fit check runs
            # once per (possibly unrolled) wavefront.
            st = jax.lax.while_loop(
                lambda s: jnp.sum(~s.done) > cap,
                lambda s: bvmap(lambda si, d: seg_one(
                    si, d, wavefront_unroll))(s, data),
                st)

        # compact the stragglers (duplicate fill indices are harmless:
        # run_solver freezes done states, so re-solving lane 0 rewrites
        # its own identical state)
        idx = jnp.nonzero(~st.done, size=cap, fill_value=0)[0]
        if mesh is not None:
            # keep the compact pass data-parallel too: without the
            # constraint the partitioner may replicate the cap-sized
            # buffer and run the straggler pass redundantly on every
            # device. The batch axis of a gathered leaf is leading for
            # layout="leading" and trailing for layout="minor".
            if minor:
                spec_for = _minor_spec(mesh, axis_name)
                take = lambda x: jax.tree_util.tree_map(
                    lambda a: jax.lax.with_sharding_constraint(
                        gather(a, idx), spec_for(a)), x)
            else:
                shard = NamedSharding(mesh, P(axis_name))
                take = lambda x: jax.tree_util.tree_map(
                    lambda a: jax.lax.with_sharding_constraint(
                        gather(a, idx), shard), x)
        else:
            take = lambda x: jax.tree_util.tree_map(
                lambda a: gather(a, idx), x)
        sub = bvmap(lambda s, d: run_solver(
            products_of(d), s, prm, newton_solver=newton_solver,
            wavefront_unroll=wavefront_unroll))(take(st), take(data))
        st = jax.tree_util.tree_map(
            lambda full, part: scatter(full, idx, part), st, sub)

        # safety net: finishes any element the capacity guess missed;
        # otherwise a single (false) loop-condition check per element
        st = bvmap(lambda s, d: seg_one(s, d, None))(st, data)
        res = result_from_state(st)
        if minor:
            res = jax.tree_util.tree_map(
                lambda a: jnp.moveaxis(a, -1, 0), res)
        return res

    if problem_data is None:
        problem_data = jnp.zeros((batch, 0))  # dummy; products_of ignores it
    if mesh is not None:
        spec = NamedSharding(mesh, P(axis_name))
        run = jax.jit(run,
                      in_shardings=jax.tree_util.tree_map(
                          lambda _: spec, (p0_batch, problem_data)),
                      out_shardings=spec)
    else:
        run = jax.jit(run)
    return run(p0_batch, problem_data)
