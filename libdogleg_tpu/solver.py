"""Powell's dog-leg trust-region driver as a jitted fixed-point iteration.

This is the counterpart of the reference's runOptimizer /
takeStepFrom / evaluateStep_adjustTrustRegion machinery (reference
dogleg.c:1172-1476). The reference drives the iteration with nested C loops,
two malloc'd operating points swapped by pointer on accept (dogleg.c:1441-1444)
and a lazy-computation bitfield that skips recomputing the Cauchy/GN steps and
the factorization when a step is rejected (dogleg.h:86-100). Here the same
structure is expressed functionally:

  * solver state is a pytree carried through one flat `lax.while_loop`, where
    each loop iteration is one step *attempt* (the reference's inner retry
    loop body, dogleg.c:1380-1468);
  * "pointer swap on accept" is a masked `tree_where(accept, trial, current)`;
  * the lazy bits become `lax.cond`s: the Cauchy step is computed once per
    operating point, the Gauss-Newton step (and the JtJ factorization behind
    it) only when the Cauchy step does not already fill the trust region and
    the cached GN step is stale. A rejected step therefore re-runs *no*
    factorization at runtime, preserving dog-leg's key advantage over
    Levenberg-Marquardt (reference README.pod:46-50);
  * every carry update is masked by the `done` flag, which makes the loop
    `vmap`-safe: a batch of independent solves runs until all elements
    terminate, each freezing at its own stopping point.

Termination criteria and their exact placement match the reference:
  1. inf-norm(Jt_x) <= Jt_x_threshold, checked when an operating point is
     evaluated (dogleg.c:1071-1082) — on the initial point (dogleg.c:1364-1371)
     and, for trial points, acted on only if the step is accepted
     (dogleg.c:1446-1451);
  2. inf-norm(step) <= update_threshold, checked after computing the candidate
     step, before evaluating it (dogleg.c:1287-1296);
  3. trustregion < trustregion_threshold, checked only after a rejected step
     (dogleg.c:1460-1466);
  4. max_iterations accepted steps (dogleg.c:1376).
"""

from __future__ import annotations

import enum
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from libdogleg_tpu.params import DoglegParameters
from libdogleg_tpu.ops import dense as dops
from libdogleg_tpu.ops.newton import DenseNewtonSolver


class Products(NamedTuple):
    """An operating point reduced over the measurement axis.

    The universal currency of the solver: all three of the reference's problem
    formulations (sparse dogleg.h:11-20, dense dogleg.h:21-30, dense-products
    dogleg.h:34-45) reduce to these three quantities, which is all the
    trust-region iteration ever needs.
    """
    norm2_x: jnp.ndarray  # scalar: norm2(f(p))
    Jt_x: jnp.ndarray     # (Nstate,): J^T x, half the cost gradient
    JtJ: Any              # Gauss-Newton Hessian approx: a dense
    #                       (Nstate, Nstate) matrix by default, or any pytree
    #                       the chosen NewtonSolver strategy understands
    #                       (e.g. ops.newton.SchurJtJ)


ProductsFn = Callable[[jnp.ndarray], Products]


class StopReason(enum.IntEnum):
    """Why the solve stopped. The reference reports these distinctions only in
    its stderr debug stream (dogleg.c:1079,1293,1448,1464,1473); here they are
    a first-class result field."""
    RUNNING = 0
    GRADIENT_CONVERGED = 1    # criterion 1: inf-norm(Jt_x) below threshold
    SMALL_STEP = 2            # criterion 2: inf-norm(step) below threshold
    SMALL_TRUSTREGION = 3     # criterion 3: region shrank below threshold
    MAX_ITERATIONS = 4        # criterion 4
    STALLED = 5               # attempt-cap safety net (no reference analog)
    FACTORIZATION_FAILED = 6  # lambda escalated past lambda_max_tries


class StepType(enum.IntEnum):
    """Matches the reference vnlog step-type taxonomy (dogleg.c:42-46)."""
    CAUCHY = 0
    GAUSSNEWTON = 1
    INTERPOLATED = 2
    FAILED = 3
    UNINITIALIZED = 4


class History(NamedTuple):
    """Per-attempt diagnostic record, one row per step attempt — the same
    14-field schema as the reference vnlog debug stream (dogleg.c:50-64) plus
    the iteration/step_accepted prefix (dogleg.c:104-113). Unset fields hold
    +inf, which the vnlog writer renders as '-' (dogleg.c:83-87)."""
    iteration: jnp.ndarray                  # (cap,) int32
    step_accepted: jnp.ndarray              # (cap,) int32
    norm2x_before: jnp.ndarray              # (cap,)
    norm2x_after: jnp.ndarray               # (cap,)
    step_len_cauchy: jnp.ndarray            # (cap,)
    step_len_gauss_newton: jnp.ndarray      # (cap,)
    step_len_interpolated: jnp.ndarray      # (cap,)
    k_cauchy_to_gn: jnp.ndarray             # (cap,)
    step_len: jnp.ndarray                   # (cap,)
    step_type: jnp.ndarray                  # (cap,) int32 (StepType)
    step_direction_change_deg: jnp.ndarray  # (cap,)
    expected_improvement: jnp.ndarray       # (cap,)
    observed_improvement: jnp.ndarray       # (cap,)
    rho: jnp.ndarray                        # (cap,)
    trustregion_before: jnp.ndarray         # (cap,)
    trustregion_after: jnp.ndarray          # (cap,)


class SolveResult(NamedTuple):
    p: jnp.ndarray            # (Nstate,) final state
    norm2_x: jnp.ndarray      # scalar: cost at the final state
    Jt_x: jnp.ndarray         # (Nstate,) gradient at the final state
    JtJ: jnp.ndarray          # (Nstate, Nstate) at the final state
    step_count: jnp.ndarray   # int32: accepted steps (the reference's return)
    n_attempts: jnp.ndarray   # int32: total attempts incl. rejects
    reason: jnp.ndarray       # int32 StopReason
    trustregion: jnp.ndarray  # scalar: final trust-region radius
    lam: jnp.ndarray          # scalar: permanent Tikhonov lambda
    history: Optional[History] = None


class _Carry(NamedTuple):
    # Current (accepted) operating point — the reference's ctx->beforeStep.
    p: jnp.ndarray
    norm2_x: jnp.ndarray
    Jt_x: jnp.ndarray
    JtJ: jnp.ndarray
    # Cached update vectors (reference dogleg.h:72-80: reused when a step is
    # rejected and we retry with a smaller region).
    cauchy: jnp.ndarray
    norm2_cauchy: jnp.ndarray
    have_cauchy: jnp.ndarray
    gn: jnp.ndarray
    norm2_gn: jnp.ndarray
    have_gn: jnp.ndarray
    # The accepted step that led into the current point (reference
    # step_to_here, dogleg.h:102-103; used only for diagnostics).
    prev_step: jnp.ndarray
    norm2_prev_step: jnp.ndarray
    have_prev_step: jnp.ndarray
    # Solver scalars.
    lam: jnp.ndarray
    trustregion: jnp.ndarray
    step_count: jnp.ndarray
    n_attempts: jnp.ndarray
    done: jnp.ndarray
    reason: jnp.ndarray
    history: Optional[History]


from libdogleg_tpu.ops.treevec import (tree_add as _tree_add,
                                       tree_any_exceeds as _tree_any_exceeds,
                                       tree_dot as _tree_dot,
                                       tree_scale as _tree_scale,
                                       tree_where as _tree_where,
                                       tree_zeros_like as _tree_zeros_like)


def _grad_converged(Jt_x, threshold):
    """Criterion 1 (reference dogleg.c:1071-1082): converged iff no gradient
    element exceeds the threshold in absolute value."""
    return ~_tree_any_exceeds(Jt_x, threshold)


def _empty_history(cap: int, dtype) -> History:
    inf = jnp.full((cap,), jnp.inf, dtype=dtype)
    i32 = jnp.full((cap,), -1, dtype=jnp.int32)
    return History(
        iteration=i32, step_accepted=i32,
        norm2x_before=inf, norm2x_after=inf,
        step_len_cauchy=inf, step_len_gauss_newton=inf,
        step_len_interpolated=inf, k_cauchy_to_gn=inf,
        step_len=inf,
        step_type=jnp.full((cap,), int(StepType.UNINITIALIZED), jnp.int32),
        step_direction_change_deg=inf,
        expected_improvement=inf, observed_improvement=inf, rho=inf,
        trustregion_before=inf, trustregion_after=inf)


def solve_products(products_fn: ProductsFn,
                   p0: jnp.ndarray,
                   parameters: Optional[DoglegParameters] = None,
                   *,
                   newton_solver=None,
                   record_history: bool = False,
                   history_capacity: Optional[int] = None,
                   wavefront_unroll: int = 1,
                   debug: bool = False) -> SolveResult:
    """Run the dog-leg trust-region optimization.

    Args:
      products_fn: pure function p -> Products. This is the library/user
        boundary — the functional equivalent of the reference's callback
        (dogleg.c:1016, invoked once per attempted step at the trial point and
        once per accepted point, same as the reference).
      p0: (Nstate,) initial state.
      parameters: solver parameters (defaults match the reference).
      newton_solver: strategy for quad_form / Gauss-Newton on the JtJ
        representation (default ops.newton.DenseNewtonSolver; pass
        SchurNewtonSolver for BA-style arrow systems).
      record_history: keep a per-attempt vnlog-schema History in the result.
      history_capacity: static row count of the history buffer; defaults to
        the attempt cap. Attempts past capacity overwrite the last row.

    Returns a SolveResult. Fully jittable and vmappable.
    """
    state = init_solver_state(products_fn, p0, parameters,
                              record_history=record_history,
                              history_capacity=history_capacity)
    final = run_solver(products_fn, state, parameters,
                       newton_solver=newton_solver,
                       wavefront_unroll=wavefront_unroll, debug=debug)
    return result_from_state(final)


def init_solver_state(products_fn: ProductsFn,
                      p0: jnp.ndarray,
                      parameters: Optional[DoglegParameters] = None,
                      *,
                      record_history: bool = False,
                      history_capacity: Optional[int] = None) -> "_Carry":
    """Evaluate the initial operating point and build the solver-state
    pytree (the reference's context + beforeStep setup, dogleg.c:1633-1733,
    including the initial convergence test at dogleg.c:1364-1371).

    The returned state is an ordinary pytree: it can be saved/restored
    (checkpoint/resume for long batched runs — absent in the reference,
    SURVEY.md section 5.4), vmapped, and passed to run_solver in bounded
    slices.
    """
    prm = parameters if parameters is not None else DoglegParameters()
    p0 = jax.tree_util.tree_map(jnp.asarray, p0)
    dtype = jax.tree_util.tree_leaves(p0)[0].dtype
    max_attempts = prm.resolved_max_attempts()

    init = products_fn(p0)
    zero_vec = _tree_zeros_like(p0)
    f_false = jnp.asarray(False)

    converged0 = _grad_converged(init.Jt_x, prm.Jt_x_threshold)
    history = None
    if record_history:
        cap = history_capacity or max_attempts
        history = _empty_history(cap, dtype)

    carry0 = _Carry(
        p=p0, norm2_x=init.norm2_x, Jt_x=init.Jt_x, JtJ=init.JtJ,
        cauchy=zero_vec, norm2_cauchy=jnp.asarray(0.0, dtype),
        have_cauchy=f_false,
        gn=zero_vec, norm2_gn=jnp.asarray(0.0, dtype), have_gn=f_false,
        prev_step=zero_vec, norm2_prev_step=jnp.asarray(0.0, dtype),
        have_prev_step=f_false,
        lam=jnp.asarray(0.0, dtype),
        trustregion=jnp.asarray(prm.trustregion0, dtype),
        step_count=jnp.asarray(0, jnp.int32),
        n_attempts=jnp.asarray(0, jnp.int32),
        done=converged0,
        reason=jnp.where(converged0,
                         jnp.asarray(int(StopReason.GRADIENT_CONVERGED),
                                     jnp.int32),
                         jnp.asarray(int(StopReason.RUNNING), jnp.int32)),
        history=history,
    )
    return carry0


def run_solver(products_fn: ProductsFn,
               state: "_Carry",
               parameters: Optional[DoglegParameters] = None,
               *,
               newton_solver=None,
               max_new_attempts: Optional[int] = None,
               wavefront_unroll: int = 1,
               debug: bool = False) -> "_Carry":
    """Advance the solve until termination (default) or for at most
    max_new_attempts further step attempts — the segmented form used for
    checkpointed long runs. Jittable and vmappable; resuming from a saved
    state continues the iteration exactly (all caches, lambda, and the
    trust region live in the state).

    wavefront_unroll > 1 composes the attempt body k times per
    while_loop iteration. EXACT for the default full-run form (the body
    freezes done lanes, so extra applications are identity); under
    max_new_attempts the attempt budget is rounded up to a multiple of
    k. Purpose: amortize the batched carry's HBM round-trip + wavefront
    dispatch over k attempts where XLA can fuse across the chained
    bodies."""
    prm = parameters if parameters is not None else DoglegParameters()
    ns = newton_solver if newton_solver is not None else DenseNewtonSolver()
    max_attempts = prm.resolved_max_attempts()
    dtype = jax.tree_util.tree_leaves(state.p)[0].dtype
    f_true = jnp.asarray(True)
    f_false = jnp.asarray(False)

    def attempt(c: _Carry) -> _Carry:
        """One step attempt: the body of the reference's retry loop
        (dogleg.c:1380-1468)."""
        tr = c.trustregion
        tr_sq = tr * tr

        # --- Cauchy step, computed once per operating point (reference
        # compute_updateCauchy, dogleg.c:529-617).
        def fresh_cauchy(_):
            # k = -norm2(Jt x) / norm2(J Jt x) with the denominator as the
            # JtJ quadratic form (reference dogleg.c:536-610).
            n2_jtx = _tree_dot(c.Jt_x, c.Jt_x)
            k = -n2_jtx / ns.quad_form(c.JtJ, c.Jt_x)
            return _tree_scale(k, c.Jt_x), k * k * n2_jtx
        cauchy, norm2_cauchy = jax.lax.cond(
            c.have_cauchy,
            lambda _: (c.cauchy, c.norm2_cauchy),
            fresh_cauchy, operand=None)

        use_cauchy = norm2_cauchy >= tr_sq

        # --- Gauss-Newton step, lazily (reference compute_updateGN,
        # dogleg.c:822-908, called only when the Cauchy step is interior,
        # dogleg.c:1218). The factorization (and any lambda escalation)
        # happens inside this cond, so rejected-step retries and
        # Cauchy-limited attempts never pay for it.
        need_gn = (~use_cauchy) & (~c.have_gn)

        def fresh_gn(_):
            res = ns.gauss_newton(c.JtJ, c.Jt_x, c.lam,
                                  lambda_initial=prm.lambda_initial,
                                  lambda_max_tries=prm.lambda_max_tries)
            return res.step, res.norm2_step, res.lam, res.ok

        gn, norm2_gn, lam, fac_ok = jax.lax.cond(
            need_gn,
            fresh_gn,
            lambda _: (c.gn, c.norm2_gn, c.lam, f_true),
            operand=None)
        have_gn = c.have_gn | need_gn

        # --- Step selection (reference takeStepFrom, dogleg.c:1172-1297).
        use_gn = (~use_cauchy) & (norm2_gn <= tr_sq)
        interp = dops.interpolated_step(cauchy, norm2_cauchy, gn, tr)

        inv_cauchy_len = tr / jnp.sqrt(norm2_cauchy)
        step = _tree_where(
            use_cauchy, _tree_scale(inv_cauchy_len, cauchy),
            _tree_where(use_gn, gn, interp.step))
        # NOTE: for the truncated-Cauchy case the reference records the
        # *unclamped* Cauchy length as norm2_step (dogleg.c:1200), even though
        # the actual step is scaled to the region edge; norm2_step is only
        # used for the direction-change diagnostic, and we reproduce the
        # behavior for trace parity.
        norm2_step = jnp.where(
            use_cauchy, norm2_cauchy,
            jnp.where(use_gn, norm2_gn, interp.norm2_step))
        stepped_to_edge = ~use_gn
        step_type = jnp.where(
            use_cauchy, int(StepType.CAUCHY),
            jnp.where(use_gn, int(StepType.GAUSSNEWTON),
                      int(StepType.INTERPOLATED))).astype(jnp.int32)

        # Linearized model decrease (reference dogleg.c:1085-1165).
        expected = (-2.0 * _tree_dot(c.Jt_x, step)
                    - ns.quad_form(c.JtJ, step))

        # --- Criterion 2 (reference dogleg.c:1287-1296): a tiny step means
        # we are done, *without* evaluating the trial point.
        small_step = ~_tree_any_exceeds(step, prm.update_threshold)

        # --- Evaluate the trial point (reference dogleg.c:1411). Under jit
        # both cond branches are traced but only one runs; under vmap this
        # becomes a select and the spurious evaluation is masked out below.
        p_new = _tree_add(c.p, step)
        trial = jax.lax.cond(
            small_step | ~fac_ok,
            lambda _: Products(norm2_x=c.norm2_x, Jt_x=c.Jt_x, JtJ=c.JtJ),
            lambda _: products_fn(p_new),
            operand=None)

        observed = c.norm2_x - trial.norm2_x
        rho = observed / expected

        # --- Trust-region update (reference dogleg.c:1300-1356). In the
        # interior-step branch norm2_gn is always valid: interior => GN step.
        tr_new = dops.trust_region_update(
            rho, tr, stepped_to_edge, norm2_gn,
            decrease_factor=prm.trustregion_decrease_factor,
            decrease_threshold=prm.trustregion_decrease_threshold,
            increase_factor=prm.trustregion_increase_factor,
            increase_threshold=prm.trustregion_increase_threshold)

        accept = rho > 0.0
        step_count_new = c.step_count + 1

        # Criterion 1 on the trial point, acted on only if accepted
        # (reference afterStepZeroGradient, dogleg.c:1410-1451).
        trial_grad_converged = _grad_converged(trial.Jt_x, prm.Jt_x_threshold)

        # --- Assemble the post-attempt carry for each of the three paths.
        n_attempts = c.n_attempts + 1
        attempts_exhausted = n_attempts >= max_attempts

        def mk(reason, done):
            return (jnp.asarray(int(reason), jnp.int32), done)

        # Path A: small-step termination (criterion 2) — state unchanged.
        # Path F: factorization failed terminally.
        # Path B: accepted — trial becomes current, caches reset.
        # Path C: rejected — keep point, keep caches, shrink region.
        accepted = _Carry(
            p=p_new, norm2_x=trial.norm2_x, Jt_x=trial.Jt_x, JtJ=trial.JtJ,
            cauchy=cauchy, norm2_cauchy=norm2_cauchy, have_cauchy=f_false,
            gn=gn, norm2_gn=norm2_gn, have_gn=f_false,
            prev_step=step, norm2_prev_step=norm2_step,
            have_prev_step=f_true,
            lam=lam, trustregion=tr_new,
            step_count=step_count_new, n_attempts=n_attempts,
            done=(trial_grad_converged
                  | (step_count_new >= prm.max_iterations)
                  | attempts_exhausted),
            reason=jnp.where(
                trial_grad_converged,
                int(StopReason.GRADIENT_CONVERGED),
                jnp.where(step_count_new >= prm.max_iterations,
                          int(StopReason.MAX_ITERATIONS),
                          jnp.where(attempts_exhausted,
                                    int(StopReason.STALLED),
                                    int(StopReason.RUNNING)))
            ).astype(jnp.int32),
            history=c.history,
        )
        rejected_done = (tr_new < prm.trustregion_threshold) \
            | attempts_exhausted
        rejected = accepted._replace(
            p=c.p, norm2_x=c.norm2_x, Jt_x=c.Jt_x, JtJ=c.JtJ,
            have_cauchy=f_true, have_gn=have_gn,
            prev_step=c.prev_step, norm2_prev_step=c.norm2_prev_step,
            have_prev_step=c.have_prev_step,
            step_count=c.step_count,
            done=rejected_done,
            reason=jnp.where(
                tr_new < prm.trustregion_threshold,
                int(StopReason.SMALL_TRUSTREGION),
                jnp.where(attempts_exhausted, int(StopReason.STALLED),
                          int(StopReason.RUNNING))).astype(jnp.int32),
        )
        small = rejected._replace(
            trustregion=tr, n_attempts=n_attempts,
            have_gn=have_gn,
            done=f_true,
            reason=jnp.asarray(int(StopReason.SMALL_STEP), jnp.int32))
        failed = small._replace(
            lam=lam,
            reason=jnp.asarray(int(StopReason.FACTORIZATION_FAILED),
                               jnp.int32))

        out = _tree_where(
            ~fac_ok, failed,
            _tree_where(small_step, small,
                        _tree_where(accept, accepted, rejected)))

        if debug:
            # Human diagnostic stream — the reference's SAY_IF_VERBOSE
            # narration at each solver decision (reference dogleg.c:1182,
            # 611, 900, 1314, 1432, 1456), emitted from inside jit.
            jax.debug.print(
                "libdogleg-tpu: attempt {a}: trustregion {tr:.6} | "
                "cauchy {lc:.6} gn {lg} | step type {st} len {ls:.6} | "
                "expected/observed {e:.6}/{o:.6} rho {r:.6} | "
                "accept {acc} -> trustregion {tr2:.6}",
                a=c.n_attempts, tr=tr, lc=jnp.sqrt(norm2_cauchy),
                lg=jnp.where(have_gn, jnp.sqrt(norm2_gn), jnp.nan),
                st=step_type, ls=jnp.sqrt(norm2_step),
                e=expected, o=observed, r=rho,
                acc=accept & ~small_step, tr2=tr_new)

        if c.history is not None:
            idx = jnp.minimum(c.n_attempts, c.history.iteration.shape[0] - 1)
            inf = jnp.asarray(jnp.inf, dtype)

            # Direction change vs the step into the current point (reference
            # dogleg.c:1271-1284), with the same +-1 clamping.
            cos_dc = _tree_dot(step, c.prev_step) / jnp.sqrt(
                norm2_step * c.norm2_prev_step)
            dc_deg = jnp.where(
                cos_dc >= 1.0, 0.0,
                jnp.where(cos_dc <= -1.0, 180.0,
                          jnp.degrees(jnp.arccos(jnp.clip(cos_dc, -1., 1.)))))
            dc_deg = jnp.where(c.have_prev_step, dc_deg, inf)

            # The reference records the GN length whenever compute_updateGN
            # is *called* (the non-Cauchy path, cached or not;
            # dogleg.c:904-905) and leaves it '-' on Cauchy attempts even
            # when a cached GN step exists.
            len_gn = jnp.where(~use_cauchy, jnp.sqrt(norm2_gn), inf)
            len_interp = jnp.where((~use_cauchy) & (~use_gn),
                                   jnp.sqrt(interp.norm2_step), inf)
            k_c2g = jnp.where((~use_cauchy) & (~use_gn), interp.k, inf)
            rec_rho = jnp.where(small_step, inf, rho)
            rec_after = jnp.where(small_step, inf, trial.norm2_x)
            rec_obs = jnp.where(small_step, inf, observed)
            rec_tr_after = jnp.where(small_step, inf, tr_new)

            def put(buf, val):
                return buf.at[idx].set(jnp.where(c.done, buf[idx],
                                                 jnp.asarray(val, buf.dtype)))
            hist = History(
                iteration=put(c.history.iteration, c.step_count),
                # the small-step termination row is recorded as accepted,
                # matching the reference's emit at dogleg.c:1404-1406
                step_accepted=put(c.history.step_accepted,
                                  (accept | small_step).astype(jnp.int32)),
                norm2x_before=put(c.history.norm2x_before, c.norm2_x),
                norm2x_after=put(c.history.norm2x_after, rec_after),
                step_len_cauchy=put(c.history.step_len_cauchy,
                                    jnp.sqrt(norm2_cauchy)),
                step_len_gauss_newton=put(c.history.step_len_gauss_newton,
                                          len_gn),
                step_len_interpolated=put(c.history.step_len_interpolated,
                                          len_interp),
                k_cauchy_to_gn=put(c.history.k_cauchy_to_gn, k_c2g),
                step_len=put(c.history.step_len, jnp.sqrt(norm2_step)),
                step_type=put(c.history.step_type, step_type),
                step_direction_change_deg=put(
                    c.history.step_direction_change_deg, dc_deg),
                expected_improvement=put(c.history.expected_improvement,
                                         expected),
                observed_improvement=put(c.history.observed_improvement,
                                         rec_obs),
                rho=put(c.history.rho, rec_rho),
                trustregion_before=put(c.history.trustregion_before, tr),
                trustregion_after=put(c.history.trustregion_after,
                                      rec_tr_after),
            )
            out = out._replace(history=hist)

        # Freeze everything once done (vmap-safety: no state changes after
        # an element terminates).
        return _tree_where(c.done, c, out)

    if max_new_attempts is None:
        cond = lambda c: ~c.done
    else:
        limit = state.n_attempts + max_new_attempts
        cond = lambda c: (~c.done) & (c.n_attempts < limit)

    body = attempt
    if wavefront_unroll > 1:
        def body(c, _k=wavefront_unroll):
            for _ in range(_k):
                c = attempt(c)
            return c
    return jax.lax.while_loop(cond, body, state)


def result_from_state(state: "_Carry") -> SolveResult:
    """Package a solver state as a SolveResult (reason is RUNNING if the
    segmented run has not terminated yet)."""
    return SolveResult(
        p=state.p, norm2_x=state.norm2_x, Jt_x=state.Jt_x, JtJ=state.JtJ,
        step_count=state.step_count, n_attempts=state.n_attempts,
        reason=state.reason, trustregion=state.trustregion, lam=state.lam,
        history=state.history)
