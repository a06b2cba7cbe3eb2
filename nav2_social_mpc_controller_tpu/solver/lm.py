"""Batched Levenberg-Marquardt solver with Ceres trust-region semantics.

Batched replacement for the per-tick ``ceres::Solve`` call
(optimizer.cpp:381). One solve is a handful of 2B-variable (B = #parameter
blocks, typically 3 -> 6 vars) damped normal-equation iterations; the
accelerator win is running 10^3..10^5 independent solves per device under
vmap, with the residual/Jacobian work and the tiny factorizations batched
as dense array algebra.

Semantics reproduced from Ceres (for cmd_vel parity within tolerance):
  * LM with diagonal damping: A = J^T J + (1/radius) * clamp(diag(J^T J)),
    clamp to [min_diagonal=1e-6, max_diagonal=1e32]
    (ceres levenberg_marquardt_strategy.cc).
  * Trust-region radius update: on acceptance
    radius /= max(1/3, 1 - (2*rho - 1)^3), decrease_factor reset to 2;
    on rejection radius /= decrease_factor, decrease_factor *= 2
    (ceres trust_region_minimizer).
  * Step acceptance: rho = actual_reduction / model_reduction >
    min_relative_decrease (1e-3).
  * Box bounds by projecting the trial point onto the box and re-using the
    projected delta for the model-cost computation (Ceres' constrained
    trust-region path; bounds set in optimizer.cpp:373-379).
  * Stopping: max_num_iterations; function_tolerance
    |cost - new_cost| <= fn_tol * cost; gradient_tolerance
    max|g| <= gradient_tol; parameter_tolerance
    ||step|| <= param_tol * (||x|| + param_tol)  (ceres solver.h docs;
    tolerances configured in optimizer.cpp:46-51 / initialize :119-121).

The solver is expressed as a ``lax.while_loop``; under ``vmap`` it runs until
every scenario in the batch has converged (batched-while semantics), so a
batch stops early when all lanes are done.
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from nav2_social_mpc_controller_tpu.core.types import SolveStats

# Termination codes
TERM_NO_CONVERGENCE = 0  # hit max_num_iterations (still usable, like Ceres)
TERM_FUNCTION_TOL = 1
TERM_PARAMETER_TOL = 2
TERM_GRADIENT_TOL = 3
TERM_MIN_RADIUS = 4
TERM_NUMERIC_FAILURE = 5  # NaN/inf encountered -> solution unusable


class LMConfig(NamedTuple):
    max_iterations: int = 100
    fn_tol: float = 1e-7
    gradient_tol: float = 1e-10
    param_tol: float = 1e-15
    min_relative_decrease: float = 1e-3
    initial_radius: float = 1e4
    max_radius: float = 1e16
    min_radius: float = 1e-32
    min_diagonal: float = 1e-6
    max_diagonal: float = 1e32
    # Ceres' default Jacobi column scaling (trust_region_minimizer.cc):
    # s_i = 1/(1 + ||J col_i|| at iteration 0), frozen; the LM step is
    # computed on the column-scaled system and mapped back delta = S delta'.
    # With Marquardt damping D = diag(J^T J) this is an exact no-op whenever
    # the [min_diagonal, max_diagonal] clamp does not bind in either space
    # (S^{-1} clamp(S^2 diag) S^{-1} = diag) — measured at the benchmark
    # magnitudes by tools/jacobi_scaling_study.py (JACOBI_SCALING_r05.json),
    # which is why the production default stays False: same trajectories,
    # three fewer per-iteration ops in the while-loop body.
    jacobi_scaling: bool = False


class LMTrace(NamedTuple):
    """Per-iteration solver telemetry, the `debug_optimizer` analogue of
    Ceres' PER_MINIMIZER_ITERATION logging (optimizer.cpp:122-130): one row
    per LM iteration, fixed length = max_iterations (rows beyond the executed
    count stay zero). Enabled via lm_solve(..., trace_len=N) /
    OptimizerConfig.debug_optimizer."""

    cost: jnp.ndarray  # (T,) cost at iteration start
    cost_change: jnp.ndarray  # (T,) actual cost change of the trial step
    grad_max: jnp.ndarray  # (T,) max|J^T r|
    step_norm: jnp.ndarray  # (T,) ||delta|| of the (projected) trial step
    tr_ratio: jnp.ndarray  # (T,) rho = actual/model reduction
    tr_radius: jnp.ndarray  # (T,) trust-region radius at iteration start
    accepted: jnp.ndarray  # (T,) bool — step accepted


class _LMState(NamedTuple):
    u: jnp.ndarray
    cost: jnp.ndarray
    g: jnp.ndarray  # J^T r at u   — the Jacobian itself is never carried:
    jtj: jnp.ndarray  # J^T J at u — only these (D,)/(D,D) reductions are, so
    #                  the while-loop carry (and its per-iteration select
    #                  copies) stays tiny instead of (R, D)-sized
    radius: jnp.ndarray
    decrease_factor: jnp.ndarray
    iters: jnp.ndarray
    done: jnp.ndarray
    term: jnp.ndarray
    failed: jnp.ndarray
    trace: LMTrace | None


def default_linear_solve(a, b):
    """Dense SPD solve of the damped normal equations (Cholesky). Under vmap
    XLA batches the tiny D x D factorizations of every lane."""
    return jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(a), b)


class _IterAux(NamedTuple):
    """Per-iteration intermediates surfaced for the debug trace."""

    rho: jnp.ndarray
    actual_change: jnp.ndarray
    step_norm: jnp.ndarray
    accept: jnp.ndarray
    active: jnp.ndarray


def propose(cfg: LMConfig, u, g, jtj, radius, lower, upper,
            linear_solve=default_linear_solve, jac_scale=None):
    """Trial step of one LM iteration: the damped normal-equation solve
    A delta = -g with A = JtJ + clamp(diag(JtJ)) / radius, projected onto
    the box; the projected delta defines both the candidate and the model
    cost (constrained trust region).

    Returns (u_new, delta, model_change)."""
    if jac_scale is not None:
        # Solve the column-scaled damped system; map the step back.
        jtj_s = jtj * (jac_scale[:, None] * jac_scale[None, :])
        diag = jnp.clip(jnp.diagonal(jtj_s), cfg.min_diagonal, cfg.max_diagonal)
        delta = jac_scale * linear_solve(
            jtj_s + jnp.diag(diag / radius), -(jac_scale * g)
        )
    else:
        diag = jnp.clip(jnp.diagonal(jtj), cfg.min_diagonal, cfg.max_diagonal)
        delta = linear_solve(jtj + jnp.diag(diag / radius), -g)

    u_new = jnp.clip(u + delta, lower, upper)
    delta = u_new - u

    # Same raised precision as the normal-equation formation (value_grad):
    # rho's numerator/denominator decide accept/reject, so a TF32-rounded
    # model_change would diverge from the CPU parity suites. These are
    # (D,)-dot-(D,) contractions — cost is negligible at any precision.
    hi = jax.lax.Precision.HIGHEST
    model_change = -jnp.vdot(delta, g, precision=hi) - 0.5 * jnp.vdot(
        delta, jnp.matmul(jtj, delta, precision=hi), precision=hi
    )
    return u_new, delta, model_change


def commit(cfg: LMConfig, st: "_LMState", u_new, delta, model_change,
           new_cost, g_new, jtj_new):
    """Accept/reject the trial step, update the trust region and run the
    convergence tests (Ceres semantics, see the module docstring). A lane
    with st.done stays frozen (bit-identical carry).

    Returns (new_state, _IterAux); new_state.trace passes through unchanged."""
    dtype = st.u.dtype
    grad_ok = jnp.max(jnp.abs(st.g)) <= cfg.gradient_tol
    actual_change = st.cost - new_cost

    rho = actual_change / model_change
    step_valid = (model_change > 0.0) & jnp.isfinite(new_cost) & jnp.all(jnp.isfinite(delta))
    # Freeze lanes that already converged: under vmap the batched while
    # loop keeps running until every lane is done, and an unguarded body
    # would keep mutating finished lanes — making results depend on batch
    # composition (caught by test_sharded_matches_unsharded).
    active = ~st.done
    accept = active & step_valid & (rho > cfg.min_relative_decrease)

    # Radius update
    shrink = 2.0 * rho - 1.0
    grow = jnp.maximum(1.0 / 3.0, 1.0 - shrink * shrink * shrink)
    radius_acc = jnp.minimum(st.radius / grow, cfg.max_radius)
    radius_rej = st.radius / st.decrease_factor
    radius = jnp.where(active, jnp.where(accept, radius_acc, radius_rej), st.radius)
    decrease_factor = jnp.where(
        active, jnp.where(accept, 2.0, st.decrease_factor * 2.0), st.decrease_factor
    )

    u = jnp.where(accept, u_new, st.u)
    g = jnp.where(accept, g_new, st.g)
    jtj = jnp.where(accept, jtj_new, st.jtj)
    cost = jnp.where(accept, new_cost, st.cost)

    # Convergence tests (accepted steps only, as in Ceres)
    fn_conv = accept & (jnp.abs(actual_change) <= cfg.fn_tol * st.cost)
    step_norm = jnp.linalg.norm(delta)
    param_conv = accept & (step_norm <= cfg.param_tol * (jnp.linalg.norm(st.u) + cfg.param_tol))
    radius_dead = active & (radius < cfg.min_radius)
    numeric_failed = active & (~jnp.isfinite(cost) | jnp.any(~jnp.isfinite(u)))
    grad_ok = active & grad_ok

    term = jnp.where(
        numeric_failed,
        TERM_NUMERIC_FAILURE,
        jnp.where(
            grad_ok,
            TERM_GRADIENT_TOL,
            jnp.where(
                fn_conv,
                TERM_FUNCTION_TOL,
                jnp.where(
                    param_conv,
                    TERM_PARAMETER_TOL,
                    jnp.where(radius_dead, TERM_MIN_RADIUS, TERM_NO_CONVERGENCE),
                ),
            ),
        ),
    ).astype(jnp.int32)
    newly_done = numeric_failed | grad_ok | fn_conv | param_conv | radius_dead

    st_new = _LMState(
        u=u,
        cost=cost,
        g=g,
        jtj=jtj,
        radius=radius.astype(dtype),
        decrease_factor=decrease_factor.astype(dtype),
        iters=st.iters + active.astype(jnp.int32),
        done=st.done | newly_done,
        term=jnp.where(st.done, st.term, term),
        failed=st.failed | numeric_failed,
        trace=st.trace,
    )
    return st_new, _IterAux(
        rho=rho, actual_change=actual_change, step_norm=step_norm,
        accept=accept, active=active,
    )


def lm_iteration(value_grad, lower, upper, cfg: LMConfig, linear_solve,
                 jac_scale, st: "_LMState"):
    """ONE per-lane LM trust-region iteration — propose, evaluate, commit:
    the exact body of lm_solve's while-loop, factored out so the compacted
    batched solver (solver/batched.py) can run the IDENTICAL per-lane math
    under an explicit batch axis. A lane with st.done stays frozen
    (bit-identical carry), which is what makes gather/compact/scatter safe.

    Returns (new_state, _IterAux); new_state.trace passes through unchanged
    (lm_solve layers the debug trace on top)."""
    u_new, delta, model_change = propose(
        cfg, st.u, st.g, st.jtj, st.radius, lower, upper, linear_solve, jac_scale
    )
    new_cost, g_new, jtj_new = value_grad(u_new)
    return commit(cfg, st, u_new, delta, model_change, new_cost, g_new, jtj_new)


def make_value_grad(residual_fn: Callable, d: int):
    """value_grad(u) -> (cost, g = J^T r, JtJ = J^T J) via jax.linearize:
    one primal pass + one d-wide linear tangent pass, reduced immediately so
    the full (R, d) Jacobian is never carried in the solver loop. This is
    the REFERENCE implementation; ops/fused_iter.py provides a semantically
    identical analytic path for batched GPU execution."""

    def value_grad(u):
        y, f_lin = jax.linearize(residual_fn, u)
        j_rows = jax.vmap(f_lin)(jnp.eye(d, dtype=u.dtype))  # (d, R)
        cost = 0.5 * jnp.sum(y * y)
        # HIGHEST on the normal-equation contractions at every width: at
        # DEFAULT an f32 matmul may run in TF32 on the GPU (~3 decimal
        # digits), which would form the trust-region system far less
        # precisely than the CPU parity suites do.
        hi = jax.lax.Precision.HIGHEST
        g = jnp.matmul(j_rows, y, precision=hi)
        jtj = jnp.matmul(j_rows, j_rows.T, precision=hi)
        return cost, g, jtj

    return value_grad


def lm_solve(
    residual_fn: Callable[[jnp.ndarray], jnp.ndarray],
    u0: jnp.ndarray,
    lower: jnp.ndarray,
    upper: jnp.ndarray,
    cfg: LMConfig,
    linear_solve: Callable = default_linear_solve,
    trace_len: int = 0,
    value_grad_fn: Callable = None,
):
    """Minimize 0.5 * ||residual_fn(u)||^2 subject to lower <= u <= upper.

    u0/lower/upper: flat (D,) decision vectors. residual_fn: (D,) -> (R,).
    Returns (u_opt (D,), SolveStats), plus an LMTrace of length `trace_len`
    when trace_len > 0 (the debug_optimizer path — costs one buffer write
    per iteration, so it is off on the bench path). Jittable; vmap for
    batches.

    No max_solver_time analogue: Ceres' wall-clock cap
    (max_solver_time_in_seconds = max_time, optimizer.cpp:131) is a
    deliberate non-port — at the benchmark settings it could only bind after
    1.5 s, far beyond a 50 ms control tick, and a traced while_loop cannot
    read a wall clock. max_num_iterations is the only
    binding cap, exactly as in the reference's benchmark runs.
    """
    dtype = u0.dtype
    d = u0.shape[0]

    value_grad = value_grad_fn if value_grad_fn is not None else make_value_grad(residual_fn, d)

    initial_cost, g0, jtj0 = value_grad(u0)

    # Jacobi scale frozen at iteration 0, as Ceres does: ||J col_i||^2 at u0
    # is diag(J^T J at u0).
    jac_scale = (
        1.0 / (1.0 + jnp.sqrt(jnp.maximum(jnp.diagonal(jtj0), 0.0)))
        if cfg.jacobi_scaling
        else None
    )

    def body(st: _LMState) -> _LMState:
        st_new, aux = lm_iteration(
            value_grad, lower, upper, cfg, linear_solve, jac_scale, st
        )

        trace = st.trace
        if trace is not None:
            at = jnp.clip(st.iters, 0, trace_len - 1)
            active = aux.active

            def put(buf, v):
                return buf.at[at].set(jnp.where(active, v.astype(buf.dtype), buf[at]))

            trace = LMTrace(
                cost=put(trace.cost, st.cost),
                cost_change=put(trace.cost_change, aux.actual_change),
                grad_max=put(trace.grad_max, jnp.max(jnp.abs(st.g))),
                step_norm=put(trace.step_norm, aux.step_norm),
                tr_ratio=put(trace.tr_ratio, aux.rho),
                tr_radius=put(trace.tr_radius, st.radius),
                accepted=trace.accepted.at[at].set(
                    jnp.where(active, aux.accept, trace.accepted[at])
                ),
            )
        return st_new._replace(trace=trace)

    def cond(st: _LMState):
        return (~st.done) & (st.iters < cfg.max_iterations)

    trace0 = None
    if trace_len > 0:
        z = jnp.zeros((trace_len,), dtype)
        trace0 = LMTrace(
            cost=z, cost_change=z, grad_max=z, step_norm=z, tr_ratio=z,
            tr_radius=z, accepted=jnp.zeros((trace_len,), bool),
        )

    st0 = _LMState(
        u=u0,
        cost=initial_cost,
        g=g0,
        jtj=jtj0,
        radius=jnp.asarray(cfg.initial_radius, dtype),
        decrease_factor=jnp.asarray(2.0, dtype),
        iters=jnp.zeros((), jnp.int32),
        done=~jnp.isfinite(initial_cost),
        term=jnp.full((), TERM_NO_CONVERGENCE, jnp.int32),
        failed=~jnp.isfinite(initial_cost),
        trace=trace0,
    )
    st = jax.lax.while_loop(cond, body, st0)

    stats = SolveStats(
        iterations=st.iters,
        initial_cost=initial_cost,
        final_cost=st.cost,
        termination=st.term,
        usable=~st.failed,
    )
    if trace_len > 0:
        return st.u, stats, st.trace
    return st.u, stats
