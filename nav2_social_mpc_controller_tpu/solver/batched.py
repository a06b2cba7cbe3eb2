"""Converged-lane compaction for the batched LM solve (VERDICT r3 item 4).

The plain batched solver is vmap(lm_solve): a batched while-loop that runs
every lane until the SLOWEST lane converges, so a warm-started batch whose
mean iteration count is ~13 still pays E[max] ~ 40 full-width iterations
(iteration counts from the CPU warm-start study, tools/warm_start_study.py).

Two-phase scheme, all in-graph:

  phase 1  run FULL-width batched iterations until the number of active
           (not-done) lanes fits a static capacity C — the while condition
           itself is the trigger, no fixed iteration count;
  compact  stable-argsort the done mask, gather the active lanes AND their
           problem data (value-grad operands, bounds) into a C-wide batch;
  phase 2  run the compacted batch to completion at ~C/B of the per-
           iteration cost;
  scatter  write the compacted lanes back by the same permutation.

Per-lane math is IDENTICAL to lm_solve: both run solver.lm.lm_iteration,
and a done lane is frozen bit-exactly, so gather/compact/scatter cannot
change any lane's trajectory (pinned by
tests/test_compaction.py::test_compacted_matches_plain_solver_exactly).

No reference counterpart — Ceres solves ONE problem; this is the
framework's own batching economics.

Round 5 makes the scheme MULTI-LEVEL (VERDICT r4 item 5): instead of one
full-width phase gated on a single static capacity, the solver descends a
geometric ladder of widths (B/2, B/4, ... down to the requested capacity),
compacting at EVERY level whose trigger fires. This removes the capacity
cliff: with a single level, a capacity below the workload's cap-bound lane
fraction meant the trigger never fired and the solver degenerated to the
plain path plus overhead. With the ladder, the B/2 level triggers as soon
as half the batch is done regardless of where the final capacity sits, so
every prefix of the ladder that can pay does pay, and the worst case is
the plain solver plus O(log B) gather/scatters and a per-iteration
popcount.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nav2_social_mpc_controller_tpu.core.types import SolveStats
from nav2_social_mpc_controller_tpu.solver.lm import (
    LMConfig,
    TERM_NO_CONVERGENCE,
    _LMState,
    default_linear_solve,
    lm_iteration,
)


def lm_solve_batch_compacted(
    value_grad_op,
    data,
    u0,
    lower,
    upper,
    cfg: LMConfig,
    capacity: int,
    linear_solve=default_linear_solve,
):
    """Batched box-constrained LM with converged-lane compaction.

    value_grad_op: per-lane op (u, *data_lane) -> (cost, g, jtj) — e.g.
    ops.fused_iter.make_value_grad_op (whose custom_vmap rule dispatches
    the analytic f32 path under this function's internal vmaps).
    data: tuple of arrays with leading batch axis B.
    u0/lower/upper: (B, D). capacity: static compacted width (< B).

    Returns (u (B, D), SolveStats with (B,) leaves).
    """
    b, d = u0.shape
    if not 0 < capacity < b:
        raise ValueError(f"capacity must be in (0, {b}), got {capacity}")
    if cfg.jacobi_scaling:
        # Measured an exact no-op at benchmark magnitudes
        # (tools/jacobi_scaling_study.py); keeping the compacted phases
        # scale-free avoids carrying the frozen per-lane scale across the
        # gather/scatter.
        raise NotImplementedError("compaction requires jacobi_scaling=False")
    dtype = u0.dtype

    def init_lane(u0_l, *d_l):
        cost, g, jtj = value_grad_op(u0_l, *d_l)
        return _LMState(
            u=u0_l,
            cost=cost,
            g=g,
            jtj=jtj,
            radius=jnp.asarray(cfg.initial_radius, dtype),
            decrease_factor=jnp.asarray(2.0, dtype),
            iters=jnp.zeros((), jnp.int32),
            done=~jnp.isfinite(cost),
            term=jnp.full((), TERM_NO_CONVERGENCE, jnp.int32),
            failed=~jnp.isfinite(cost),
            trace=None,
        )

    st = jax.vmap(init_lane)(u0, *data)
    initial_cost = st.cost

    def body_lane(st_l, lo_l, hi_l, *d_l):
        st2, _aux = lm_iteration(
            lambda u: value_grad_op(u, *d_l), lo_l, hi_l, cfg, linear_solve,
            None, st_l,
        )
        return st2

    vbody = jax.vmap(body_lane)

    def active_mask(s):
        return (~s.done) & (s.iters < cfg.max_iterations)

    # Width ladder: geometric halves of B down to the requested capacity
    # (inclusive). Each level runs while the active set exceeds the NEXT
    # width, then compacts into it. Terminates: every iteration increments
    # iters on active lanes, and active implies iters < max_iterations.
    levels = []
    width = b // 2
    while width > capacity:
        levels.append(width)
        width = width // 2
    levels.append(capacity)

    st_full = st
    idx = jnp.arange(b)  # current-level lane -> original lane
    st_c, lo_c, hi_c, data_c = st, lower, upper, data

    for cap in levels:
        def cond(s, _cap=cap):
            a = active_mask(s)
            return jnp.any(a) & (jnp.sum(a) > _cap)

        st_c = jax.lax.while_loop(
            cond, lambda s, _l=lo_c, _h=hi_c, _d=data_c: vbody(s, _l, _h, *_d), st_c
        )
        # Scatter this level's state back, then compact: a stable sort puts
        # the (<= cap) active lanes first in original order; the tail beyond
        # `cap` is all done/capped (indices unique by construction).
        st_full = jax.tree.map(lambda full, comp: full.at[idx].set(comp), st_full, st_c)
        perm = jnp.argsort(~active_mask(st_c), stable=True)  # active sorts first
        take = perm[:cap]
        idx = idx[take]
        st_c = jax.tree.map(lambda x: x[take], st_c)
        lo_c = lo_c[take]
        hi_c = hi_c[take]
        data_c = tuple(x[take] for x in data_c)

    def cond_final(s):
        return jnp.any(active_mask(s))

    st_c = jax.lax.while_loop(
        cond_final, lambda s: vbody(s, lo_c, hi_c, *data_c), st_c
    )
    st = jax.tree.map(lambda full, comp: full.at[idx].set(comp), st_full, st_c)

    stats = SolveStats(
        iterations=st.iters,
        initial_cost=initial_cost,
        final_cost=st.cost,
        termination=st.term,
        usable=~st.failed,
    )
    return st.u, stats
