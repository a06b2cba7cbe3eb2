"""Analytic LM value-and-gradient: residual + Jacobian -> (cost, g, JtJ)
without an autodiff replay.

Each LM iteration needs cost = 0.5 |r|^2, g = J^T r and JtJ = J^T J. The
reference path (``_ref_value_grad``) gets them from ``jax.linearize`` plus a
D-wide tangent replay through every critic. This module computes the same
three quantities analytically for the benchmark critic set:

  1. rollout + analytic sensitivities as TWO stacked cumsums (the unicycle
     prefix-sum rollout is linear in the per-step integrands, so
     d(poses)/du is itself a pair of cumsums — models/motion.py);
  2. the bicubic costmap value + row/col derivatives at the rollout front
     points (world/grid.bicubic_linearize);
  3. every remaining critic's residual AND per-step gradient
     (costs/critic_grads.py), chain-contracted against the sensitivities
     into J, then contracted into cost, g and JtJ.

Step 3 is plain jnp on (S, B) arrays, which XLA fuses: each critic's rows
of J are formed from its per-step gradients and the rollout sensitivities
(``analytic_residual_jacobian``), and cost, g and JtJ are two contractions
(``normal_equations``). (A
Pallas Triton kernel that kept all 1 + D + D(D+1)/2 accumulators on chip was
measured slower end to end on an H100 and removed; PERF.md.)

Residual semantics are IDENTICAL to controller.optimize.build_residual_fn
(same masks, same ordering quirks); equivalence is pinned by
tests/test_fused_iter.py against the linearize path. The analytic path
engages for batched f32 execution on every backend, via custom_vmap:
single-lane calls and f64 keep the reference linearize path, so the f64
parity suites still pin the code that produced the golden values.

Reference math: the residual set of the reference's src/optimizer.cpp:251-371
(per-critic citations in costs/critics.py).
"""

import functools

import jax
import jax.numpy as jnp

from nav2_social_mpc_controller_tpu.costs import critic_grads as cg
from nav2_social_mpc_controller_tpu.costs import critics
from nav2_social_mpc_controller_tpu.utils.angles import wrap_atan2

# Accuracy contract of the f32 analytic path: max|d| / max|ref| of each of
# cost, g and JtJ against the linearize reference run in f64 on the same
# f32 inputs. Measured at 2e-7..4.3e-7 on the CPU (social, omni6,
# stress36; PERF.md); a TF32 contraction or an off-by-one sensitivity lands
# orders of magnitude above it (tests/test_fused_iter.py).
F32_REL_TOL = 1e-5


def can_fuse(cfg) -> bool:
    """The analytic path covers exactly the benchmark critic set; the latent
    critics (AngleCost / CurvatureCost — compiled but never instantiated by
    the reference, SURVEY.md section 2.2) keep the reference linearize path."""
    w = cfg.optimizer.weights
    return w.pure_angle_weight == 0.0 and w.curvature_weight == 0.0


def agent_angle_precompute(pose0, agents_steps):
    """The u-INDEPENDENT head of the agent-angle critic
    (critics._agent_angle_impl): closest-moving-agent selection, branch
    resolution and steering target depend only on the projected agents and
    pose_0, so they are computed ONCE per solve instead of per iteration.

    pose0: (3,); agents_steps: (S, N, 6).
    Returns (steer (S,), active (S,) bool) such that the critic residual is
    active * w * wrap(new_yaw - steer)^2.
    """
    x0, y0, yaw0 = pose0[0], pose0[1], pose0[2]
    moving = agents_steps[..., 4] > critics.AGENT_ANGLE_MIN_SPEED
    dx = agents_steps[..., 0] - x0
    dy = agents_steps[..., 1] - y0
    dist_sq = dx * dx + dy * dy
    masked = jnp.where(moving, dist_sq, jnp.inf)
    ci = jnp.argmin(masked, axis=-1)
    closest_sq = jnp.min(masked, axis=-1)
    has_agent = jnp.isfinite(closest_sq) & (closest_sq <= critics.AGENT_ANGLE_SAFE_DIST_SQ)

    onehot = ci[:, None] == jnp.arange(agents_steps.shape[-2])
    ag = jnp.sum(jnp.where(onehot[..., None], agents_steps, 0.0), axis=-2)
    agent_angle_initial = jnp.arctan2(ag[:, 1] - y0, ag[:, 0] - x0)
    heading_diff = wrap_atan2(ag[:, 2] - yaw0)
    side = wrap_atan2(agent_angle_initial - yaw0)

    opposing = (heading_diff <= -critics.AGENT_ANGLE_UPPER_THRESHOLD) | (
        heading_diff >= critics.AGENT_ANGLE_THRESHOLD
    )
    active = has_agent & jnp.where(opposing, side >= 0.0, side <= 0.0)
    steer = jnp.where(
        opposing,
        yaw0 - critics.AGENT_ANGLE_THRESHOLD,
        yaw0 + critics.AGENT_ANGLE_THRESHOLD,
    )
    return steer, active


def rollout_with_sensitivities(u, pose0, dt, block_idx, n_blocks):
    """Unicycle prefix-sum rollout AND its analytic Jacobian wrt u.

    theta is linear in the controls and each position step reads theta from
    before its own update (models/motion.rollout_poses), so both the
    rollout and d(rollout)/du are prefix sums:

      theta_s        = theta0 + dt * cum(w)
      dtheta_s/dw_b  = dt * cum(E_b)
      x_s            = x0 + dt * cum(v * cos(theta_prev))
      dx_s/dv_b      = dt * cum(E_b * cos(theta_prev))
      dx_s/dw_b      = dt * cum(v * -sin(theta_prev) * dtheta_prev/dw_b)

    with E_b[s] = [block_idx[s] == b]. Two stacked cumsum ops produce all
    of it (the theta-round feeds the position-round).

    u: (B, 2); block_idx: (S,) int32. Returns
      poses   (S+1, 3),
      vw      (S, 2)            — expanded per-step controls,
      tx, ty  (S, D)            — d new_pos / du (D = 2B, u-major layout
                                  [v0, w0, v1, w1, ...]),
      tth     (S, D)            — d new_yaw / du,
      eb      (S, B) f32        — the block one-hot masks (v/w selector).
    """
    s = block_idx.shape[0]
    dtype = u.dtype
    eb = (block_idx[:, None] == jnp.arange(n_blocks)[None, :]).astype(dtype)  # (S, B)
    # where/sum one-hot expansion (exact copy — see models.motion.expand_blocks)
    v_seq = jnp.sum(jnp.where(eb > 0, u[None, :, 0], 0.0), axis=1)
    w_seq = jnp.sum(jnp.where(eb > 0, u[None, :, 1], 0.0), axis=1)

    # Round 1: theta and its w-sensitivities.
    r1 = jnp.concatenate([w_seq[:, None], eb], axis=1)  # (S, 1+B)
    c1 = dt * jnp.cumsum(r1, axis=0)
    th = pose0[2] + c1[:, 0]
    dth = c1[:, 1:]  # (S, B): d theta_s / d w_b
    th_prev = jnp.concatenate([jnp.broadcast_to(pose0[2], (1,)), th[:-1]])
    dth_prev = jnp.concatenate([jnp.zeros((1, n_blocks), dtype), dth[:-1]], axis=0)

    cosp = jnp.cos(th_prev)
    sinp = jnp.sin(th_prev)
    # Round 2: positions and their sensitivities.
    r2 = jnp.concatenate(
        [
            (v_seq * cosp)[:, None],                     # x integrand
            (v_seq * sinp)[:, None],                     # y integrand
            eb * cosp[:, None],                          # dx/dv_b
            eb * sinp[:, None],                          # dy/dv_b
            (-v_seq * sinp)[:, None] * dth_prev,         # dx/dw_b
            (v_seq * cosp)[:, None] * dth_prev,          # dy/dw_b
        ],
        axis=1,
    )  # (S, 2 + 4B)
    c2 = dt * jnp.cumsum(r2, axis=0)
    x = pose0[0] + c2[:, 0]
    y = pose0[1] + c2[:, 1]
    b = n_blocks
    dx_dv = c2[:, 2 : 2 + b]
    dy_dv = c2[:, 2 + b : 2 + 2 * b]
    dx_dw = c2[:, 2 + 2 * b : 2 + 3 * b]
    dy_dw = c2[:, 2 + 3 * b : 2 + 4 * b]

    poses = jnp.concatenate(
        [pose0[None, :], jnp.stack([x, y, th], axis=-1)], axis=0
    )  # (S+1, 3)
    vw = jnp.stack([v_seq, w_seq], axis=-1)

    # Interleave to u-major D = 2B columns [v0, w0, v1, w1, ...].
    tx = jnp.stack([dx_dv, dx_dw], axis=-1).reshape(s, 2 * b)
    ty = jnp.stack([dy_dv, dy_dw], axis=-1).reshape(s, 2 * b)
    zth = jnp.zeros_like(dth)
    tth = jnp.stack([zth, dth], axis=-1).reshape(s, 2 * b)
    return poses, vw, tx, ty, tth, eb


# ---------------------------------------------------------------------------
# The critic body and the normal-equation contraction.
#
# Layout: the rollout step axis leads (S rows), batch lanes trail (B). All
# critic math is elementwise over (S, B) arrays; each critic's per-step
# gradient is chain-contracted against the rollout sensitivities into its
# rows of J (D, R, B), and cost, g and JtJ come from two batched
# contractions over the residual axis R.
# ---------------------------------------------------------------------------


def normal_equations(r, jac):
    """(cost, g, JtJ) of residuals r (R, B) and their Jacobian jac (D, R, B)."""
    # HIGHEST: a DEFAULT f32 contraction may run in TF32 on the GPU.
    hi = jax.lax.Precision.HIGHEST
    cost = 0.5 * jnp.sum(r * r, axis=0)
    g = jnp.einsum("drb,rb->bd", jac, r, precision=hi)
    jtj = jnp.einsum("drb,erb->bde", jac, jac, precision=hi)
    return cost, g, jtj


def analytic_residual_jacobian(statics, ops):
    """(r (R, B), jac (D, R, B)): every residual row and its row of J.

    ops (see _fused_prep): per-step (S, B) arrays px, py, pth, v, val, drow,
    dcol, m_step, m_vel, m_social, active, steer, refx, refy; per-block
    (NB, S, B) sensitivities dxdv, dydv, dxdw, dydw, dth, eb; agents
    (N*6, S, B); u (D, B); scal (4, B) = [final_x, final_y, goal_yaw,
    inv_res]; vfm (max(n_vf, 1), B) velocity-feasibility pair masks."""
    d, n_blocks, n_vf, n_agents, w, desired_vel, front_offset = statics

    px, py, pth, v = ops["px"], ops["py"], ops["pth"], ops["v"]
    m_step = ops["m_step"] > 0.0
    m_vel = ops["m_vel"] > 0.0
    m_social = ops["m_social"] > 0.0
    active = ops["active"] > 0.0

    ag = ops["agents"]
    agents = [
        (ag[k * 6 + 0], ag[k * 6 + 1], ag[k * 6 + 2], ag[k * 6 + 4], ag[k * 6 + 3] != -1.0)
        for k in range(n_agents)
    ]

    # J column pieces per decision var: d = 2b -> (dxdv_b, dydv_b, None,
    # eb_b); d = 2b+1 -> (dxdw_b, dydw_b, dth_b, None).
    tx, ty, tth, ev = [], [], [], []
    for b in range(n_blocks):
        tx += [ops["dxdv"][b], ops["dxdw"][b]]
        ty += [ops["dydv"][b], ops["dydw"][b]]
        tth += [None, ops["dth"][b]]
        ev += [ops["eb"][b], None]

    rows_r, rows_j = [], []  # residual rows (K, B) and their J rows (D, K, B)

    def add(r, grads, mask):
        gx, gy, gth, gv, _gw = grads
        if mask is not None:
            z = jnp.zeros_like(r)
            r = jnp.where(mask, r, z)
            gx = None if gx is None else jnp.where(mask, gx, z)
            gy = None if gy is None else jnp.where(mask, gy, z)
            gth = None if gth is None else jnp.where(mask, gth, z)
            gv = None if gv is None else jnp.where(mask, gv, z)
        cols = []
        for dd in range(d):
            jd = jnp.zeros_like(r)
            for gc, t in ((gx, tx[dd]), (gy, ty[dd]), (gth, tth[dd]), (gv, ev[dd])):
                if gc is not None and t is not None:
                    jd = jd + gc * t
            cols.append(jd)
        rows_r.append(r)
        rows_j.append(jnp.stack(cols))

    # Residual order mirrors controller.optimize.build_residual_fn.
    add(*cg.social_work_grad(w.social_weight, px, py, pth, v, agents), m_social)
    # active is prefolded with the social mask, m_vel with the step mask.
    add(*cg.agent_angle_grad(w.agent_angle_weight, pth, ops["steer"], active), None)
    add(*cg.proxemics_grad(w.proxemics_weight, px, py, agents), m_social)
    add(*cg.velocity_grad(w.velocity_weight, desired_vel, v, m_vel), None)
    fx, fy, goal_yaw, inv_res = (ops["scal"][i : i + 1] for i in range(4))
    add(*cg.goal_align_grad(w.goal_align_weight, goal_yaw, pth), m_step)
    add(*cg.distance_grad(w.distance_weight, px, py, fx, fy), m_step)
    add(*cg.distance_grad(w.angle_weight, px, py, ops["refx"], ops["refy"]), m_step)
    add(
        *cg.obstacle_grad(
            w.obstacle_weight, ops["val"], ops["drow"], ops["dcol"], pth, inv_res,
            front_offset,
        ),
        m_step,
    )

    # Velocity-feasibility rows between consecutive blocks: residuals and
    # Jacobian live directly in u-space (critics.velocity_feasibility_cost).
    wvf = w.velocity_feasibility_weight
    u = ops["u"]
    for q in range(n_vf):
        dv = u[2 * q + 2] - u[2 * q]
        dw = u[2 * q + 3] - u[2 * q + 1]
        mask = ops["vfm"][q] > 0.0
        z = jnp.zeros_like(dv)
        cols = [z] * d
        cols[2 * q] = -2.0 * wvf * dv
        cols[2 * q + 1] = -2.0 * wvf * dw
        cols[2 * q + 2] = 2.0 * wvf * dv
        cols[2 * q + 3] = 2.0 * wvf * dw
        rows_r.append(jnp.where(mask, wvf * (dv * dv + dw * dw), z)[None])
        rows_j.append(jnp.stack([jnp.where(mask, c, z) for c in cols])[:, None])

    r = jnp.concatenate(rows_r, axis=0)  # (R, B)
    jac = jnp.concatenate(rows_j, axis=1)  # (D, R, B)
    return r, jac


# ---------------------------------------------------------------------------
# Batched orchestration + custom_vmap dispatch.
# ---------------------------------------------------------------------------


def _ref_value_grad(cfg, dims, u, rows, n_rows, proj, present, cmd, cmo, cmr):
    """Reference implementation: jax.linearize over the production residual
    closure — EXACTLY the path the f64 parity suites pin (single-lane and
    f64 calls land here)."""
    from nav2_social_mpc_controller_tpu.controller.optimize import build_residual_fn
    from nav2_social_mpc_controller_tpu.core.types import Costmap
    from nav2_social_mpc_controller_tpu.solver.lm import make_value_grad

    rfn = build_residual_fn(
        cfg, dims, rows, n_rows, proj, present,
        Costmap(data=cmd, origin=cmo, resolution=cmr),
    )
    return make_value_grad(rfn, u.shape[0])(u)


def _fused_prep(cfg, dims, u, rows, n_rows, proj, present, cmd, cmo, cmr):
    """Batched (B, ...) operands of the critic body in (S, B) layout.

    The u-independent pieces (masks, agents, targets, the window crop) are
    loop-invariant and XLA hoists them out of the LM while-loop; the rollout,
    its sensitivities and the bicubic samples run per iteration."""
    from nav2_social_mpc_controller_tpu.core.validate import check_obstacle_window
    from nav2_social_mpc_controller_tpu.world.grid import (
        bicubic_linearize,
        crop_grid_window,
    )

    opt = cfg.optimizer
    w = opt.weights
    dt = cfg.trajectorizer.time_step
    b = u.shape[0]
    s = dims.s
    nb = dims.n_blocks
    d = 2 * nb
    n = proj.shape[2]
    dtype = u.dtype

    pose0 = rows[:, 0, 0:3]
    n_vel = (n_rows - 1).astype(jnp.int32)
    h_dyn = jnp.maximum(jnp.minimum(dims.horizon, n_vel), 1)
    bl_dyn = jnp.maximum(jnp.minimum(dims.block_length, h_dyn), 1)
    j = jnp.arange(s, dtype=jnp.int32)
    block_idx = jnp.minimum(j[None, :], h_dyn[:, None] - 1) // bl_dyn[:, None]
    step_mask = j[None, :] < n_vel[:, None]
    in_horizon = j[None, :] < h_dyn[:, None]
    social_mask = step_mask & present[:, None]
    m_vel = in_horizon & step_mask

    last = jnp.clip(n_rows - 1, 0, dims.maxsize - 1)
    last_row = jax.vmap(lambda r, l: r[l])(rows, last)  # (B, 6)

    agents_steps = proj[:, 1:]  # (B, S, N, 6)
    agents_t = jnp.transpose(agents_steps, (2, 3, 1, 0)).reshape(n * 6, s, b)
    steer, active = jax.vmap(agent_angle_precompute)(pose0, agents_steps)
    active_eff = (active & social_mask).T.astype(dtype)

    # Obstacle-window crop (same sizing/fallback contract as the reference
    # path — build_residual_fn). Resolutions are traced here, so the
    # opportunistic host check is a no-op; host boundaries run the hard one.
    if check_obstacle_window(cfg, cmr):
        win, win_origin = jax.vmap(
            lambda dd, oo, rr, c: crop_grid_window(
                dd, oo, rr, c, opt.obstacle_window_cells
            )
        )(cmd, cmo, cmr, rows[:, 0, 0:2])
    else:
        win, win_origin = cmd, cmo

    # ---- (S, B)-major prep. Everything above is u-INDEPENDENT (XLA hoists
    # it out of the LM while-loop); from here the work runs per iteration.
    eb_t = jnp.transpose(
        (block_idx[:, :, None] == jnp.arange(nb)[None, None, :]), (2, 1, 0)
    ).astype(dtype)  # (NB, S, B) — u-independent, hoisted

    # Rollout + sensitivities in transposed layout; the cumsums run along
    # the middle axis of (K, S, B) stacks, so no per-iteration transposes
    # exist anywhere (rollout_with_sensitivities documents the math).
    u_blocks = u.reshape(b, nb, 2)
    uv = jnp.transpose(u_blocks[:, :, 0])  # (NB, B)
    uw = jnp.transpose(u_blocks[:, :, 1])
    v_t = jnp.sum(jnp.where(eb_t > 0, uv[:, None, :], 0.0), axis=0)  # (S, B)
    w_t = jnp.sum(jnp.where(eb_t > 0, uw[:, None, :], 0.0), axis=0)

    th0 = pose0[:, 2][None, :]  # (1, B)
    r1 = jnp.concatenate([w_t[None], eb_t], axis=0)  # (1+NB, S, B)
    c1 = dt * jnp.cumsum(r1, axis=1)
    th = th0 + c1[0]  # (S, B)
    dth = c1[1:]  # (NB, S, B)
    th_prev = jnp.concatenate([jnp.broadcast_to(th0, (1, b)), th[:-1]], axis=0)
    dth_prev = jnp.concatenate([jnp.zeros((nb, 1, b), dtype), dth[:, :-1]], axis=1)

    cosp = jnp.cos(th_prev)
    sinp = jnp.sin(th_prev)
    r2 = jnp.concatenate(
        [
            (v_t * cosp)[None],
            (v_t * sinp)[None],
            eb_t * cosp[None],
            eb_t * sinp[None],
            (-v_t * sinp)[None] * dth_prev,
            (v_t * cosp)[None] * dth_prev,
        ],
        axis=0,
    )  # (2 + 4NB, S, B)
    c2 = dt * jnp.cumsum(r2, axis=1)
    px = pose0[:, 0][None, :] + c2[0]
    py = pose0[:, 1][None, :] + c2[1]

    fxp = px + critics.FRONT_OFFSET * jnp.cos(th)
    fyp = py + critics.FRONT_OFFSET * jnp.sin(th)
    col = (fxp - win_origin[:, 0][None, :]) / cmr[None, :]
    row = (fyp - win_origin[:, 1][None, :]) / cmr[None, :]
    # Bicubic value + derivatives at the rollout front points.
    val, drow, dcol = jax.vmap(bicubic_linearize)(win, row.T, col.T)

    inv_res = 1.0 / cmr
    scal = jnp.stack([last_row[:, 0], last_row[:, 1], last_row[:, 2], inv_res])

    vf_step = jnp.arange(max(dims.n_vf, 1), dtype=jnp.int32) + 1
    vfm = (vf_step[:, None] < (h_dyn // bl_dyn)[None, :]) & (
        vf_step[:, None] < n_vel[None, :]
    )

    ops = {
        "u": u.T,
        "px": px, "py": py, "pth": th, "v": v_t,
        "dxdv": c2[2 : 2 + nb],
        "dydv": c2[2 + nb : 2 + 2 * nb],
        "dxdw": c2[2 + 2 * nb : 2 + 3 * nb],
        "dydw": c2[2 + 3 * nb : 2 + 4 * nb],
        "dth": dth, "eb": eb_t,
        "val": val.T, "drow": drow.T, "dcol": dcol.T,
        "agents": agents_t,
        "m_step": step_mask.T.astype(dtype),
        "m_vel": m_vel.T.astype(dtype),
        "m_social": social_mask.T.astype(dtype),
        "active": active_eff,
        "steer": steer.T,
        "refx": rows[:, 1:, 0].T,
        "refy": rows[:, 1:, 1].T,
        "scal": scal,
        "vfm": vfm.astype(dtype),
    }
    statics = (d, nb, dims.n_vf, n, w, opt.desired_linear_vel, critics.FRONT_OFFSET)
    return statics, ops


def fused_batched(cfg, dims, *args):
    """Batched analytic (cost, g, jtj) for u (B, D) and its data operands."""
    return normal_equations(*analytic_residual_jacobian(*_fused_prep(cfg, dims, *args)))


def _fused_dispatch_ok(cfg, u) -> bool:
    """Whether the batched analytic path serves this (cfg, u): batched f32
    AND can_fuse(cfg). The check lives in the custom_vmap rule, so a config
    the analytic body cannot represent takes the linearize path whoever
    built the op (make_step_batch_compacted included)."""
    return u.dtype == jnp.float32 and u.ndim == 2 and can_fuse(cfg)


def make_value_grad_op(cfg, dims):
    """The custom_vmap value-grad op: op(u, rows, n_rows, proj, present,
    cm_data, cm_origin, cm_res) -> (cost, g, jtj). Unbatched (and f64
    batched) execution is EXACTLY the reference linearize path over
    build_residual_fn; batched f32 execution takes the analytic pipeline. Exposed with explicit data operands so the compacted batched
    solver (solver/batched.py) can gather/scatter the data alongside the
    solver state."""

    @jax.custom_batching.custom_vmap
    def op(u, rows, n_rows, proj, present, cmd, cmo, cmr):
        return _ref_value_grad(cfg, dims, u, rows, n_rows, proj, present, cmd, cmo, cmr)

    @op.def_vmap
    def _rule(axis_size, in_batched, *args):
        out_batched = (True, True, True)
        args = [
            a if bt else jnp.broadcast_to(jnp.asarray(a), (axis_size,) + jnp.shape(a))
            for a, bt in zip(args, in_batched)
        ]
        u = args[0]
        if _fused_dispatch_ok(cfg, u):
            return fused_batched(cfg, dims, *args), out_batched
        return (
            jax.vmap(functools.partial(_ref_value_grad, cfg, dims))(*args),
            out_batched,
        )

    return op


def build_value_grad(cfg, dims, rows, n_rows, people_proj, present, costmap):
    """value_grad(u) -> (cost, g, jtj) for lm_solve (per-lane closure over
    the scenario data; see make_value_grad_op for the dispatch contract)."""
    op = make_value_grad_op(cfg, dims)
    data = value_grad_data(rows, n_rows, people_proj, present, costmap)

    def value_grad(u):
        return op(u, *data)

    return value_grad


def value_grad_data(rows, n_rows, people_proj, present, costmap):
    """The operand tuple make_value_grad_op consumes after u."""
    return (
        rows, n_rows, people_proj, present,
        jnp.asarray(costmap.data), jnp.asarray(costmap.origin),
        jnp.asarray(costmap.resolution),
    )
