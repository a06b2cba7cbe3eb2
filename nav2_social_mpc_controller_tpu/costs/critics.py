"""The critic library: every reference cost functor re-designed as a
vectorized residual kernel over the shared horizon rollout.

Reference mapping (SURVEY.md section 2.2; all residuals are scalar per step
and pre-multiplied by their weight, so the solver cost is 0.5*sum(r^2) with
these exact r values):

  distance_cost        <- critics/distance_cost_function.hpp:117-132
                          w * ||p_{i+1} - target||^4 (squaredNorm squared).
                          Role A "path follow" (target = final trajectorized
                          point), role B "path align" (target = per-step ref
                          point i+1, weight = angle_weight) — optimizer.cpp:330-334.
  obstacle_cost        <- critics/obstacle_cost_function.hpp:137-167
                          w * BiCubic(costmap)(front point), front = pose +
                          0.25 m along heading ("size of jackal").
  social_work_cost     <- critics/social_work_cost_function.hpp:102-228
  proxemics_cost       <- critics/proxemics_cost_function.hpp:83-151
                          w * 3.0 * exp(-min_dist^2 / 0.5^2)
  agent_angle_cost     <- critics/agent_angle_cost_function.hpp:125-195
  velocity_cost        <- critics/velocity_cost_function.hpp:89-99
  goal_align_cost      <- critics/goal_align_cost_function.hpp:100-116
  velocity_feasibility <- critics/velocity_feasibility_cost_function.hpp:86-98
  angle_cost           <- critics/angle_cost_function.hpp:94-108 (latent:
                          compiled but never instantiated by the reference
                          optimizer; available here behind pure_angle_weight)
  curvature_cost       <- critics/curvature_cost_function.hpp:65-87 (latent,
                          behind curvature_weight)

Unlike the reference — where each functor re-integrates the rollout from
pose_0 (O(H^2)) — every kernel here consumes the SAME (S+1, 3) pose array
produced once per solver iteration by models.motion.rollout_poses.

All kernels take a (S,) step axis and return (S,) residuals; conditional
logic becomes masked arithmetic with identical branch outcomes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.custom_derivatives import SymbolicZero

from nav2_social_mpc_controller_tpu.utils.angles import wrap_atan2
from nav2_social_mpc_controller_tpu.world.grid import sample_costmap


def _stepwise_custom_jvp(impl, stepwise_argnums):
    """Wrap a per-step scalar critic with a one-reverse-pass JVP.

    `impl(*args) -> (S,)` must be DIAGONAL in the step axis: output step i
    depends only on row i of every arg in `stepwise_argnums` (leading axis
    S) plus the remaining args as shared constants. Then

        grad_a sum_i impl(...)_i  ==  the per-step gradients, stacked,

    so ONE reverse pass yields d(out_i)/d(arg_i) for every active tangent,
    and the staged linear map (what jacfwd/linearize replays once per
    tangent) collapses to elementwise multiply-reduce dots. Inside the LM
    solver's 6-tangent Jacobian build this removes the 6x re-evaluation of
    the critic's linearized transcendental chain (exp/atan2/norm tangents
    measured at ~25% of an LM iteration for the 6-agent config).

    Tangents on shared (non-stepwise) args fall back to plain jax.jvp —
    that path never triggers in the solver (only the decision variables are
    perturbed) but keeps e.g. d/d(weight) correct for tests.
    """
    fn = jax.custom_jvp(impl)

    @functools.partial(fn.defjvp, symbolic_zeros=True)
    def _rule(primals, tangents):
        active = [i for i, t in enumerate(tangents) if not isinstance(t, SymbolicZero)]
        if not active:
            y = impl(*primals)
            return y, jnp.zeros_like(y)
        if any(i not in stepwise_argnums for i in active):
            mat = tuple(
                jnp.zeros(jnp.shape(p), jnp.result_type(p)) if isinstance(t, SymbolicZero) else t
                for p, t in zip(primals, tangents)
            )
            return jax.jvp(impl, tuple(primals), mat)
        def partial_impl(*act_args):
            full = list(primals)
            for i, a in zip(active, act_args):
                full[i] = a
            return impl(*full)

        y, pullback = jax.vjp(partial_impl, *[primals[i] for i in active])
        # Cotangent of ones sums the rows — which, by diagonality, IS the
        # stack of per-step gradients.
        grads = pullback(jnp.ones_like(y))
        t_out = jnp.zeros_like(y)
        for gi, i in zip(grads, active):
            prod = gi * tangents[i]
            t_out = t_out + prod.reshape(prod.shape[0], -1).sum(axis=1)
        return y, t_out

    return fn

FRONT_OFFSET = 0.25  # "considering size of jackal", obstacle_cost_function.hpp:152

# SFM constants hardcoded in the SocialWorkCost ctor
# (social_work_cost_function.cpp:38-43)
SW_LAMBDA = 2.0
SW_GAMMA = 0.35
SW_NPRIME = 3.0
SW_N = 2.0
SW_FORCE_FACTOR_SOCIAL = 2.1

# ProxemicsCost ctor constants (proxemics_cost_function.cpp:37-38)
PROXEMICS_ALPHA = 3.0
PROXEMICS_D0 = 0.5

# AgentAngleCost ctor constants (agent_angle_cost_function.cpp:31 + hpp:159-164).
# Plain Python floats (weak-typed) so they never promote f32 pipelines to f64
# when jax_enable_x64 is on.
AGENT_ANGLE_SAFE_DIST_SQ = 4.0
AGENT_ANGLE_MIN_SPEED = 0.05
AGENT_ANGLE_THRESHOLD = float(np.pi / 6.0)
AGENT_ANGLE_UPPER_THRESHOLD = float(5.0 * np.pi / 6.0)


def distance_cost(weight, pos, target):
    """w * ||pos - target||^4. pos: (S, 2); target: (2,) or (S, 2)."""
    sq = jnp.sum((pos - target) ** 2, axis=-1)
    return weight * sq * sq


def obstacle_cost(weight, poses, costmap_data, costmap_origin, costmap_resolution):
    """w * bicubic(costmap) at the front point of each pose. poses: (S, 3)."""
    front = poses[:, 0:2] + FRONT_OFFSET * jnp.stack(
        [jnp.cos(poses[:, 2]), jnp.sin(poses[:, 2])], axis=-1
    )
    return weight * sample_costmap(costmap_data, costmap_origin, costmap_resolution, front)


def _critic_social_force(me_pos, me_vel, agents_pos, agents_vel, agents_valid):
    """SocialWorkCost::computeSocialForce (social_work_cost_function.hpp:164-228).

    Differs deliberately from models.sfm.pairwise_social_force: the guard
    replaces a < 1e-6 POSITION diff by (1e-6, 0), and sign(theta) has no zero
    case (theta > 0 ? 1 : -1).

    me_pos/me_vel: (..., 2); agents_*: (..., N, 2); agents_valid: (..., N).
    Returns (..., 2) summed force on `me`.
    """
    diff = me_pos[..., None, :] - agents_pos
    dnorm = jnp.linalg.norm(diff, axis=-1)
    tiny = dnorm < 1e-6
    diff = jnp.where(
        tiny[..., None], jnp.broadcast_to(jnp.array([1e-6, 0.0], diff.dtype), diff.shape), diff
    )
    dnorm = jnp.where(tiny, 1e-6, dnorm)
    diff_dir = diff / dnorm[..., None]

    vel_diff = me_vel[..., None, :] - agents_vel
    interaction = SW_LAMBDA * vel_diff + diff_dir
    ilen = jnp.linalg.norm(interaction, axis=-1)
    ilen = jnp.maximum(ilen, 1e-30)  # reference divides unguarded
    idir = interaction / ilen[..., None]

    theta = wrap_atan2(
        jnp.arctan2(diff_dir[..., 1], diff_dir[..., 0])
        - jnp.arctan2(idir[..., 1], idir[..., 0])
    )
    b = SW_GAMMA * ilen
    fvel_amt = -jnp.exp(-dnorm / b - (SW_NPRIME * b * theta) ** 2)
    sign = jnp.where(theta > 0.0, 1.0, -1.0)
    fang_amt = -sign * jnp.exp(-dnorm / b - (SW_N * b * theta) ** 2)

    left_normal = jnp.stack([-idir[..., 1], idir[..., 0]], axis=-1)
    pair = SW_FORCE_FACTOR_SOCIAL * (fvel_amt[..., None] * idir + fang_amt[..., None] * left_normal)
    return jnp.sum(jnp.where(agents_valid[..., None], pair, 0.0), axis=-2)


def _heading_vel(yaw, lv):
    return jnp.stack([lv * jnp.cos(yaw), lv * jnp.sin(yaw)], axis=-1)


def _social_work_impl(weight, robot_pos, robot_yaw, robot_vw, agents):
    """w * (||SF(robot <- agents)||^2 + sum_j ||SF(agent_j <- robot)||^2 + 1e-6).

    robot_pos: (S, 2) = poses[1:, 0:2]; robot_yaw: (S,); robot_vw: (S, 2)
    block-expanded controls; agents: (S, N, 6) projected people at step i+1.

    Faithful quirk: the per-agent term wp iterates ALL agent slots including
    invalid (t=-1) padding rows — computeSocialForce never checks `me`'s own
    validity (social_work_cost_function.hpp:135-146) — so phantom agents at
    the origin DO feel force from the robot. Replicated exactly.
    """
    a_pos = agents[..., 0:2]
    a_vel = _heading_vel(agents[..., 2], agents[..., 4])
    a_valid = agents[..., 3] != -1.0
    r_vel = _heading_vel(robot_yaw, robot_vw[:, 0])

    sf_robot = _critic_social_force(robot_pos, r_vel, a_pos, a_vel, a_valid)
    wr = jnp.sum(sf_robot**2, axis=-1)

    # Force on each agent slot from the robot alone (robot_agent matrix has
    # only the robot valid, hpp:140-144).
    n = agents.shape[-2]
    me_pos = a_pos  # (S, N, 2)
    me_vel = a_vel
    sf_agents = _critic_social_force(
        me_pos,
        me_vel,
        jnp.broadcast_to(robot_pos[:, None, None, :], (robot_pos.shape[0], n, 1, 2)),
        jnp.broadcast_to(r_vel[:, None, None, :], (r_vel.shape[0], n, 1, 2)),
        jnp.ones((robot_pos.shape[0], n, 1), bool),
    )
    wp = jnp.sum(jnp.sum(sf_agents**2, axis=-1), axis=-1)

    return weight * (wr + wp + 1e-6)


def _proxemics_impl(weight, robot_pos, agents):
    """w * alpha * exp(-min_valid_dist^2 / d0^2) (proxemics_cost_function.hpp:83-151).

    With no valid agent the min stays +inf and the residual underflows to 0,
    matching the reference's numeric_limits<double>::max() initialization.
    """
    a_valid = agents[..., 3] != -1.0
    sq = jnp.sum((robot_pos[:, None, :] - agents[..., 0:2]) ** 2, axis=-1)
    min_sq = jnp.min(jnp.where(a_valid, sq, jnp.inf), axis=-1)
    return weight * PROXEMICS_ALPHA * jnp.exp(-min_sq / (PROXEMICS_D0 * PROXEMICS_D0))


def _agent_angle_impl(weight, new_yaw, robot_init_pose, agents):
    """Social-norm steering critic (agent_angle_cost_function.hpp:125-195).

    new_yaw: (S,) = poses[1:, 2]; robot_init_pose: (3,) pose_0;
    agents: (S, N, 6) projected people at step i+1.

    Branch structure preserved as masks:
      closest MOVING (lv > 0.05) agent by distance to pose_0; nothing close
      (d^2 > 4) -> 0; agent heading roughly opposing/crossing
      (diff <= -5pi/6 or >= pi/6): agent on the left -> steer right
      (yaw_0 - pi/6), agent already right -> 0; otherwise mirrored.
    """
    x0, y0, yaw0 = robot_init_pose[0], robot_init_pose[1], robot_init_pose[2]
    moving = agents[..., 4] > AGENT_ANGLE_MIN_SPEED
    dx = agents[..., 0] - x0
    dy = agents[..., 1] - y0
    dist_sq = dx * dx + dy * dy
    masked = jnp.where(moving, dist_sq, jnp.inf)
    ci = jnp.argmin(masked, axis=-1)  # first minimum == reference's < scan
    closest_sq = jnp.min(masked, axis=-1)  # == masked[s, ci] without a gather
    has_agent = jnp.isfinite(closest_sq) & (closest_sq <= AGENT_ANGLE_SAFE_DIST_SQ)

    # agents[s, ci] as a one-hot reduction instead of a batched per-row
    # gather; the masked sum over N<=6 slots is a few elementwise ops.
    onehot = ci[:, None] == jnp.arange(agents.shape[-2])
    ag = jnp.sum(jnp.where(onehot[..., None], agents, 0.0), axis=-2)  # (S, 6)
    agent_angle_initial = jnp.arctan2(ag[:, 1] - y0, ag[:, 0] - x0)
    heading_diff = wrap_atan2(ag[:, 2] - yaw0)
    side = wrap_atan2(agent_angle_initial - yaw0)

    opposing = (heading_diff <= -AGENT_ANGLE_UPPER_THRESHOLD) | (
        heading_diff >= AGENT_ANGLE_THRESHOLD
    )
    # opposing: active when agent is on the left (side >= 0), steer right
    # same-direction: active when agent is on the right (side <= 0), steer left
    active = has_agent & jnp.where(opposing, side >= 0.0, side <= 0.0)
    steer = jnp.where(opposing, yaw0 - AGENT_ANGLE_THRESHOLD, yaw0 + AGENT_ANGLE_THRESHOLD)
    ang = wrap_atan2(new_yaw - steer)
    return jnp.where(active, weight * ang * ang, 0.0)


# Public critics: the three agent-interaction kernels (the transcendental-
# heavy ones) get the one-reverse-pass stepwise JVP; weight and pose_0 are
# shared args (fall back to jax.jvp if ever perturbed). The cheap polynomial
# critics below stay plain — their autodiff tangents are already elementwise.
social_work_cost = _stepwise_custom_jvp(_social_work_impl, (1, 2, 3, 4))
proxemics_cost = _stepwise_custom_jvp(_proxemics_impl, (1, 2))
agent_angle_cost = _stepwise_custom_jvp(_agent_angle_impl, (1, 3))


def velocity_cost(weight, desired_linear_vel, v_step, in_horizon):
    """w * (v_des - v_block(i))^2 while i < control_horizon, else 0
    (velocity_cost_function.hpp:89-99). v_step: (S,), in_horizon: static (S,)."""
    d = desired_linear_vel - v_step
    return jnp.where(jnp.asarray(in_horizon), weight * d * d, 0.0)


def goal_align_cost(weight, goal_yaw, new_yaw):
    """w * wrap(goal_heading - theta_{i+1})^2 (goal_align_cost_function.hpp:100-116)."""
    t = wrap_atan2(goal_yaw - new_yaw)
    return weight * t * t


def velocity_feasibility_cost(weight, u, n_pairs: int):
    """w*(v_b - v_{b-1})^2 + w*(w_b - w_{b-1})^2 between consecutive blocks
    b = 1..n_pairs (velocity_feasibility_cost_function.hpp:86-98; added for
    0 < i < control_horizon/block_length, optimizer.cpp:364-370).
    u: (B, 2). Returns (n_pairs,)."""
    if n_pairs <= 0:
        return jnp.zeros((0,), u.dtype)
    d = u[1 : n_pairs + 1] - u[0:n_pairs]
    return weight * jnp.sum(d * d, axis=-1)


def angle_cost(weight, pos, yaw, target):
    """Latent AngleCost (angle_cost_function.hpp:94-108): face toward target.
    pos: (S, 2); yaw: (S,); target: (2,) or (S, 2)."""
    d = target - pos
    point_heading = jnp.arctan2(d[..., 1], d[..., 0])
    diff = point_heading - wrap_atan2(yaw)
    return weight * diff * diff


def curvature_cost(weight, max_angle, p1, p2, p3):
    """Latent CurvatureCost (curvature_cost_function.hpp:65-87) among three
    consecutive points; zero inside [pi-a, pi+a]."""
    v1 = p2 - p1
    v2 = p2 - p3
    dot = jnp.sum(v1 * v2, axis=-1)
    n1 = jnp.linalg.norm(v1, axis=-1)
    n2 = jnp.linalg.norm(v2, axis=-1)
    ang = jnp.arccos(jnp.clip(dot / jnp.maximum(n1 * n2, 1e-30), -1.0, 1.0))
    lo = jnp.pi - max_angle
    hi = jnp.pi + max_angle
    mid = 0.5 * (lo + hi)
    out = weight * jnp.exp(jnp.sqrt((ang - mid) ** 2))
    return jnp.where((ang < lo) | (ang > hi), out, 0.0)
