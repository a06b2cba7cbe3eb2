"""Social Force Model (Helbing/Moussaid variant) as vectorized JAX kernels.

Reference parity target: sfm.hpp (header-only singleton `sfm_controller::SFM`)
with the exact default parameters (sfm.hpp:43-57):
  forceFactorDesired 2.0, forceFactorObstacle 20, forceSigmaObstacle 0.2,
  forceFactorSocial 2.1, lambda 2.0, gamma 0.35, n 2.0, nPrime 3.0,
  relaxationTime 0.5 (+ group-force factors 3.0/2.0/1.0).

The agent loop of computeForces (sfm.hpp:462-485) becomes an N x N pairwise
kernel; updatePosition (sfm.hpp:525-573) is elementwise; the per-tick people
projection (Optimizer::project_people, optimizer.cpp:554-671) is a lax.scan
over the horizon.

Faithful quirks preserved:
  * The projection stores computeObstacle's DIFF vector (agent - obstacle) in
    obstacles1, but computeObstacleForce subtracts it from the position again
    (sfm.hpp:210), so the force actually uses minDiff = obstacle's world
    position. We replicate that arithmetic exactly.
  * An invalid ESDF (the 100x100 sentinel, optimizer.cpp:598-603) `continue`s
    before agents.push_back -> NO people are projected at all; steps >= 1 are
    all invalid agents.
  * The robot participates in force computation each step but its SFM update
    is discarded (optimizer.cpp:630-637).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nav2_social_mpc_controller_tpu.utils.angles import wrap_to_pi
from nav2_social_mpc_controller_tpu.world.grid import (
    crop_esdf_obstacle_window,
    esdf_nearest_obstacle_diff,
    esdf_nearest_obstacle_diff_windowed,
)

_EPS_DIR = 1e-6  # coincident-position guard (social_work_cost_function.hpp:124-127)


class SFMParams(NamedTuple):
    """sfm.hpp:43-57 defaults."""

    force_factor_desired: float = 2.0
    force_factor_obstacle: float = 20.0
    force_sigma_obstacle: float = 0.2
    force_factor_social: float = 2.1
    force_factor_group_gaze: float = 3.0
    force_factor_group_coherence: float = 2.0
    force_factor_group_repulsion: float = 1.0
    lam: float = 2.0
    gamma: float = 0.35
    n: float = 2.0
    n_prime: float = 3.0
    relaxation_time: float = 0.5


DEFAULT_PARAMS = SFMParams()


def _esdf_window_exact(window, resolution, people_desired_vel, dt, s_plus_1):
    """Opportunistic exactness check of the windowed obstacle lookup: agents
    drift at most people_desired_vel * dt per scan step (speed clamp,
    sfm.hpp:533-540), so window/2 must cover that drift plus 1 cell of
    floor() slack. Returns True when the resolution is traced (host
    boundaries run the hard check, core/validate.py); warns and returns
    False — falling back to the exact gather — on a concrete violation."""
    import math
    import warnings

    import jax as _jax

    if isinstance(resolution, _jax.core.Tracer):
        return True
    try:
        res = float(resolution)
    except (TypeError, _jax.errors.ConcretizationTypeError):
        return True
    if res <= 0.0:
        return True
    need = 2 * (math.ceil(people_desired_vel * dt * (s_plus_1 - 1) / res) + 1)
    if window >= need:
        return True
    warnings.warn(
        f"esdf_window_cells={window} is below the exactness bound {need} at "
        f"ESDF resolution {res}; falling back to the gather path (exact, "
        "slower).",
        stacklevel=3,
    )
    return False


def _safe_normalize(v, eps=_EPS_DIR):
    """normalize with the critic's coincident guard: a zero-length vector is
    replaced by the fixed small direction (eps, 0)."""
    norm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    tiny = norm < eps
    v = jnp.where(tiny, jnp.broadcast_to(jnp.array([eps, 0.0], v.dtype), v.shape), v)
    norm = jnp.where(tiny[..., 0], eps, norm[..., 0])
    return v / norm[..., None], norm


def desired_force(pos, vel, goal, has_goal, goal_radius, desired_speed, params: SFMParams):
    """computeDesiredForce (sfm.hpp:188-203). Batched over leading axes.

    Returns (force (...,2), desired_direction (...,2)).
    """
    diff = goal - pos
    dist = jnp.linalg.norm(diff, axis=-1)
    pursuing = has_goal & (dist > goal_radius)
    direction = diff / jnp.maximum(dist, _EPS_DIR)[..., None]
    f_goal = (
        params.force_factor_desired
        * (direction * desired_speed[..., None] - vel)
        / params.relaxation_time
    )
    f_stop = -vel / params.relaxation_time
    force = jnp.where(pursuing[..., None], f_goal, f_stop)
    direction = jnp.where(pursuing[..., None], direction, 0.0)
    return force, direction


def obstacle_force(pos, obstacle_entry, has_obstacle, radius, params: SFMParams):
    """computeObstacleForce (sfm.hpp:205-235) for the projection's single
    obstacles1 entry per agent.

    obstacle_entry holds the computeObstacle() output: apos - obstacle_world.
    The SFM then computes minDiff = pos - entry (== the obstacle's world
    position when entry was built from the same pos — replicated verbatim).
    """
    min_diff = pos - obstacle_entry
    dist = jnp.linalg.norm(min_diff, axis=-1) - radius
    direction, _ = _safe_normalize(min_diff)
    force = (
        params.force_factor_obstacle
        * jnp.exp(-dist / params.force_sigma_obstacle)[..., None]
        * direction
    )
    return jnp.where(has_obstacle[..., None], force, 0.0)


def pairwise_social_force(positions, velocities, valid, params: SFMParams):
    """computeSocialForce (sfm.hpp:237-281) over all entity pairs.

    positions/velocities: (M, 2); valid: (M,) bool.
    Returns (M, 2): for each entity j, the social force exerted by all other
    valid entities (invalid entities neither feel nor exert force).
    """
    m = positions.shape[0]
    diff = positions[None, :, :] - positions[:, None, :]  # [j, k] = pos_k - pos_j
    diff_dir, diff_norm = _safe_normalize(diff)
    vel_diff = velocities[:, None, :] - velocities[None, :, :]  # vel_j - vel_k
    interaction = params.lam * vel_diff + diff_dir
    inter_dir, inter_len = _safe_normalize(interaction)

    a1 = jnp.arctan2(inter_dir[..., 1], inter_dir[..., 0])
    a2 = jnp.arctan2(diff_dir[..., 1], diff_dir[..., 0])
    theta = wrap_to_pi(a2 - a1)

    b = params.gamma * inter_len
    d = diff_norm
    force_vel_amt = -jnp.exp(-d / b - (params.n_prime * b * theta) ** 2)
    theta_sign = jnp.sign(theta)  # matches sfm.hpp:265-270 (-1, 0, +1)
    force_ang_amt = -theta_sign * jnp.exp(-d / b - (params.n * b * theta) ** 2)

    left_normal = jnp.stack([-inter_dir[..., 1], inter_dir[..., 0]], axis=-1)
    pair_force = params.force_factor_social * (
        force_vel_amt[..., None] * inter_dir + force_ang_amt[..., None] * left_normal
    )

    mask = valid[:, None] & valid[None, :] & ~jnp.eye(m, dtype=bool)
    return jnp.sum(jnp.where(mask[..., None], pair_force, 0.0), axis=1)


def group_forces(positions, valid, group_id, desired_direction, radius, params: SFMParams):
    """computeGroupForce (sfm.hpp:325-393), non-_PAPER_VERSION_ branch.

    The reference projection never activates it (groupId = -1 for every
    projected agent), but it is part of the SFM library surface. Entities
    share a group iff group_id matches and >= 0; groups need >= 2 members.
    Returns (M, 2) total group force per entity.
    """
    m = positions.shape[0]
    same = (group_id[:, None] == group_id[None, :]) & (group_id[None, :] >= 0) & valid[None, :] & valid[:, None]
    count = jnp.sum(same, axis=1)
    in_group = count >= 2
    center = jnp.sum(jnp.where(same[..., None], positions[None, :, :], 0.0), axis=1) / jnp.maximum(
        count, 1
    )[..., None].astype(positions.dtype)

    # Gaze: center of the OTHER members (sfm.hpp:340-341)
    cnt_f = count.astype(positions.dtype)
    com_others = (cnt_f[..., None] * center - positions) / jnp.maximum(cnt_f - 1.0, 1.0)[..., None]
    rel = com_others - positions
    elem = jnp.sum(desired_direction * rel, axis=-1)
    denom = jnp.linalg.norm(desired_direction, axis=-1) * jnp.linalg.norm(rel, axis=-1)
    com_angle = wrap_to_pi(jnp.arccos(jnp.clip(elem / jnp.maximum(denom, _EPS_DIR), -1.0, 1.0)))
    dd_sq = jnp.maximum(jnp.sum(desired_direction**2, axis=-1), _EPS_DIR)
    gaze = jnp.where(
        (com_angle > jnp.pi / 2)[..., None],
        params.force_factor_group_gaze * (elem / dd_sq)[..., None] * desired_direction,
        0.0,
    )

    # Coherence (softened tanh version, sfm.hpp:371-376)
    rel_c = center - positions
    dist_c = jnp.linalg.norm(rel_c, axis=-1)
    max_dist = (cnt_f - 1.0) / 2.0
    soft = params.force_factor_group_coherence * (jnp.tanh(dist_c - max_dist) + 1.0) / 2.0
    coherence = rel_c * soft[..., None]

    # Repulsion (sfm.hpp:379-388)
    diff = positions[:, None, :] - positions[None, :, :]
    d = jnp.linalg.norm(diff, axis=-1)
    close = same & (d < (radius[:, None] + radius[None, :])) & ~jnp.eye(m, dtype=bool)
    repulsion = params.force_factor_group_repulsion * jnp.sum(
        jnp.where(close[..., None], diff, 0.0), axis=1
    )

    total = gaze + coherence + repulsion
    return jnp.where(in_group[..., None], total, 0.0)


def sfm_update(pos, vel, yaw, global_force, desired_speed, goal, has_goal, goal_radius, dt):
    """updatePosition (sfm.hpp:525-573) — Euler velocity update with speed
    clamp, yaw from velocity, angular velocity from yaw delta, goal pop.

    All args batched over a leading axis. Returns a tuple
    (pos', vel', yaw', lv', av', has_goal').
    """
    vel = vel + global_force * dt
    speed = jnp.linalg.norm(vel, axis=-1)
    over = speed > desired_speed
    vel = jnp.where(
        over[..., None], vel / jnp.maximum(speed, _EPS_DIR)[..., None] * desired_speed[..., None], vel
    )
    new_yaw = wrap_to_pi(jnp.arctan2(vel[..., 1], vel[..., 0]))
    av = wrap_to_pi(new_yaw - yaw) / dt
    pos = pos + vel * dt
    lv = jnp.linalg.norm(vel, axis=-1)
    reached = has_goal & (jnp.linalg.norm(goal - pos, axis=-1) <= goal_radius)
    return pos, vel, new_yaw, lv, av, has_goal & ~reached


def project_people(
    init_people,  # (N, 6) AgentsState rows [x, y, yaw, t, lv, av]
    robot_traj,  # (S+1, 6) robot reference rows (format_to_optimize output)
    robot_traj_n,  # () int32: valid rows in robot_traj
    esdf_distances,
    esdf_indexes,
    esdf_origin,
    esdf_resolution,
    esdf_valid,  # () bool
    maxtime: float,
    dt: float,
    params: SFMParams = DEFAULT_PARAMS,
    people_desired_vel: float = 0.5,
    people_radius: float = 0.5,
    robot_desired_vel: float = 0.6,
    robot_radius: float = 0.5,
    goal_radius: float = 0.25,
    esdf_window: int = 0,
):
    """SFM forward simulation of pedestrians along the robot's reference path
    (Optimizer::project_people, optimizer.cpp:554-671).

    Returns (S+1, N, 6): slot 0 is init_people verbatim; slot i >= 1 holds the
    agents after i SFM steps with t = i*dt (or t=-1 where invalid / beyond
    robot_traj_n). Slot order is preserved (the reference compacts valid
    agents to the front; critics are order-insensitive since they mask on t).
    """
    n = init_people.shape[0]
    s_plus_1 = robot_traj.shape[0]

    valid0 = (init_people[:, 3] != -1.0) & esdf_valid
    pos0 = init_people[:, 0:2]
    yaw0 = init_people[:, 2]
    lv0 = init_people[:, 4]
    av0 = init_people[:, 5]
    vel0 = jnp.stack([lv0 * jnp.cos(yaw0), lv0 * jnp.sin(yaw0)], axis=-1)
    # Constant-velocity-model goal (optimizer.cpp:587-591)
    goal0 = pos0 + maxtime * vel0

    # Per-step nearest-obstacle lookup: windowed masked-reduce when the
    # config enables it and the grid fits the u8/f32 exactness bounds (see
    # crop_esdf_obstacle_window), else the plain gather. A window below the
    # drift bound for this resolution (checkable only when the resolution is
    # concrete; host boundaries run the hard check, core/validate.py) also
    # falls back to the exact gather with a warning.
    grid_h, grid_w = esdf_distances.shape[-2], esdf_distances.shape[-1]
    use_window = (
        esdf_window > 0
        and esdf_window <= min(grid_h, grid_w)
        and grid_h <= 256
        and grid_w <= 256
        and grid_h * grid_w < 2**24
        and _esdf_window_exact(
            esdf_window, esdf_resolution, people_desired_vel, dt, s_plus_1
        )
    )
    if use_window:
        oxy_u16, w_col, w_row = crop_esdf_obstacle_window(
            esdf_indexes, pos0, esdf_origin, esdf_resolution, esdf_window
        )

        def obstacle_lookup(query_xy):
            return esdf_nearest_obstacle_diff_windowed(
                oxy_u16, w_col, w_row, (grid_h, grid_w),
                esdf_origin, esdf_resolution, esdf_window, query_xy,
            )
    else:

        def obstacle_lookup(query_xy):
            return esdf_nearest_obstacle_diff(
                esdf_distances, esdf_indexes, esdf_origin, esdf_resolution, query_xy
            )

    obs_entry0, obs_in0 = obstacle_lookup(pos0)

    # Robot goal: LAST VALID row of the (truncated) robot path
    # (optimizer.cpp:625: robot_path.back()).
    last = jnp.clip(robot_traj_n - 1, 0, s_plus_1 - 1)
    robot_goal = robot_traj[last, 0:2]

    robot_desired = jnp.full((), robot_desired_vel, init_people.dtype)
    people_desired = jnp.full((n,), people_desired_vel, init_people.dtype)

    def step(carry, inp):
        pos, vel, yaw, lv, av, has_goal, goal, obs_entry, obs_has = carry
        robot_row, step_i = inp

        r_pos = robot_row[0:2]
        r_yaw = robot_row[2]
        r_lv = robot_row[4]
        r_vel = jnp.stack([r_lv * jnp.cos(r_yaw), r_lv * jnp.sin(r_yaw)])

        # --- computeForces over [people..., robot] (optimizer.cpp:630-633) ---
        all_pos = jnp.concatenate([pos, r_pos[None, :]], axis=0)
        all_vel = jnp.concatenate([vel, r_vel[None, :]], axis=0)
        all_valid = jnp.concatenate([valid0, jnp.ones((1,), bool)], axis=0)
        social = pairwise_social_force(all_pos, all_vel, all_valid, params)[:n]

        f_des, _ = desired_force(
            pos, vel, goal, has_goal, goal_radius, people_desired, params
        )
        f_obs = obstacle_force(pos, obs_entry, obs_has & valid0, people_radius, params)
        global_force = f_des + social + f_obs  # group force == 0 (groupId -1)

        # --- updatePosition on people (robot's update is discarded) ---
        pos_n, vel_n, yaw_n, lv_n, av_n, has_goal_n = sfm_update(
            pos, vel, yaw, global_force, people_desired, goal, has_goal, goal_radius, dt
        )

        # Refresh obstacles from the NEW positions (optimizer.cpp:641-645)
        obs_entry_n, obs_in_n = obstacle_lookup(pos_n)
        obs_has_n = obs_in_n & esdf_valid

        # Freeze invalid agents / steps beyond the robot path
        active = valid0 & (step_i < robot_traj_n - 1)
        keep = lambda new, old: jnp.where(
            active[..., None] if new.ndim == old.ndim == 2 else active, new, old
        )
        carry_n = (
            keep(pos_n, pos),
            keep(vel_n, vel),
            keep(yaw_n, yaw),
            keep(lv_n, lv),
            keep(av_n, av),
            jnp.where(active, has_goal_n, has_goal),
            goal,
            keep(obs_entry_n, obs_entry),
            jnp.where(active, obs_has_n, obs_has),
        )

        t_col = jnp.where(active, (step_i + 1).astype(pos.dtype) * dt, -1.0)
        out = jnp.stack(
            [
                carry_n[0][:, 0],
                carry_n[0][:, 1],
                carry_n[2],
                t_col,
                carry_n[3],
                carry_n[4],
            ],
            axis=-1,
        )
        # Invalid agents are emitted as the reference's zero/-1 padding rows.
        out = jnp.where(active[:, None], out, jnp.zeros_like(out).at[:, 3].set(-1.0))
        return carry_n, out

    carry0 = (
        pos0,
        vel0,
        yaw0,
        lv0,
        av0,
        valid0,  # has_goal starts true for valid agents
        goal0,
        obs_entry0,
        obs_in0 & esdf_valid,
    )
    steps = jnp.arange(s_plus_1 - 1, dtype=jnp.int32)
    _, traj = jax.lax.scan(step, carry0, (robot_traj[:-1], steps), unroll=4)
    return jnp.concatenate([init_people[None, :, :], traj], axis=0)
