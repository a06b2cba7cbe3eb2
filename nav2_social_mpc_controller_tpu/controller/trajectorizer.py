"""Reference-trajectory generation: the pure-pursuit-like rollout that turns
a geometric plan into a time-parameterized (poses, cmds) pair.

Reference parity target: PathTrajectorizer::trajectorize
(path_trajectorizer.cpp:120-288). The goal-distance-terminated while loop
becomes a fixed max_steps lax.scan with a done mask that reproduces the step
count exactly (loop runs while goal_dist > 0.2 && steps < max_steps, with
goal_dist initialized to 1000 so at least one step always executes).

The backward lookahead search (:160-175) — scan path from the END, break at
the first waypoint within lookahead_dist, else track the strict minimum —
becomes two masked reductions with identical tie-breaking (largest index of
the minimum, since updates require strictly smaller distance while scanning
backward).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nav2_social_mpc_controller_tpu.core.config import TrajectorizerConfig
from nav2_social_mpc_controller_tpu.core.types import PathInput
from nav2_social_mpc_controller_tpu.models.motion import integrate_step

GOAL_DIST_THRESHOLD = 0.2  # path_trajectorizer.cpp:150


class TrajectorizeResult(NamedTuple):
    poses: jnp.ndarray  # (max_steps + 1, 3) — poses[0] is the robot pose
    cmds: jnp.ndarray  # (max_steps, 3) [vx, vy, wz]
    n_steps: jnp.ndarray  # () int32 steps actually executed
    ok: jnp.ndarray  # () bool — False iff input path has < 2 poses


def _lookahead_point(px, py, valid, rx, ry, lookahead_dist):
    """Reference backward scan (path_trajectorizer.cpp:160-175): largest valid
    index with dist <= lookahead_dist; if none, the largest valid index among
    distance minimizers. Returns the waypoint COORDS via a one-hot reduction
    (instead of a per-step gather from the path array)."""
    p = px.shape[0]
    idx = jnp.arange(p)
    dist = jnp.hypot(rx - px, ry - py)
    within = valid & (dist <= lookahead_dist)
    any_within = jnp.any(within)
    idx_within = jnp.max(jnp.where(within, idx, -1))
    # Largest index of the minimum over valid entries:
    dist_masked = jnp.where(valid, dist, jnp.inf)
    rev_arg = jnp.argmin(dist_masked[::-1])
    idx_min = p - 1 - rev_arg
    wp_index = jnp.where(any_within, idx_within, idx_min)
    onehot = (idx == wp_index).astype(px.dtype)
    return jnp.sum(onehot * px), jnp.sum(onehot * py)


def trajectorize(cfg: TrajectorizerConfig, path: PathInput, robot_pose: jnp.ndarray):
    """Roll the control law along the plan.

    path: PathInput (plan frame); robot_pose: (3,) [x, y, yaw].
    Returns TrajectorizeResult with static shapes (max_steps from cfg).
    """
    max_steps = cfg.max_steps
    path = PathInput(*(jnp.asarray(x) for x in path))  # accept raw numpy inputs
    robot_pose = jnp.asarray(robot_pose)
    px = path.points[:, 0]
    py = path.points[:, 1]
    valid = path.valid
    ok = path.n >= 2

    last = jnp.clip(path.n - 1, 0, px.shape[0] - 1)
    goal_x = px[last]
    goal_y = py[last]

    dtype = path.points.dtype
    v_des = jnp.asarray(cfg.desired_linear_vel, dtype)
    w_max = jnp.asarray(cfg.max_angular_vel, dtype)

    def step(carry, _):
        rx, ry, rtheta, done = carry

        wpx, wpy = _lookahead_point(px, py, valid, rx, ry, cfg.lookahead_dist)

        # Transform waypoint into the local robot frame (:182-185)
        dx = (wpx - rx) * jnp.cos(rtheta) + (wpy - ry) * jnp.sin(rtheta)
        dy = -(wpx - rx) * jnp.sin(rtheta) + (wpy - ry) * jnp.cos(rtheta)
        dtheta = jnp.arctan2(dy, dx)

        if cfg.omnidirectional:
            vx = v_des * jnp.cos(dtheta)
            vy = v_des * jnp.sin(dtheta)
            wz = jnp.zeros((), dtype)
        else:
            point_dist2 = dx * dx + dy * dy
            curvature = jnp.where(point_dist2 > 0.001, 2.0 * dy / jnp.maximum(point_dist2, 1e-30), 0.0)
            rotate_in_place = jnp.abs(dtheta) > jnp.pi / 2.0
            vx = jnp.where(rotate_in_place, 0.0, v_des)
            wz = jnp.where(
                rotate_in_place,
                w_max * jnp.where(dtheta > 0, 1.0, -1.0),
                v_des * curvature,
            )
            vy = jnp.zeros((), dtype)

        nrx, nry, nrtheta = integrate_step(rx, ry, rtheta, vx, vy, wz, cfg.time_step)

        # Hold the pose and emit zero cmds once done (masked-out steps)
        nrx = jnp.where(done, rx, nrx)
        nry = jnp.where(done, ry, nry)
        nrtheta = jnp.where(done, rtheta, nrtheta)
        cmd = jnp.where(done, 0.0, jnp.stack([vx, vy, wz]))

        goal_dist = jnp.hypot(nrx - goal_x, nry - goal_y)
        new_done = done | (goal_dist <= GOAL_DIST_THRESHOLD)
        executed = ~done

        return (nrx, nry, nrtheta, new_done), (
            jnp.stack([nrx, nry, nrtheta]),
            cmd,
            executed,
        )

    carry0 = (robot_pose[0], robot_pose[1], robot_pose[2], ~ok)
    _, (poses, cmds, executed) = jax.lax.scan(step, carry0, None, length=max_steps, unroll=5)

    poses = jnp.concatenate([robot_pose[None, :], poses], axis=0)
    n_steps = jnp.sum(executed.astype(jnp.int32))
    return TrajectorizeResult(poses=poses, cmds=cmds, n_steps=n_steps, ok=ok)
