"""Plan windowing and goal extraction.

Reference parity target: mpc::PathHandler (tools/path_handler.{hpp,cpp}).
The TF-tree machinery collapses in this framework — scenarios carry the plan
already in the planning frame — leaving the geometric operations:

  transform_global_plan <- PathHandler::transformGlobalPlan
      (path_handler.cpp:40-108): locate the closest plan pose to the robot
      among the poses within max_robot_pose_search_dist of INTEGRATED path
      length from the start (first_after_integrated_distance + min_by), then
      window forward until the euclidean distance from the robot exceeds
      dist_threshold (half the costmap extent). The reference also erases the
      passed poses from the stored plan; here the start index is returned so
      a host driver can prune its copy.
  get_goal_point <- PathHandler::getTransformedGoal (path_handler.cpp:115-137):
      first windowed pose at euclidean distance >= goal_dist, else the last.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nav2_social_mpc_controller_tpu.core.types import PathInput


def _onehot_rows(src: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """table[src] as a one-hot matmul: src (K,) int32, table (P, ...) ->
    (K, ...). Under vmap a fancy-index becomes a per-row gather; the one-hot
    dot batches into one matmul and is exact at Precision.HIGHEST (0/1
    weights)."""
    onehot = (src[:, None] == jnp.arange(table.shape[0], dtype=src.dtype)).astype(table.dtype)
    flat = table.reshape(table.shape[0], -1)
    out = jnp.matmul(onehot, flat, precision=jax.lax.Precision.HIGHEST)
    return out.reshape((src.shape[0],) + table.shape[1:])


class WindowedPlan(NamedTuple):
    path: PathInput  # same static size, re-based to the window
    start_index: jnp.ndarray  # () int32 index into the input plan (prune point)


def transform_global_plan(
    path: PathInput,
    robot_pose: jnp.ndarray,
    max_robot_pose_search_dist: float,
    dist_threshold: float,
    start=None,
) -> WindowedPlan:
    """`start` (() int32, default 0) is the cumulative prune cursor: the
    reference ERASES [begin(), transformation_begin) from its STORED plan
    every tick (path_handler.cpp:100), so the next tick's integrated-distance
    search starts from the pruned head. Passing the previous tick's
    start_index here reproduces that erase in-graph (poses before `start`
    are unsearchable and the cumulative distance is measured from `start`),
    which lets batched/scanned fleet drivers advance along long plans without
    host round-trips. The returned start_index is absolute (cumulative)."""
    p = path.points.shape[0]
    idx = jnp.arange(p)
    valid = path.valid

    seg = jnp.linalg.norm(path.points[1:] - path.points[:-1], axis=-1)
    cum = jnp.concatenate([jnp.zeros((1,), seg.dtype), jnp.cumsum(seg)])
    if start is None:
        start = jnp.zeros((), jnp.int32)
    # Integrated distance measured from the pruned head (one-hot pick — a
    # dynamic scalar index would lower to a per-scenario gather under vmap):
    cum0 = jnp.sum(jnp.where(idx == start, cum, 0.0))
    # first_after_integrated_distance: poses searched are [begin, upper_bound)
    searchable = valid & (idx >= start) & (cum - cum0 <= max_robot_pose_search_dist)

    d_robot = jnp.linalg.norm(path.points - robot_pose[0:2], axis=-1)
    begin = jnp.argmin(jnp.where(searchable, d_robot, jnp.inf))

    # find_if from begin: first pose farther than dist_threshold ends the window
    beyond = valid & (idx >= begin) & (d_robot > dist_threshold)
    any_beyond = jnp.any(beyond)
    end = jnp.where(beyond, idx, p)
    end = jnp.where(any_beyond, jnp.min(end), jnp.minimum(path.n, p))

    n_new = jnp.maximum(end - begin, 0).astype(jnp.int32)
    src = jnp.clip(begin + idx, 0, p - 1)
    # Pad tail with the last valid pose so downstream gathers stay safe.
    last_src = jnp.clip(begin + n_new - 1, 0, p - 1)
    src = jnp.where(idx < n_new, src, last_src)
    new_points = _onehot_rows(src, path.points)
    new_yaw = _onehot_rows(src, path.yaw)
    return WindowedPlan(
        path=PathInput(points=new_points, yaw=new_yaw, n=n_new),
        start_index=begin.astype(jnp.int32),
    )


def get_goal_point(path: PathInput, robot_pose: jnp.ndarray, goal_dist: float):
    """First plan pose at distance >= goal_dist from the robot, else the
    last (path_handler.cpp:115-137). Returns (2,) point."""
    p = path.points.shape[0]
    idx = jnp.arange(p)
    d = jnp.linalg.norm(path.points - robot_pose[0:2], axis=-1)
    hit = path.valid & (d >= goal_dist)
    first_hit = jnp.where(jnp.any(hit), jnp.min(jnp.where(hit, idx, p)), jnp.clip(path.n - 1, 0, p - 1))
    return _onehot_rows(jnp.clip(first_hit, 0, p - 1)[None], path.points)[0]
