"""Synthetic scenario generation for tests and benchmarks.

The reference validated in Gazebo with a Jackal robot and an external
obstacle_distance_manager (SURVEY.md section 4); this module is the
framework's equivalent world source: sinusoidal/random plans (the reference's
stale manual test built a*sin(x)+b paths over 20 points,
src/test_path_trajectorizer.cpp:68-87), random pedestrian sets, occupancy
costmaps, and brute-force ESDF grids matching the obstacle_distance message
layout (distances + nearest-obstacle flat indexes, x + y*W ordering,
obstacle_distance_interface.cpp:71-103).

Host-side NumPy on purpose: scenario generation is the data-loading layer,
not the compute path.
"""

import numpy as np

from nav2_social_mpc_controller_tpu.core.config import SocialMPCConfig
from nav2_social_mpc_controller_tpu.core.types import (
    AgentsState,
    Costmap,
    ObstacleDistanceGrid,
    PathInput,
    RobotState,
    Scenario,
)


def make_path(n_points: int, max_points: int, kind: str = "sine", rng=None, dtype=np.float32):
    """Padded PathInput. kind: 'sine' | 'straight' | 'arc'."""
    rng = rng or np.random.default_rng(0)
    t = np.linspace(0.0, 6.0, n_points)
    if kind == "sine":
        amp = rng.uniform(0.3, 1.0)
        xs, ys = t, amp * np.sin(0.8 * t)
    elif kind == "arc":
        r = rng.uniform(3.0, 8.0)
        ang = t / r
        xs, ys = r * np.sin(ang), r * (1.0 - np.cos(ang))
    else:
        xs, ys = t, np.zeros_like(t)
    yaw = np.arctan2(np.gradient(ys), np.gradient(xs))

    pts = np.zeros((max_points, 2), dtype)
    yw = np.zeros((max_points, ), dtype)
    n = min(n_points, max_points)
    pts[:n, 0], pts[:n, 1], yw[:n] = xs[:n], ys[:n], yaw[:n]
    pts[n:] = pts[n - 1]
    yw[n:] = yw[n - 1]
    return PathInput(points=pts, yaw=yw, n=np.int32(n))


def make_people(n_agents: int, n_valid: int, rng=None, dtype=np.float32, spread=3.0):
    """AgentsState with n_valid walkers around the path corridor; the rest
    padded invalid (t = -1), like people_to_status (optimizer.cpp:454-482)."""
    rng = rng or np.random.default_rng(1)
    st = np.zeros((n_agents, 6), dtype)
    st[:, 3] = -1.0
    for i in range(min(n_valid, n_agents)):
        st[i, 0] = rng.uniform(0.5, spread)
        st[i, 1] = rng.uniform(-1.5, 1.5)
        vx, vy = rng.uniform(-0.6, 0.6, size=2)
        st[i, 2] = np.arctan2(vy, vx)
        st[i, 3] = 0.0
        st[i, 4] = np.hypot(vx, vy)
        st[i, 5] = 0.0
    return AgentsState(state=st)


def make_costmap(h: int, w: int, resolution=0.05, origin=(-1.0, -3.0), obstacles=(), dtype=np.float32):
    """Costmap with Gaussian-inflated obstacle blobs (0..254 like nav2).

    Values are rounded to INTEGERS: nav2's Costmap2D stores unsigned char
    cost (what the reference interpolates, ceres::Grid2D<u_char>,
    optimizer.cpp:167-170), so integer-valued grids are the faithful
    domain."""
    data = np.zeros((h, w), dtype)
    yy, xx = np.mgrid[0:h, 0:w]
    for (ox_w, oy_w, radius_m) in obstacles:
        cx = (ox_w - origin[0]) / resolution
        cy = (oy_w - origin[1]) / resolution
        r = radius_m / resolution
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        data = np.maximum(data, 254.0 * np.exp(-d2 / max(2.0 * r * r, 1e-6)))
    return Costmap(
        data=np.rint(data).astype(dtype),
        origin=np.asarray(origin, dtype),
        resolution=np.asarray(resolution, dtype),
    )


def make_esdf(h: int, w: int, resolution=0.05, origin=(-1.0, -3.0), obstacle_cells=None, dtype=np.float32):
    """ESDF matching the obstacle_distance message: per-cell distance [m] to
    the nearest obstacle cell and that cell's flat index (x + y*W), built by
    the native C++ exact distance transform (runtime/esdf_builder.cpp; NumPy
    fallback without a compiler). With no obstacles, every index points at
    cell 0 and distances are large. (h, w) == (100, 100) would trip the
    reference's invalid-grid sentinel (optimizer.cpp:598) — avoid for valid
    grids."""
    from nav2_social_mpc_controller_tpu.runtime import esdf as esdf_rt

    occ = np.zeros((h, w), np.uint8)
    if obstacle_cells is not None:
        for (x, y) in obstacle_cells:
            if 0 <= x < w and 0 <= y < h:
                occ[y, x] = 1
    distances, indexes = esdf_rt.build_esdf(occ, resolution)
    return ObstacleDistanceGrid(
        distances=distances.astype(dtype),
        indexes=indexes,
        origin=np.asarray(origin, dtype),
        resolution=np.asarray(resolution, dtype),
        valid=np.asarray(not (h == 100 and w == 100)),
    )


def make_scenario(
    cfg: SocialMPCConfig,
    seed: int = 0,
    n_valid_people: int = 3,
    path_kind: str = "sine",
    n_path_points: int = 40,
    grid_hw=(120, 120),
    with_obstacles: bool = True,
    dtype=np.float32,
) -> Scenario:
    rng = np.random.default_rng(seed)
    path = make_path(n_path_points, cfg.max_path_points, path_kind, rng, dtype)
    robot = RobotState(
        pose=np.array([path.points[0, 0], path.points[0, 1], path.yaw[0]], dtype),
        speed=np.array([rng.uniform(0.0, 0.3), 0.0], dtype),
    )
    people = make_people(cfg.n_agents, n_valid_people, rng, dtype)
    h, w = grid_hw
    obstacles = [(3.0, 1.2, 0.3), (1.5, -0.8, 0.25)] if with_obstacles else []
    costmap = make_costmap(h, w, obstacles=obstacles, dtype=dtype)
    obs_cells = (
        [(int((ox + 1.0) / 0.05), int((oy + 3.0) / 0.05)) for (ox, oy, _) in obstacles]
        if with_obstacles
        else None
    )
    esdf = make_esdf(h, w, obstacle_cells=obs_cells, dtype=dtype)
    # Windowing-exactness hard check at this host boundary (the jitted step
    # traces the resolutions and cannot fall back in-graph, core/validate.py).
    from nav2_social_mpc_controller_tpu.core.validate import validate_scenario_windows

    validate_scenario_windows(cfg, costmap.resolution, esdf.resolution)
    return Scenario(path=path, robot=robot, people=people, costmap=costmap, esdf=esdf)


def stack_scenarios(scenarios):
    """Stack a list of same-shaped Scenarios into a batched Scenario."""
    import jax

    return jax.tree.map(lambda *xs: np.stack(xs), *scenarios)


def make_scenario_batch(cfg: SocialMPCConfig, batch: int, base_seed: int = 0, **kw) -> Scenario:
    return stack_scenarios([make_scenario(cfg, seed=base_seed + i, **kw) for i in range(batch)])
