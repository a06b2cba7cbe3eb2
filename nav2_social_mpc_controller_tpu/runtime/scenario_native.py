"""ctypes binding for the native scenario generator
(runtime/scenario_gen.cpp + esdf_builder.cpp), compiled on demand.

This is the fleet-scale data-loading layer: one call fills a full batched
``Scenario`` pytree (plans, robot states, pedestrians, costmaps, exact-EDT
ESDFs) using all host cores — the role the reference delegates to Gazebo +
ROS topics + the external obstacle_distance_manager. Distributions mirror
utils/scenarios.py (the readable single-scenario NumPy oracle); falls back
to looping that oracle when no compiler is available.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

from nav2_social_mpc_controller_tpu.core.types import (
    AgentsState,
    Costmap,
    ObstacleDistanceGrid,
    PathInput,
    RobotState,
    Scenario,
)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "scenario_gen.cpp"), os.path.join(_HERE, "esdf_builder.cpp")]
_LIB = os.path.join(_HERE, "libscenario.so")
_lock = threading.Lock()
_lib = None
_load_failed = False

_PATH_KINDS = {"sine": 0, "straight": 1, "arc": 2}


def _build_and_load(force: bool):
    """Compile the sources into _LIB (when forced or stale) and bind it."""
    src_mtime = max(os.path.getmtime(s) for s in _SRCS)
    if force or not os.path.exists(_LIB) or os.path.getmtime(_LIB) < src_mtime:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", _LIB, *_SRCS, "-lpthread"],
            check=True,
            capture_output=True,
        )
    lib = ctypes.CDLL(_LIB)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.generate_scenarios.argtypes = [
        ctypes.c_uint64,  # base_seed
        ctypes.c_int32,  # batch
        ctypes.c_int32,  # n_threads
        ctypes.c_int32,  # path_kind
        ctypes.c_int32,  # n_path_points
        ctypes.c_int32,  # max_path_points
        ctypes.c_int32,  # n_agents
        ctypes.c_int32,  # n_valid
        ctypes.c_int32,  # h
        ctypes.c_int32,  # w
        ctypes.c_float,  # resolution
        ctypes.c_float,  # origin_x
        ctypes.c_float,  # origin_y
        ctypes.c_int32,  # with_obstacles
        f32p, f32p, i32p, f32p, f32p, f32p, f32p, f32p, i32p,
    ]
    lib.generate_scenarios.restype = None
    return lib


def _load():
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            _lib = _build_and_load(force=False)
        except (OSError, subprocess.CalledProcessError):
            _load_failed = True
        return _lib


def require_native():
    """Build the generator from its committed sources on THIS machine and
    load it, raising if the build fails — for the measurement paths
    (bench.py, chip_smoke.py), which must not reuse a library built
    elsewhere nor silently switch to the slower NumPy generator."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                _lib = _build_and_load(force=True)
            except subprocess.CalledProcessError as e:
                raise RuntimeError(
                    "building the native scenario generator failed:\n"
                    + e.stderr.decode(errors="replace")
                ) from e
        return _lib


def native_available() -> bool:
    return _load() is not None


def generate_scenario_batch(
    cfg,
    batch: int,
    base_seed: int = 0,
    n_valid_people: int = 3,
    path_kind: str = "sine",
    n_path_points: int = 40,
    grid_hw=(120, 120),
    with_obstacles: bool = True,
    resolution: float = 0.05,
    origin=(-1.0, -3.0),
    n_threads: int = 0,
) -> Scenario:
    """Batched Scenario (NumPy, batch-leading) via the native generator;
    falls back to utils.scenarios.make_scenario_batch without a compiler."""
    lib = _load()
    if lib is None:
        from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario_batch

        return make_scenario_batch(
            cfg,
            batch,
            base_seed=base_seed,
            n_valid_people=n_valid_people,
            path_kind=path_kind,
            n_path_points=n_path_points,
            grid_hw=grid_hw,
            with_obstacles=with_obstacles,
        )

    # Same windowing-exactness hard check as the NumPy generator
    # (core/validate.py): fail at scenario-construction time, not silently
    # inside a jitted batch.
    from nav2_social_mpc_controller_tpu.core.validate import validate_scenario_windows

    validate_scenario_windows(cfg, resolution, resolution)

    h, w = grid_hw
    p = cfg.max_path_points
    n_agents = cfg.n_agents
    path_points = np.empty((batch, p, 2), np.float32)
    path_yaw = np.empty((batch, p), np.float32)
    path_n = np.empty((batch,), np.int32)
    robot_pose = np.empty((batch, 3), np.float32)
    robot_speed = np.empty((batch, 2), np.float32)
    people = np.empty((batch, n_agents, 6), np.float32)
    costmap = np.empty((batch, h, w), np.float32)
    esdf_dist = np.empty((batch, h, w), np.float32)
    esdf_idx = np.empty((batch, h, w), np.int32)

    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.generate_scenarios(
        np.uint64(base_seed),
        np.int32(batch),
        np.int32(n_threads),
        np.int32(_PATH_KINDS[path_kind]),
        np.int32(n_path_points),
        np.int32(p),
        np.int32(n_agents),
        np.int32(min(n_valid_people, n_agents)),
        np.int32(h),
        np.int32(w),
        np.float32(resolution),
        np.float32(origin[0]),
        np.float32(origin[1]),
        np.int32(1 if with_obstacles else 0),
        path_points.ctypes.data_as(f32p),
        path_yaw.ctypes.data_as(f32p),
        path_n.ctypes.data_as(i32p),
        robot_pose.ctypes.data_as(f32p),
        robot_speed.ctypes.data_as(f32p),
        people.ctypes.data_as(f32p),
        costmap.ctypes.data_as(f32p),
        esdf_dist.ctypes.data_as(f32p),
        esdf_idx.ctypes.data_as(i32p),
    )

    origin_arr = np.tile(np.asarray(origin, np.float32), (batch, 1))
    res_arr = np.full((batch,), resolution, np.float32)
    valid = np.full((batch,), not (h == 100 and w == 100))
    return Scenario(
        path=PathInput(points=path_points, yaw=path_yaw, n=path_n),
        robot=RobotState(pose=robot_pose, speed=robot_speed),
        people=AgentsState(state=people),
        costmap=Costmap(data=costmap, origin=origin_arr, resolution=res_arr),
        esdf=ObstacleDistanceGrid(
            distances=esdf_dist,
            indexes=esdf_idx,
            origin=origin_arr,
            resolution=res_arr,
            valid=valid,
        ),
    )
