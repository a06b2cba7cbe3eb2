"""Core pytree types for the batched social-MPC framework.

Reference mapping (see SURVEY.md section 2):
  AgentsState             <- AgentStatus / AgentsStates (tools/type_definitions.hpp:6-9)
                             6-vector per agent: x, y, yaw, t, linear vel, angular vel;
                             t == -1 marks an invalid/padded agent (optimizer.cpp:470-473)
  Costmap                 <- nav2_costmap_2d::Costmap2D char map + ceres::Grid2D
                             (optimizer.cpp:167-170)
  ObstacleDistanceGrid    <- obstacle_distance_msgs::ObstacleDistance: per-cell distance
                             to nearest obstacle + flat index of that obstacle cell
                             (obstacle_distance_interface.hpp, optimizer.cpp:673-728)
  PathInput               <- nav_msgs::Path (padded, masked for static shapes)
  ControllerCarry         <- TrajectoryMemory singleton (trajectory_memory.hpp:32-49),
                             made an explicit functional carry
  Scenario                <- the full per-tick world input of computeVelocityCommands
                             (social_mpc_controller.cpp:162-257)

All fields are arrays (or nested pytrees of arrays) so every type vmaps over a
leading scenario-batch axis unchanged. Shapes are static; variable-length data
uses validity masks / counts, exactly as the reference pads agents to a fixed
count with t=-1.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

# AgentsState state-vector component indices (tools/type_definitions.hpp:6)
AGENT_X = 0
AGENT_Y = 1
AGENT_YAW = 2
AGENT_T = 3  # timestamp; -1.0 == invalid agent
AGENT_LV = 4  # linear velocity magnitude
AGENT_AV = 5  # angular velocity


class AgentsState(NamedTuple):
    """States of N agents at one instant: array (N, 6) [x, y, yaw, t, lv, av]."""

    state: jnp.ndarray  # (..., N, 6)

    @property
    def valid(self):
        """Validity mask: agent is real iff t != -1 (optimizer.cpp:470-473)."""
        return self.state[..., AGENT_T] != -1.0

    @staticmethod
    def invalid(n_agents: int, dtype=jnp.float32) -> "AgentsState":
        s = np.zeros((n_agents, 6), dtype=dtype)
        s[:, AGENT_T] = -1.0
        return AgentsState(state=jnp.asarray(s))


class RobotState(NamedTuple):
    """Robot pose + measured body twist at tick start.

    pose:  (3,) [x, y, yaw] in the planning frame
    speed: (2,) [linear, angular] (geometry_msgs::Twist input of optimize(),
           optimizer.cpp:152 / format_to_optimize i==0 branch :533-535)
    """

    pose: jnp.ndarray  # (..., 3)
    speed: jnp.ndarray  # (..., 2)


class PathInput(NamedTuple):
    """A (padded) geometric plan in the planning frame.

    points: (P, 2) x/y; yaw: (P,); valid: (P,) bool; n: () int32 count.
    Positions beyond n hold the last valid pose (safe padding for gathers).
    """

    points: jnp.ndarray  # (..., P, 2)
    yaw: jnp.ndarray  # (..., P)
    n: jnp.ndarray  # (...,) int32

    @property
    def valid(self):
        idx = jnp.arange(self.points.shape[-2])
        return idx < self.n[..., None]


class Costmap(NamedTuple):
    """Dense 2D costmap (values 0..255 like the nav2 char map) + geometry.

    data is float32 for direct use by the bicubic sampler
    (ceres::Grid2D<u_char> + BiCubicInterpolator, optimizer.cpp:167-170).
    origin: (2,) world coords of cell (0,0) corner; resolution: () m/cell.
    """

    data: jnp.ndarray  # (..., H, W) float32
    origin: jnp.ndarray  # (..., 2)
    resolution: jnp.ndarray  # (...,)


class ObstacleDistanceGrid(NamedTuple):
    """ESDF-like grid from the obstacle_distance_manager
    (obstacle_distance_interface.hpp:19-47).

    distances: (H, W) distance to nearest obstacle [m]
    indexes:   (H, W) int32 flat index (x + y*W) of the nearest obstacle cell
    origin:    (2,) world coords; resolution: () m/cell
    valid:     () bool — False replicates the reference's 100x100 sentinel
               check that disables people projection (optimizer.cpp:598-603)
    """

    distances: jnp.ndarray  # (..., H, W)
    indexes: jnp.ndarray  # (..., H, W) int32
    origin: jnp.ndarray  # (..., 2)
    resolution: jnp.ndarray  # (...,)
    valid: jnp.ndarray  # (...,) bool


class Scenario(NamedTuple):
    """Everything computeVelocityCommands consumes in one control tick
    (social_mpc_controller.cpp:162-257): plan, robot, people, grids."""

    path: PathInput
    robot: RobotState
    people: AgentsState
    costmap: Costmap
    esdf: ObstacleDistanceGrid


class ControllerCarry(NamedTuple):
    """Warm-start memory carried across ticks (TrajectoryMemory,
    trajectory_memory.hpp:32-49 + optimizer.cpp:174-186,448-449), plus the
    plan-advance cursor (PathHandler's stored-plan erase,
    path_handler.cpp:100, as an in-graph index so batched/scanned fleets
    prune without host round-trips).

    prev_path:  (S+1, 3) poses [x, y, yaw] of the previous optimized path
    prev_cmds:  (S+1, 2) previous optimized (v, w) commands
    prev_n:     () int32 valid count; 0 == no previous solution yet
    plan_start: () int32 cumulative prune point into the scenario's plan —
                the poses the reference would have erased by now. Reset to 0
                when a new plan is installed (setPlan replaces the stored
                plan, path_handler.cpp:110-113).
    """

    prev_path: jnp.ndarray
    prev_cmds: jnp.ndarray
    prev_n: jnp.ndarray
    plan_start: jnp.ndarray = np.int32(0)

    @staticmethod
    def zero(horizon_steps: int, dtype=jnp.float32) -> "ControllerCarry":
        return ControllerCarry(
            prev_path=jnp.zeros((horizon_steps + 1, 3), dtype=dtype),
            prev_cmds=jnp.zeros((horizon_steps + 1, 2), dtype=dtype),
            prev_n=jnp.zeros((), dtype=jnp.int32),
            plan_start=jnp.zeros((), dtype=jnp.int32),
        )


class ControlCommand(NamedTuple):
    """The tick output: body twist command (TwistStamped,
    social_mpc_controller.cpp:250-256; linear.y forced to 0)."""

    linear_x: jnp.ndarray
    linear_y: jnp.ndarray
    angular_z: jnp.ndarray


# Per-scenario status codes of the failure ladder (SURVEY.md section 5.3)
STATUS_OK = 0  # optimized solution returned
STATUS_FALLBACK_CMDS = 1  # solve unusable -> trajectorizer cmds (optimizer.cpp:384-388)
STATUS_FALLBACK_CRAWL = 2  # trajectorize failed -> crawl cmd 0.1 m/s
#                           (social_mpc_controller.cpp:180-189)
STATUS_INVALID_INPUT = 3  # path < 2 poses (optimizer.cpp:158-162)


class SolveStats(NamedTuple):
    """Per-scenario solver telemetry (aux output; reference only exposes
    Ceres' BriefReport at DEBUG, optimizer.cpp:382)."""

    iterations: jnp.ndarray  # () int32 LM iterations executed
    initial_cost: jnp.ndarray  # ()
    final_cost: jnp.ndarray  # ()
    termination: jnp.ndarray  # () int32, see solver.lm.TERM_*
    usable: jnp.ndarray  # () bool — IsSolutionUsable analogue


class StepAux(NamedTuple):
    """Debug/telemetry outputs of one controller step, mirroring the debug
    publishers (local_plan, people_projected_trajectory,
    trajectorized_global_plan; social_mpc_controller.cpp:83-85)."""

    local_path: jnp.ndarray  # (S+1, 3) optimized path poses
    ref_path: jnp.ndarray  # (S+1, 3) trajectorized reference path
    cmds: jnp.ndarray  # (S+1, 2) full optimized command sequence
    people_proj: jnp.ndarray  # (S+1, N, 6) projected people trajectories
    status: jnp.ndarray  # () int32, STATUS_*
    solve: SolveStats
    plan_start_index: jnp.ndarray  # () int32 — the CUMULATIVE prune point
    #   into the scenario's plan (the poses the reference would have erased
    #   by now, path_handler.cpp:100). The same value is carried forward as
    #   ControllerCarry.plan_start, so pruning happens in-graph; hosts that
    #   physically shrink their plan buffer (prune_plan) must reset the
    #   cursor when installing the shrunk plan (set_plan does).
    lm_trace: object = None  # solver.lm.LMTrace per-iteration telemetry when
    #   optimizer.debug_optimizer is set (Ceres PER_MINIMIZER_ITERATION
    #   analogue, optimizer.cpp:122-130); None otherwise.
