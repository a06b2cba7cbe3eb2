"""Batched social-MPC trajectory optimization framework for accelerators.

A from-scratch re-design of the capabilities of the ROS 2 Nav2 plugin
``nav2_social_mpc_controller`` (reference: PIC4SeR/nav2_social_mpc_controller)
for batched accelerator execution: the per-tick Ceres Levenberg-Marquardt solve becomes a
batched, jitted Gauss-Newton/LM loop in JAX, the horizon rollout is a single
``lax.scan`` shared by all critics, the Social Force Model is a vmapped
pairwise kernel, and thousands of independent scenario solves batch per chip
and shard across a device mesh.

Layer map (mirrors reference SURVEY.md section 1):
  core/        types + config            (reference: params/*.yaml, tools/type_definitions.hpp)
  world/       grids: costmap bicubic sampling + ESDF  (obstacle_distance_interface)
  models/      motion models + social force model       (update_state.hpp, sfm.hpp)
  costs/       the critic library                       (critics/*)
  solver/      batched LM/GN solver                     (Ceres ceres::Solve)
  controller/  path handling, trajectorizer, step()     (social_mpc_controller.cpp)
  parallel/    mesh/sharding for multi-chip scale-out   (no reference equivalent)
  runtime/     host-side native helpers (C++ ESDF builder etc.)
"""

__version__ = "0.1.0"

from nav2_social_mpc_controller_tpu.core.config import (  # noqa: F401
    SocialMPCConfig,
    OptimizerConfig,
    TrajectorizerConfig,
    WeightsConfig,
    load_config_from_yaml,
)
from nav2_social_mpc_controller_tpu.core.types import (  # noqa: F401
    AgentsState,
    Costmap,
    ObstacleDistanceGrid,
    PathInput,
    RobotState,
    Scenario,
    ControllerCarry,
    ControlCommand,
    StepAux,
)
