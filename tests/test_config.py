"""Config tests: reference defaults, reference-format YAML loading, shape
derivations."""

import dataclasses
import math
import os

import pytest

from nav2_social_mpc_controller_tpu.core.config import (
    OptimizerConfig,
    SocialMPCConfig,
    TrajectorizerConfig,
    WeightsConfig,
    benchmark_social_config,
    load_config_from_yaml,
)


def test_reference_defaults():
    cfg = SocialMPCConfig()
    # social_mpc_controller.cpp:59-65
    assert cfg.desired_linear_vel == 0.5
    assert cfg.fov_angle == pytest.approx(math.pi / 4)
    # path_trajectorizer.cpp:52-59
    t = cfg.trajectorizer
    assert (t.omnidirectional, t.desired_linear_vel, t.lookahead_dist) == (False, 0.4, 0.4)
    assert (t.max_angular_vel, t.time_step, t.max_time) == (1.0, 0.05, 3.0)
    assert t.max_steps == 60
    # optimizer.cpp:26-83
    o = cfg.optimizer
    assert o.linear_solver_type == "SPARSE_NORMAL_CHOLESKY"
    assert (o.param_tol, o.fn_tol, o.gradient_tol) == (1e-15, 1e-7, 1e-10)
    assert (o.max_iterations, o.control_horizon, o.parameter_block_length) == (100, 5, 5)
    w = o.weights
    assert (w.distance_weight, w.social_weight, w.velocity_weight) == (3.0, 1.0, 0.5)
    assert (w.angle_weight, w.agent_angle_weight, w.proxemics_weight) == (0.0, 0.5, 90.0)
    assert (w.velocity_feasibility_weight, w.obstacle_weight, w.goal_align_weight) == (0.5, 0.0, 0.0)


def test_invalid_solver_type_rejected():
    with pytest.raises(ValueError, match="linear_solver_type"):
        OptimizerConfig(linear_solver_type="CONJUGATE_LLAMAS")


def test_benchmark_config_values():
    cfg = benchmark_social_config()
    assert cfg.optimizer.control_horizon == 18
    assert cfg.optimizer.parameter_block_length == 6
    assert cfg.n_blocks == 3
    assert cfg.optimizer.max_iterations == 40
    assert cfg.optimizer.weights.social_weight == 120.0
    assert cfg.trajectorizer.max_steps == 30


def test_yaml_loading_reference_format(tmp_path):
    y = tmp_path / "params.yaml"
    y.write_text(
        """
controller_server:
  ros__parameters:
    FollowPath:
      plugin: "nav2_social_mpc_controller::SocialMPCController"
      trajectorizer:
        omnidirectional: true
        desired_linear_vel: 0.6
        lookahead_dist: 2.0
        max_angular_vel: 1.4
        time_step: 0.05
        max_time: 1.5
      optimizer:
        linear_solver_type: "DENSE_SCHUR"
        param_tol: 1.0e-9
        fn_tol: 1.0e-5
        gradient_tol: 1.0e-8
        max_iterations: 40
        control_horizon: 18
        parameter_block_length: 6
        current_path_weight: 1.0
        current_cmds_weight: 0.5
        weights:
          distance_weight: 20.0
          social_weight: 120.0
          velocity_weight: 10.0
          angle_weight: 250.0
          agent_angle_weight: 40.0
          velocity_feasibility_weight: 5.0
          goal_align_weight: 10.0
          obstacle_weight: 0.13
"""
    )
    cfg = load_config_from_yaml(str(y))
    assert cfg.trajectorizer.omnidirectional is True
    assert cfg.optimizer.linear_solver_type == "DENSE_SCHUR"
    assert cfg.optimizer.weights.angle_weight == 250.0
    assert cfg.optimizer.current_cmds_weight == 0.5
    assert cfg.optimizer.max_iterations == 40


@pytest.mark.skipif(
    not os.path.exists("/root/reference/params/soc_work_obst_parameters_in_benchmark.yaml"),
    reason="reference tree not mounted",
)
def test_loads_actual_reference_yaml_verbatim():
    cfg = load_config_from_yaml(
        "/root/reference/params/soc_work_obst_parameters_in_benchmark.yaml"
    )
    bench = benchmark_social_config()
    # The reference YAML has no performance-only knobs; normalize them
    # before comparing the reference-visible parameter surface.
    assert cfg.optimizer == dataclasses.replace(bench.optimizer, obstacle_window_cells=0)
    assert cfg.trajectorizer == bench.trajectorizer
