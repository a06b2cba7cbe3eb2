"""The per-tick optimization pipeline: warm-start blending, people
projection, residual assembly over the shared rollout, batched LM solve, and
command/path extraction.

Reference parity target: Optimizer::optimize (optimizer.cpp:148-452) and its
helpers format_to_optimize (:484-551) and the post-solve extraction
(:390-446). Structure inverted for batching (SURVEY.md section 7): instead of a
Ceres problem object holding ~8 residual blocks x H steps that each
re-integrate the rollout, we build ONE residual vector function u -> r(u)
whose evaluation shares a single lax.scan rollout; jacfwd gives the (R, 2B)
Jacobian with 2B tangent passes.

Shape/static-ness notes:
  * maxsize = round(max_time/time_step) (optimizer.cpp:492) is static; the
    row buffer is (maxsize, 6) and the step axis S = maxsize - 1.
  * The reference shrinks control_horizon/block_length dynamically to the
    velocity count when the path is shorter (optimizer.cpp:248-249). The
    decision-variable buffer stays static (n_blocks from config) but the
    step->block map, horizon gating, bounds, and extraction all use the
    dynamic (traced) horizon, reproducing the shrink exactly; unused
    trailing blocks keep their warm-start value and receive no gradient.
  * Truncation quirk preserved: a path longer than maxsize keeps only the
    first maxsize-1 poses (optimizer.cpp:493-497).
"""

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from nav2_social_mpc_controller_tpu.core.config import SocialMPCConfig
from nav2_social_mpc_controller_tpu.core.validate import check_obstacle_window
from nav2_social_mpc_controller_tpu.core.types import (
    AgentsState,
    ControllerCarry,
    Costmap,
    ObstacleDistanceGrid,
    SolveStats,
)
from nav2_social_mpc_controller_tpu.costs import critics
from nav2_social_mpc_controller_tpu.models.motion import (
    block_index_sequence_dynamic,
    expand_blocks,
    rollout_poses,
)
from nav2_social_mpc_controller_tpu.models.sfm import project_people
from nav2_social_mpc_controller_tpu.ops import fused_iter
from nav2_social_mpc_controller_tpu.solver.lm import LMConfig, lm_solve
from nav2_social_mpc_controller_tpu.world.grid import crop_grid_window


@dataclasses.dataclass(frozen=True)
class ProblemDims:
    """Static problem geometry derived from config."""

    maxsize: int  # max optimization rows (poses)
    s: int  # max velocity steps = maxsize - 1
    horizon: int  # static control horizon (clamped to s)
    block_length: int
    n_blocks: int
    n_vf: int  # velocity-feasibility pair count

    @staticmethod
    def from_config(cfg: SocialMPCConfig) -> "ProblemDims":
        maxsize = cfg.trajectorizer.max_steps
        s = maxsize - 1
        h = min(cfg.optimizer.control_horizon, s)
        bl = min(cfg.optimizer.parameter_block_length, h)
        return ProblemDims(
            maxsize=maxsize,
            s=s,
            horizon=h,
            block_length=bl,
            n_blocks=-(-h // bl),
            n_vf=max(0, h // bl - 1),
        )


class OptimizeResult(NamedTuple):
    ok: jnp.ndarray  # () bool — usable solution (IsSolutionUsable analogue)
    cmds: jnp.ndarray  # (maxsize, 2) optimized [v, w] per step
    path: jnp.ndarray  # (maxsize, 3) re-integrated poses
    n: jnp.ndarray  # () int32 valid cmd/pose count
    people_proj: jnp.ndarray  # (maxsize, N, 6)
    stats: SolveStats
    u: jnp.ndarray  # (B, 2) optimized decision blocks
    lm_trace: object = None  # LMTrace when cfg.optimizer.debug_optimizer


def format_to_optimize(
    cfg: SocialMPCConfig,
    dims: ProblemDims,
    ref_poses: jnp.ndarray,  # (max_steps + 1, 3) trajectorizer output
    ref_cmds: jnp.ndarray,  # (max_steps, 3) [vx, vy, wz]
    n_traj_steps: jnp.ndarray,  # () int32
    speed: jnp.ndarray,  # (2,) [v, w] measured
    carry: ControllerCarry,
):
    """Blend current and previous tick's trajectories into the optimization
    rows [x, y, yaw, t, v, w] (optimizer.cpp:484-551).

    Returns (rows (maxsize, 6), n_rows ())."""
    maxsize = dims.maxsize
    n_poses = n_traj_steps + 1
    n_rows = jnp.where(n_poses > maxsize, maxsize - 1, n_poses).astype(jnp.int32)

    i = jnp.arange(maxsize)
    pose_i = ref_poses[i]  # (maxsize, 3); i <= maxsize-1 <= max_steps
    cpw = cfg.optimizer.current_path_weight
    ccw = cfg.optimizer.current_cmds_weight

    has_prev = carry.prev_n > 0
    blend_pose = has_prev & (i < carry.prev_n)
    prev_pose = carry.prev_path[jnp.clip(i, 0, carry.prev_path.shape[0] - 1)]
    xy = jnp.where(
        blend_pose[:, None],
        cpw * pose_i[:, 0:2] + (1.0 - cpw) * prev_pose[:, 0:2],
        pose_i[:, 0:2],
    )
    # Raw linear yaw blend, as in the reference (optimizer.cpp:514-516)
    yaw = jnp.where(blend_pose, cpw * pose_i[:, 2] + (1.0 - cpw) * prev_pose[:, 2], pose_i[:, 2])

    t = i.astype(xy.dtype) * cfg.trajectorizer.time_step

    cmd_prev_idx = jnp.clip(i - 1, 0, ref_cmds.shape[0] - 1)
    cur_cmd = ref_cmds[cmd_prev_idx][:, jnp.array([0, 2])]  # (v = linear.x, w = angular.z)
    blend_cmd = has_prev & ((i - 1) < carry.prev_n)
    prev_cmd = carry.prev_cmds[jnp.clip(i - 1, 0, carry.prev_cmds.shape[0] - 1)]
    vw = jnp.where(
        blend_cmd[:, None], ccw * cur_cmd + (1.0 - ccw) * prev_cmd, cur_cmd
    )
    vw = jnp.where((i == 0)[:, None], jnp.broadcast_to(speed, vw.shape), vw)

    rows = jnp.concatenate([xy, yaw[:, None], t[:, None], vw], axis=-1)

    # Hold the last valid row in the padding for safe downstream gathers.
    last = jnp.clip(n_rows - 1, 0, maxsize - 1)
    rows = jnp.where((i < n_rows)[:, None], rows, rows[last][None, :])
    return rows, n_rows


def build_residual_fn(
    cfg: SocialMPCConfig,
    dims: ProblemDims,
    rows: jnp.ndarray,  # (maxsize, 6)
    n_rows: jnp.ndarray,  # ()
    people_proj: jnp.ndarray,  # (maxsize, N, 6)
    people_present: jnp.ndarray,  # () bool
    costmap: Costmap,
):
    """Return residual_fn(u_flat (2B,)) -> (R,), closing over scenario data.

    Residual layout: [social_work, agent_angle, proxemics, velocity,
    goal_align, path_follow, path_align, obstacle] x S steps + n_vf
    velocity-feasibility terms (+ optional latent critics)."""
    # Coerce grid data to device arrays: the residual closure is traced
    # inside the LM while_loop, where numpy grids cannot be indexed by
    # traced rollout positions.
    costmap = Costmap(
        data=jnp.asarray(costmap.data),
        origin=jnp.asarray(costmap.origin),
        resolution=jnp.asarray(costmap.resolution),
    )
    # Rolling-window crop around pose_0 (once per tick, outside the LM loop)
    # so the per-iteration obstacle stencil matmuls read a small window;
    # exact-output sizing rule in OptimizerConfig.obstacle_window_cells.
    # When the resolution is concrete (host-side/f64 callers), a window below
    # the exactness bound falls back to the full grid with a warning; traced
    # callers are guarded at the host boundary (core/validate.py).
    if check_obstacle_window(cfg, costmap.resolution):
        win_data, win_origin = crop_grid_window(
            costmap.data,
            costmap.origin,
            costmap.resolution,
            rows[0, 0:2],
            cfg.optimizer.obstacle_window_cells,
        )
        costmap = Costmap(data=win_data, origin=win_origin, resolution=costmap.resolution)
    w = cfg.optimizer.weights
    dt = cfg.trajectorizer.time_step
    s = dims.s

    pose0 = rows[0, 0:3]
    n_vel = n_rows - 1
    # Dynamic horizon shrink near the goal: control_horizon = min(cfg, n_vel),
    # block_length = min(cfg, control_horizon) (optimizer.cpp:248-249).
    h_dyn = jnp.maximum(jnp.minimum(dims.horizon, n_vel), 1)
    bl_dyn = jnp.maximum(jnp.minimum(dims.block_length, h_dyn), 1)
    block_idx = block_index_sequence_dynamic(s, h_dyn, bl_dyn)
    in_horizon = jnp.arange(s) < h_dyn

    step_mask = jnp.arange(s) < n_vel
    social_mask = step_mask & people_present
    last = jnp.clip(n_rows - 1, 0, dims.maxsize - 1)
    final_point = rows[last, 0:2]
    goal_yaw = rows[last, 2]
    ref_points = rows[1:, 0:2]  # (s, 2) path-align targets (point i+1)
    agents_steps = people_proj[1:]  # (s, N, 6)

    def residual_fn(u_flat):
        u = u_flat.reshape(dims.n_blocks, 2)
        poses = rollout_poses(pose0, u, dt, block_idx)  # (s+1, 3)
        new_pos = poses[1:, 0:2]
        new_yaw = poses[1:, 2]
        vw_steps = expand_blocks(u, block_idx)  # (s, 2)

        parts = []

        def add(r, mask):
            parts.append(jnp.where(mask, r, 0.0))

        add(
            critics.social_work_cost(w.social_weight, new_pos, new_yaw, vw_steps, agents_steps),
            social_mask,
        )
        add(critics.agent_angle_cost(w.agent_angle_weight, new_yaw, pose0, agents_steps), social_mask)
        add(critics.proxemics_cost(w.proxemics_weight, new_pos, agents_steps), social_mask)
        add(
            critics.velocity_cost(
                w.velocity_weight, cfg.optimizer.desired_linear_vel, vw_steps[:, 0], in_horizon
            ),
            step_mask,
        )
        add(critics.goal_align_cost(w.goal_align_weight, goal_yaw, new_yaw), step_mask)
        add(critics.distance_cost(w.distance_weight, new_pos, final_point), step_mask)
        add(critics.distance_cost(w.angle_weight, new_pos, ref_points), step_mask)
        add(
            critics.obstacle_cost(
                w.obstacle_weight, poses[1:], costmap.data, costmap.origin, costmap.resolution
            ),
            step_mask,
        )
        if w.pure_angle_weight != 0.0:
            add(critics.angle_cost(w.pure_angle_weight, new_pos, new_yaw, final_point), step_mask)
        if w.curvature_weight != 0.0:
            add(
                critics.curvature_cost(
                    w.curvature_weight, w.curvature_max_angle, poses[:-2, 0:2], poses[1:-1, 0:2], poses[2:, 0:2]
                ),
                step_mask[: s - 2] if s >= 2 else step_mask[:0],
            )

        vf = critics.velocity_feasibility_cost(w.velocity_feasibility_weight, u, dims.n_vf)
        # Added for steps 0 < i < control_horizon/block_length (and i within
        # the velocity count), optimizer.cpp:364-370; pair q is step i = q+1.
        vf_step = jnp.arange(dims.n_vf) + 1
        vf_mask = (vf_step < (h_dyn // bl_dyn)) & (vf_step < n_vel)
        parts.append(jnp.where(vf_mask, vf, 0.0))

        return jnp.concatenate(parts)

    return residual_fn


class PreparedProblem(NamedTuple):
    """Everything the LM solve consumes, produced by optimize_prepare: the
    per-lane problem data (operands of ops.fused_iter.make_value_grad_op)
    plus the warm-started decision vector and its box bounds. Factored out
    so the compacted batched solver (solver/batched.py) can gather/scatter
    problems alongside solver state."""

    rows: jnp.ndarray  # (maxsize, 6)
    n_rows: jnp.ndarray  # ()
    people_proj: jnp.ndarray  # (maxsize, N, 6)
    people_present: jnp.ndarray  # () bool
    costmap: Costmap
    u0: jnp.ndarray  # (2B,) clipped warm start
    lower: jnp.ndarray  # (2B,)
    upper: jnp.ndarray  # (2B,)


def optimize(
    cfg: SocialMPCConfig,
    ref_poses: jnp.ndarray,
    ref_cmds: jnp.ndarray,
    n_traj_steps: jnp.ndarray,
    speed: jnp.ndarray,
    people: AgentsState,
    costmap: Costmap,
    esdf: ObstacleDistanceGrid,
    carry: ControllerCarry,
) -> OptimizeResult:
    """The full Optimizer::optimize pipeline (optimizer.cpp:148-452)."""
    prep = optimize_prepare(
        cfg, ref_poses, ref_cmds, n_traj_steps, speed, people, costmap, esdf, carry
    )
    dims = ProblemDims.from_config(cfg)

    u_flat, stats, lm_trace = solve_prepared(cfg, prep)
    return optimize_finish(cfg, prep, u_flat, stats, lm_trace)


def solve_prepared(cfg: SocialMPCConfig, prep: "PreparedProblem"):
    """Per-lane LM solve of a PreparedProblem (the ceres::Solve call,
    optimizer.cpp:381). Returns (u_flat, SolveStats, lm_trace|None)."""
    dims = ProblemDims.from_config(cfg)
    residual_fn = build_residual_fn(
        cfg, dims, prep.rows, prep.n_rows, prep.people_proj, prep.people_present,
        prep.costmap,
    )

    # Analytic LM value-and-gradient (ops/fused_iter.py): residual+Jacobian
    # -> (cost, g, JtJ) on the batched f32 path; the custom_vmap op keeps
    # THIS path (linearize over residual_fn) for single-lane / f64
    # execution, so parity suites pin both.
    value_grad_fn = None
    if fused_iter.can_fuse(cfg):
        value_grad_fn = fused_iter.build_value_grad(
            cfg, dims, prep.rows, prep.n_rows, prep.people_proj,
            prep.people_present, prep.costmap,
        )

    opt = cfg.optimizer
    lm_cfg = make_lm_config(opt)
    # debug_optimizer (optimizer.cpp:122-130): per-iteration (cost, radius,
    # rho, accepted, ...) trace as a fixed-length aux array.
    lm_trace = None
    if opt.debug_optimizer:
        u_flat, stats, lm_trace = lm_solve(
            residual_fn, prep.u0, prep.lower, prep.upper, lm_cfg,
            trace_len=opt.max_iterations, value_grad_fn=value_grad_fn,
        )
    else:
        u_flat, stats = lm_solve(
            residual_fn, prep.u0, prep.lower, prep.upper, lm_cfg,
            value_grad_fn=value_grad_fn,
        )
    return u_flat, stats, lm_trace


def make_lm_config(opt) -> LMConfig:
    return LMConfig(
        max_iterations=opt.max_iterations,
        fn_tol=opt.fn_tol,
        gradient_tol=opt.gradient_tol,
        param_tol=opt.param_tol,
    )


def optimize_prepare(
    cfg: SocialMPCConfig,
    ref_poses: jnp.ndarray,
    ref_cmds: jnp.ndarray,
    n_traj_steps: jnp.ndarray,
    speed: jnp.ndarray,
    people: AgentsState,
    costmap: Costmap,
    esdf: ObstacleDistanceGrid,
    carry: ControllerCarry,
) -> PreparedProblem:
    """Problem assembly half of Optimizer::optimize (optimizer.cpp:148-379):
    warm-start blending, SFM people projection, decision-variable packing
    and box bounds."""
    dims = ProblemDims.from_config(cfg)
    dt = cfg.trajectorizer.time_step

    rows, n_rows = format_to_optimize(cfg, dims, ref_poses, ref_cmds, n_traj_steps, speed, carry)

    people_proj = project_people(
        people.state,
        rows,
        n_rows,
        esdf.distances,
        esdf.indexes,
        esdf.origin,
        esdf.resolution,
        esdf.valid,
        maxtime=cfg.trajectorizer.max_time,
        dt=dt,
        people_desired_vel=cfg.people_desired_vel,
        people_radius=cfg.people_radius,
        robot_desired_vel=cfg.robot_sfm_desired_vel,
        robot_radius=cfg.robot_sfm_radius,
        goal_radius=cfg.goal_radius,
        esdf_window=cfg.esdf_window_cells,
    )
    people_present = jnp.any(people.valid)

    # Warm start: block b initializes from optimization ROW b's velocity
    # (optimizer.cpp:256-260 — parameter_blocks point at
    # optim_velocities[block_used] = row-index storage), row 0 being the
    # measured speed.
    u0 = rows[0 : dims.n_blocks, 4:6]
    if cfg.optimizer.warm_start_mode == "previous_solution":
        # Framework extension (OptimizerConfig.warm_start_mode): start block
        # b from the previous tick's own block-b optimum. prev_cmds holds the
        # block-expanded commands, so the step at each block start carries
        # that block's value. Static indices -> no hot-path gather.
        starts = np.minimum(
            np.arange(dims.n_blocks) * dims.block_length, carry.prev_cmds.shape[0] - 1
        )
        u_prev = carry.prev_cmds[starts]  # (B, 2)
        u0 = jnp.where(carry.prev_n > 0, u_prev, u0)

    # Box bounds on the first control_horizon/block_length blocks
    # (optimizer.cpp:373-379, with the dynamic horizon shrink of :248-249);
    # any remainder block is unbounded.
    opt = cfg.optimizer
    n_vel = n_rows - 1
    h_dyn = jnp.maximum(jnp.minimum(dims.horizon, n_vel), 1)
    bl_dyn = jnp.maximum(jnp.minimum(dims.block_length, h_dyn), 1)
    bounded = jnp.arange(dims.n_blocks) < (h_dyn // bl_dyn)
    dtype = rows.dtype
    big = jnp.asarray(np.finfo(np.float32).max, dtype)
    lo_b = jnp.asarray([opt.v_min, opt.w_min], dtype)
    hi_b = jnp.asarray([opt.v_max, opt.w_max], dtype)
    lower = jnp.where(bounded[:, None], lo_b[None, :], -big).reshape(-1)
    upper = jnp.where(bounded[:, None], hi_b[None, :], big).reshape(-1)

    u0_clipped = jnp.clip(u0.reshape(-1), lower, upper)
    return PreparedProblem(
        rows=rows,
        n_rows=n_rows,
        people_proj=people_proj,
        people_present=people_present,
        costmap=costmap,
        u0=u0_clipped,
        lower=lower,
        upper=upper,
    )


def optimize_finish(
    cfg: SocialMPCConfig,
    prep: PreparedProblem,
    u_flat: jnp.ndarray,
    stats: SolveStats,
    lm_trace=None,
) -> OptimizeResult:
    """Extraction half of Optimizer::optimize: saving_velocities[j] = block
    min(j, H-1)//bl for j = 0..S (optimizer.cpp:390-419 incl. the
    post-horizon extrapolation), then the path is re-integrated from pose_0
    (:420-446)."""
    dims = ProblemDims.from_config(cfg)
    dt = cfg.trajectorizer.time_step
    rows, n_rows = prep.rows, prep.n_rows
    u = u_flat.reshape(dims.n_blocks, 2)

    n_vel = n_rows - 1
    h_dyn = jnp.maximum(jnp.minimum(dims.horizon, n_vel), 1)
    bl_dyn = jnp.maximum(jnp.minimum(dims.block_length, h_dyn), 1)
    ext_idx = block_index_sequence_dynamic(dims.s + 1, h_dyn, bl_dyn)
    cmds_out = expand_blocks(u, ext_idx)  # (maxsize, 2)
    path_out = rollout_poses(rows[0, 0:3], u, dt, ext_idx)[1:]  # (maxsize, 3)

    ok = stats.usable & (n_rows >= 2)
    return OptimizeResult(
        ok=ok,
        cmds=cmds_out,
        path=path_out,
        n=n_rows,
        people_proj=prep.people_proj,
        stats=stats,
        u=u,
        lm_trace=lm_trace,
    )
