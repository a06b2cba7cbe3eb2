"""Controller facade: the per-tick pure step function and a stateful host
wrapper mirroring the nav2_core::Controller lifecycle API.

Reference parity target: SocialMPCController (social_mpc_controller.cpp).
The 20 Hz computeVelocityCommands orchestration (:162-257) becomes a pure
jitted function

    step(scenario, carry) -> (cmd, aux, carry')

with the warm-start memory (TrajectoryMemory singleton) as an explicit carry
and the degradation ladder (SURVEY.md section 5.3) as per-scenario status
codes. ``make_step_batch`` vmaps it over a leading scenario axis — the
framework's workhorse entry point (thousands of independent solves per chip).
"""

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from nav2_social_mpc_controller_tpu.core.config import SocialMPCConfig
from nav2_social_mpc_controller_tpu.core.types import (
    AGENT_T,
    AgentsState,
    ControlCommand,
    ControllerCarry,
    Scenario,
    StepAux,
    STATUS_FALLBACK_CMDS,
    STATUS_FALLBACK_CRAWL,
    STATUS_OK,
)
from nav2_social_mpc_controller_tpu.controller.optimize import (
    PreparedProblem,
    ProblemDims,
    make_lm_config,
    optimize_finish,
    optimize_prepare,
    solve_prepared,
)
from nav2_social_mpc_controller_tpu.controller.path_handler import transform_global_plan
from nav2_social_mpc_controller_tpu.controller.trajectorizer import trajectorize
from nav2_social_mpc_controller_tpu.utils.angles import shortest_angular_distance

CRAWL_LINEAR_VEL = 0.1  # fallback cmd (social_mpc_controller.cpp:183)


def fov_filter(cfg: SocialMPCConfig, people: AgentsState, robot_pose, costmap) -> AgentsState:
    """Keep people inside the costmap and within the field-of-view cone
    (social_mpc_controller.cpp:197-215); others become invalid (t = -1)."""
    st = people.state
    px, py = st[..., 0], st[..., 1]

    h, w = costmap.data.shape[-2], costmap.data.shape[-1]
    ox, oy = costmap.origin[0], costmap.origin[1]
    res = costmap.resolution
    # Costmap2D::worldToMap: false if wx < origin or cell >= size
    in_map = (
        (px >= ox)
        & (py >= oy)
        & (((px - ox) / res) < w)
        & (((py - oy) / res) < h)
    )

    angle_to_person = jnp.arctan2(py - robot_pose[1], px - robot_pose[0])
    rel = shortest_angular_distance(robot_pose[2], angle_to_person)
    keep = people.valid & in_map & (jnp.abs(rel) < cfg.fov_angle)

    new_state = jnp.where(keep[..., None], st, jnp.zeros_like(st).at[..., AGENT_T].set(-1.0))
    return AgentsState(state=new_state)


def prune_plan(path, start: int):
    """Erase the first `start` poses from a (host-side) plan, keeping the
    static buffer shape: remaining poses shift to the front, the tail holds
    the last valid pose, and the count shrinks (path_handler.cpp:100 erases
    plan_.poses.begin()..transformation_begin from the stored plan)."""
    import numpy as np

    start = int(start)
    n = int(path.n)
    if start <= 0 or n <= 0:
        return path
    start = min(start, n - 1)  # never erase the whole plan
    p = path.points.shape[0]
    n_new = n - start
    src = np.minimum(start + np.arange(p), start + n_new - 1)
    src = np.clip(src, 0, p - 1)
    return path._replace(
        points=np.asarray(path.points)[src],
        yaw=np.asarray(path.yaw)[src],
        n=np.int32(n_new),
    )


def make_carry(cfg: SocialMPCConfig, dtype=jnp.float32) -> ControllerCarry:
    """Fresh warm-start memory sized for this config."""
    dims = ProblemDims.from_config(cfg)
    return ControllerCarry(
        prev_path=jnp.zeros((dims.maxsize, 3), dtype),
        prev_cmds=jnp.zeros((dims.maxsize, 2), dtype),
        prev_n=jnp.zeros((), jnp.int32),
        plan_start=jnp.zeros((), jnp.int32),
    )


class StepContext(NamedTuple):
    """Pre-solve state of one control tick: the prepared LM problem plus the
    trajectorizer outputs and plan cursor the post-solve half consumes.
    Produced by step_pre, consumed by step_post — the split exists so the
    compacted batched pipeline (make_step_batch_compacted) can run ONE
    explicitly-batched solver between vmapped halves while the per-lane
    `step` keeps the identical code path."""

    prep: PreparedProblem
    traj_ok: jnp.ndarray
    traj_poses: jnp.ndarray
    traj_cmds: jnp.ndarray
    traj_n_steps: jnp.ndarray
    plan_start_index: jnp.ndarray


def step_pre(cfg: SocialMPCConfig, scenario: Scenario, carry: ControllerCarry) -> StepContext:
    """Tick head: plan windowing -> trajectorize -> FOV filter -> problem
    assembly (computeVelocityCommands up to the ceres::Solve call)."""
    robot_pose = scenario.robot.pose

    # --- plan windowing (path_handler.cpp:40-108) ---
    h, w = scenario.costmap.data.shape[-2:]
    size_x = w * scenario.costmap.resolution
    size_y = h * scenario.costmap.resolution
    dist_threshold = jnp.maximum(size_x, size_y) / 2.0
    windowed = transform_global_plan(
        scenario.path,
        robot_pose,
        cfg.max_robot_pose_search_dist,
        dist_threshold,
        start=carry.plan_start,
    )

    # --- reference trajectory (path_trajectorizer.cpp:120-288) ---
    traj = trajectorize(cfg.trajectorizer, windowed.path, robot_pose)

    # --- people FOV filter (social_mpc_controller.cpp:197-215) ---
    people = fov_filter(cfg, scenario.people, robot_pose, scenario.costmap)

    prep = optimize_prepare(
        cfg,
        traj.poses,
        traj.cmds,
        traj.n_steps,
        scenario.robot.speed,
        people,
        scenario.costmap,
        scenario.esdf,
        carry,
    )
    return StepContext(
        prep=prep,
        traj_ok=traj.ok,
        traj_poses=traj.poses,
        traj_cmds=traj.cmds,
        traj_n_steps=traj.n_steps,
        plan_start_index=windowed.start_index,
    )


def step(cfg: SocialMPCConfig, scenario: Scenario, carry: ControllerCarry):
    """One control tick (computeVelocityCommands, social_mpc_controller.cpp:162-257).

    Returns (ControlCommand, StepAux, ControllerCarry)."""
    ctx = step_pre(cfg, scenario, carry)
    u_flat, stats, lm_trace = solve_prepared(cfg, ctx.prep)
    return step_post(cfg, ctx, carry, u_flat, stats, lm_trace)


def step_post(cfg: SocialMPCConfig, ctx: StepContext, carry: ControllerCarry,
              u_flat, stats, lm_trace=None):
    """Tick tail: extraction, degradation ladder, warm-start carry update."""
    res = optimize_finish(cfg, ctx.prep, u_flat, stats, lm_trace)

    class _Traj(NamedTuple):
        ok: jnp.ndarray
        poses: jnp.ndarray
        cmds: jnp.ndarray
        n_steps: jnp.ndarray

    traj = _Traj(ok=ctx.traj_ok, poses=ctx.traj_poses, cmds=ctx.traj_cmds,
                 n_steps=ctx.traj_n_steps)

    class _Windowed(NamedTuple):
        start_index: jnp.ndarray

    windowed = _Windowed(start_index=ctx.plan_start_index)

    # --- command selection / degradation ladder ---
    opt_v = res.cmds[0, 0]
    opt_w = res.cmds[0, 1]
    init_v = traj.cmds[0, 0]
    init_w = traj.cmds[0, 2]

    use_opt = traj.ok & res.ok
    use_init = traj.ok & ~res.ok

    linear_x = jnp.where(use_opt, opt_v, jnp.where(use_init, init_v, CRAWL_LINEAR_VEL))
    angular_z = jnp.where(use_opt, opt_w, jnp.where(use_init, init_w, 0.0))
    # linear.y forced to zero in the published command (:252-255)
    cmd = ControlCommand(
        linear_x=linear_x, linear_y=jnp.zeros_like(linear_x), angular_z=angular_z
    )

    status = jnp.where(
        use_opt, STATUS_OK, jnp.where(use_init, STATUS_FALLBACK_CMDS, STATUS_FALLBACK_CRAWL)
    ).astype(jnp.int32)

    # --- warm-start memory update (optimizer.cpp:174-186, 448-449) ---
    dims = ProblemDims.from_config(cfg)
    # First-tick seeding with the trajectorized path/cmds (truncated to the
    # carry buffer) even if the solve then fails:
    seed_n = jnp.minimum(traj.n_steps + 1, dims.maxsize)
    seeded = ControllerCarry(
        prev_path=traj.poses[: dims.maxsize],
        prev_cmds=traj.cmds[: dims.maxsize][:, jnp.array([0, 2])],
        prev_n=seed_n.astype(jnp.int32),
        plan_start=carry.plan_start,
    )
    need_seed = (carry.prev_n == 0) & traj.ok
    carry_base = jax.tree.map(
        lambda s, c: jnp.where(need_seed, s, c), seeded, carry
    )
    optimized_carry = ControllerCarry(
        prev_path=res.path,
        prev_cmds=res.cmds,
        prev_n=res.n.astype(jnp.int32),
        plan_start=carry.plan_start,
    )
    new_carry = jax.tree.map(
        lambda o, c: jnp.where(use_opt, o, c), optimized_carry, carry_base
    )
    # The plan-advance cursor moves every tick regardless of solve success —
    # the reference erases passed poses in transformGlobalPlan, before the
    # optimizer even runs (path_handler.cpp:100).
    new_carry = new_carry._replace(plan_start=windowed.start_index)

    aux = StepAux(
        local_path=res.path,
        ref_path=traj.poses,
        cmds=res.cmds,
        people_proj=res.people_proj,
        status=status,
        solve=res.stats,
        plan_start_index=windowed.start_index,
        lm_trace=res.lm_trace,
    )
    return cmd, aux, new_carry


def make_step(cfg: SocialMPCConfig):
    """Jitted single-scenario step closure."""
    return jax.jit(functools.partial(step, cfg))


def make_step_batch(cfg: SocialMPCConfig, validate: bool = True):
    """Jitted batched step: scenario/carry pytrees with a leading batch axis.

    This is the accelerator workhorse — the reference solves ONE problem per
    50 ms tick on CPU; here a whole scenario batch solves per dispatch
    (SURVEY.md 'the single number that shapes everything').

    The returned callable checks the windowing-exactness bounds
    (core/validate.py) against the ACTUAL grid resolutions at the call
    boundary, where they are concrete — inside the trace they are abstract
    and the in-graph fallback cannot fire, so a hand-built batch with a
    too-small obstacle/ESDF window must fail loudly HERE. The check runs
    once per distinct resolution buffer (identity-cached): steady-state
    ticks that reuse scenario buffers pay nothing. ``validate=False`` opts
    out for callers that validated at construction (the built-in generators
    already do)."""
    fn = jax.jit(jax.vmap(functools.partial(step, cfg)))
    if not validate:
        return fn

    from nav2_social_mpc_controller_tpu.core.validate import make_window_validator

    check = make_window_validator(cfg)

    @functools.wraps(fn)
    def checked(scenario, carry):
        check(scenario)
        return fn(scenario, carry)

    return checked


def make_step_batch_compacted(
    cfg: SocialMPCConfig, capacity_frac: float = 0.25, validate: bool = True
):
    """Batched step with converged-lane compaction in the LM solve
    (solver/batched.py): vmap(step_pre) -> ONE explicitly-batched two-phase
    solver -> vmap(step_post). Per-lane results are identical to
    make_step_batch (pinned by tests/test_compaction.py); the win is that a
    warm-started batch stops paying full-width iterations once the laggard
    set fits capacity_frac * batch lanes. debug_optimizer is unsupported
    here (the per-iteration trace assumes the per-lane while loop)."""
    if cfg.optimizer.debug_optimizer:
        raise ValueError("compaction does not support debug_optimizer")
    from nav2_social_mpc_controller_tpu.ops import fused_iter
    from nav2_social_mpc_controller_tpu.solver.batched import lm_solve_batch_compacted

    dims = ProblemDims.from_config(cfg)
    op = fused_iter.make_value_grad_op(cfg, dims)
    lm_cfg = make_lm_config(cfg.optimizer)
    vpre = jax.vmap(functools.partial(step_pre, cfg))
    vpost = jax.vmap(functools.partial(step_post, cfg))

    @jax.jit
    def run(scenario, carry):
        ctx = vpre(scenario, carry)
        prep = ctx.prep
        batch = prep.u0.shape[0]
        capacity = max(1, int(batch * capacity_frac))
        data = fused_iter.value_grad_data(
            prep.rows, prep.n_rows, prep.people_proj, prep.people_present,
            prep.costmap,
        )
        u, stats = lm_solve_batch_compacted(
            op, data, prep.u0, prep.lower, prep.upper, lm_cfg, capacity
        )
        return vpost(ctx, carry, u, stats)

    if not validate:
        return run

    from nav2_social_mpc_controller_tpu.core.validate import make_window_validator

    check = make_window_validator(cfg)

    @functools.wraps(run)
    def checked(scenario, carry):
        check(scenario)
        return run(scenario, carry)

    return checked


class SocialMPCController:
    """Stateful host wrapper with nav2_core::Controller-shaped lifecycle API
    (social_mpc_controller.hpp:70-113). Holds the global plan and the
    warm-start carry; computeVelocityCommands drives the jitted step."""

    def __init__(self, cfg: SocialMPCConfig):
        self.cfg = cfg
        self._step = make_step(cfg)
        self._carry = make_carry(cfg)
        self._plan = None
        self._active = False
        self._windows_validated = False

    # Lifecycle (configure happens in __init__)
    def activate(self):
        self._active = True

    def deactivate(self):
        self._active = False

    def cleanup(self):
        self._plan = None
        self._carry = make_carry(self.cfg)

    def set_plan(self, path):
        """setPlan (social_mpc_controller.cpp:260-263): installing a new plan
        replaces the stored one (path_handler.cpp:110-113), so the in-graph
        plan-advance cursor resets; the warm-start memory persists (the
        reference's TrajectoryMemory is a process singleton)."""
        self._plan = path
        self._carry = self._carry._replace(plan_start=jnp.zeros((), jnp.int32))

    def set_speed_limit(self, speed_limit: float, percentage: bool):
        """setSpeedLimit — a deliberate no-op, faithfully reproducing the
        reference's dead-store implementation (social_mpc_controller.cpp:265-285)."""

    def compute_velocity_commands(self, scenario: Scenario) -> Tuple[ControlCommand, StepAux]:
        if not self._windows_validated:
            # Hard exactness check of the two windowing optimizations against
            # the actual grid resolutions (core/validate.py) — inside the
            # jitted step the resolutions are traced and the in-graph
            # fallback cannot fire, so a misconfigured window must fail HERE
            # rather than silently corrupt results.
            from nav2_social_mpc_controller_tpu.core.validate import (
                validate_scenario_windows,
            )

            validate_scenario_windows(
                self.cfg, scenario.costmap.resolution, scenario.esdf.resolution
            )
            self._windows_validated = True
        if self._plan is not None:
            scenario = scenario._replace(path=self._plan)
        cmd, aux, self._carry = self._step(scenario, self._carry)
        # Plan pruning — the reference ERASES [begin(), transformation_begin)
        # from its plan copy every tick (path_handler.cpp:100) — happens
        # IN-GRAPH: the carry's plan_start cursor advanced to
        # aux.plan_start_index and the next tick's search window starts from
        # that pruned head. (prune_plan remains available as a host utility
        # for drivers that physically shrink their plan buffers; such drivers
        # must then reset the cursor, e.g. via set_plan.)
        return cmd, aux
