"""Analytic LM value-and-gradient (ops/fused_iter.py): rollout
sensitivities, and the analytic value_grad pinned against the linearize
path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nav2_social_mpc_controller_tpu.models.motion import (
    block_index_sequence_dynamic,
    rollout_poses,
)
from nav2_social_mpc_controller_tpu.ops.fused_iter import rollout_with_sensitivities


def test_rollout_sensitivities_match_jacfwd():
    rng = np.random.default_rng(0)
    s, n_blocks = 29, 3
    dt = 0.05
    u = jnp.asarray(rng.uniform(-0.5, 0.5, (n_blocks, 2)))
    pose0 = jnp.asarray([0.3, -0.2, 0.7])
    block_idx = block_index_sequence_dynamic(s, 18, 6)

    poses, vw, tx, ty, tth, eb = rollout_with_sensitivities(
        u, pose0, dt, block_idx, n_blocks
    )
    poses_ref = rollout_poses(pose0, u, dt, block_idx)
    np.testing.assert_allclose(np.asarray(poses), np.asarray(poses_ref), atol=1e-12)

    jac = jax.jacfwd(
        lambda uf: rollout_poses(pose0, uf.reshape(n_blocks, 2), dt, block_idx)[1:]
    )(u.reshape(-1))  # (S, 3, D)
    np.testing.assert_allclose(np.asarray(tx), np.asarray(jac[:, 0, :]), atol=1e-9)
    np.testing.assert_allclose(np.asarray(ty), np.asarray(jac[:, 1, :]), atol=1e-9)
    np.testing.assert_allclose(np.asarray(tth), np.asarray(jac[:, 2, :]), atol=1e-9)


def test_rollout_sensitivities_dynamic_horizon():
    """Shrunk dynamic horizon (near-goal) changes block_idx; sensitivities
    must follow it exactly."""
    rng = np.random.default_rng(1)
    s, n_blocks = 29, 3
    dt = 0.05
    u = jnp.asarray(rng.uniform(-0.5, 0.5, (n_blocks, 2)))
    pose0 = jnp.asarray([0.0, 0.0, -1.2])
    block_idx = block_index_sequence_dynamic(s, 7, 4)  # h_dyn=7, bl_dyn=4

    _, _, tx, ty, tth, _ = rollout_with_sensitivities(u, pose0, dt, block_idx, n_blocks)
    jac = jax.jacfwd(
        lambda uf: rollout_poses(pose0, uf.reshape(n_blocks, 2), dt, block_idx)[1:]
    )(u.reshape(-1))
    np.testing.assert_allclose(np.asarray(tx), np.asarray(jac[:, 0, :]), atol=1e-9)
    np.testing.assert_allclose(np.asarray(ty), np.asarray(jac[:, 1, :]), atol=1e-9)
    np.testing.assert_allclose(np.asarray(tth), np.asarray(jac[:, 2, :]), atol=1e-9)


def _batch_problem(cfg_fn, n_people, seeds, dtype=np.float32):
    """Build the (rows, n_rows, proj, present, costmap) operand batch the
    fused value_grad consumes, straight from the production pipeline."""
    from nav2_social_mpc_controller_tpu.controller.optimize import (
        ProblemDims,
        format_to_optimize,
    )
    from nav2_social_mpc_controller_tpu.controller.trajectorizer import trajectorize
    from nav2_social_mpc_controller_tpu.core.types import ControllerCarry
    from nav2_social_mpc_controller_tpu.models.sfm import project_people
    from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario

    cfg = cfg_fn()
    dims = ProblemDims.from_config(cfg)
    batch = {k: [] for k in ("u", "rows", "n_rows", "proj", "present", "cmd", "cmo", "cmr")}
    for seed in seeds:
        sc = make_scenario(cfg, seed=seed, n_valid_people=n_people, dtype=dtype)
        res = trajectorize(cfg.trajectorizer, sc.path, jnp.asarray(sc.robot.pose))
        carry = ControllerCarry(
            prev_path=jnp.zeros((dims.maxsize, 3), dtype),
            prev_cmds=jnp.zeros((dims.maxsize, 2), dtype),
            prev_n=jnp.zeros((), jnp.int32),
        )
        rows, n_rows = format_to_optimize(
            cfg, dims, res.poses, res.cmds, res.n_steps, jnp.asarray(sc.robot.speed), carry
        )
        proj = project_people(
            jnp.asarray(sc.people.state, dtype), rows, n_rows,
            jnp.asarray(sc.esdf.distances, dtype), jnp.asarray(sc.esdf.indexes),
            jnp.asarray(sc.esdf.origin, dtype), jnp.asarray(sc.esdf.resolution, dtype),
            jnp.asarray(sc.esdf.valid),
            maxtime=cfg.trajectorizer.max_time, dt=cfg.trajectorizer.time_step,
            esdf_window=cfg.esdf_window_cells,
        )
        u0 = jnp.clip(rows[: dims.n_blocks, 4:6].reshape(-1), -0.6, 0.6)
        batch["u"].append(u0)
        batch["rows"].append(rows)
        batch["n_rows"].append(n_rows)
        batch["proj"].append(proj)
        batch["present"].append(jnp.any(jnp.asarray(sc.people.state)[:, 3] != -1.0))
        batch["cmd"].append(jnp.asarray(sc.costmap.data, dtype))
        batch["cmo"].append(jnp.asarray(sc.costmap.origin, dtype))
        batch["cmr"].append(jnp.asarray(sc.costmap.resolution, dtype))
    stacked = {k: jnp.stack(v) for k, v in batch.items()}
    return cfg, dims, stacked


def _compare_fused_vs_ref(cfg_fn, n_people, perturb_seed=0, seeds=range(4)):
    import functools

    from nav2_social_mpc_controller_tpu.ops.fused_iter import (
        _ref_value_grad,
        fused_batched,
    )

    cfg, dims, bt = _batch_problem(cfg_fn, n_people, seeds=seeds)
    rng = np.random.default_rng(perturb_seed)
    u = bt["u"] + jnp.asarray(rng.uniform(-0.05, 0.05, bt["u"].shape), jnp.float32)

    args = (u, bt["rows"], bt["n_rows"], bt["proj"], bt["present"],
            bt["cmd"], bt["cmo"], bt["cmr"])
    c_ref, g_ref, jtj_ref = jax.vmap(functools.partial(_ref_value_grad, cfg, dims))(*args)
    c_f, g_f, jtj_f = jax.jit(functools.partial(fused_batched, cfg, dims))(*args)

    np.testing.assert_allclose(np.asarray(c_f), np.asarray(c_ref), rtol=2e-5)
    scale_g = np.maximum(np.abs(np.asarray(g_ref)).max(axis=(1,), keepdims=True), 1.0)
    np.testing.assert_allclose(
        np.asarray(g_f) / scale_g, np.asarray(g_ref) / scale_g, atol=3e-5
    )
    scale_j = np.maximum(
        np.abs(np.asarray(jtj_ref)).max(axis=(1, 2), keepdims=True), 1.0
    )
    np.testing.assert_allclose(
        np.asarray(jtj_f) / scale_j, np.asarray(jtj_ref) / scale_j, atol=3e-5
    )
    np.testing.assert_allclose(  # JtJ is symmetric by construction
        np.asarray(jtj_f), np.swapaxes(np.asarray(jtj_f), 1, 2), rtol=1e-6, atol=1e-6
    )


def test_fused_value_grad_matches_reference_social():
    from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config

    _compare_fused_vs_ref(benchmark_social_config, 3)


def test_fused_value_grad_matches_reference_obstacle_only():
    from nav2_social_mpc_controller_tpu.core.config import (
        benchmark_obstacle_only_config,
    )

    _compare_fused_vs_ref(benchmark_obstacle_only_config, 0)


def test_fused_value_grad_matches_reference_omni6():
    from nav2_social_mpc_controller_tpu.core.config import (
        benchmark_omni_6agents_config,
    )

    _compare_fused_vs_ref(benchmark_omni_6agents_config, 6)


def test_fused_value_grad_matches_reference_stress36():
    from nav2_social_mpc_controller_tpu.core.config import (
        benchmark_stress_h36_config,
    )

    _compare_fused_vs_ref(benchmark_stress_h36_config, 3)


@pytest.mark.parametrize("seeds", [range(7, 8), range(10, 15)])
def test_fused_value_grad_any_batch_width(seeds):
    """One lane, and an odd batch of five: the (S, B) layout has no width
    constraint."""
    from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config

    _compare_fused_vs_ref(benchmark_social_config, 3, perturb_seed=1, seeds=seeds)


def test_analytic_path_dispatch_follows_dtype_and_batching():
    """Under vmap the op takes the analytic path for batched f32 on every
    backend; single-lane and f64 calls take linearize."""
    from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config
    from nav2_social_mpc_controller_tpu.ops import fused_iter as fi

    cfg = benchmark_social_config()
    u = jnp.zeros((4, 6), jnp.float32)
    assert fi._fused_dispatch_ok(cfg, u)
    assert not fi._fused_dispatch_ok(cfg, u[0])
    assert not fi._fused_dispatch_ok(cfg, u.astype(jnp.float64))


def test_step_with_analytic_value_grad_matches_linearize_in_f64():
    """The whole batched controller step with the analytic value-grad
    dispatched (as for f32) equals the linearize step. Run in f64, where
    both formulations agree to rounding and the LM branches cannot split."""
    import functools
    from unittest import mock

    from nav2_social_mpc_controller_tpu.controller.controller import make_carry, step
    from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config
    from nav2_social_mpc_controller_tpu.ops import fused_iter as fi
    from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario_batch

    cfg = benchmark_social_config()
    scb = make_scenario_batch(cfg, 3, n_valid_people=3, grid_hw=(64, 64), dtype=np.float64)
    carry = jax.vmap(lambda _: make_carry(cfg, dtype=jnp.float64))(jnp.arange(3))
    run = lambda: jax.jit(jax.vmap(functools.partial(step, cfg)))(scb, carry)  # noqa: E731
    cmd_ref, aux_ref, _ = run()
    gate = lambda c, u: u.ndim == 2 and fi.can_fuse(c)  # noqa: E731
    with mock.patch.object(fi, "_fused_dispatch_ok", gate):
        cmd_an, aux_an, _ = run()
    np.testing.assert_allclose(np.asarray(cmd_an.linear_x), np.asarray(cmd_ref.linear_x), atol=1e-8)
    np.testing.assert_allclose(np.asarray(cmd_an.angular_z), np.asarray(cmd_ref.angular_z), atol=1e-8)
    np.testing.assert_array_equal(
        np.asarray(aux_an.solve.iterations), np.asarray(aux_ref.solve.iterations)
    )


@pytest.mark.parametrize("fault", ["none", "tf32_contraction", "yaw_sensitivity_off_by_one"])
def test_f32_tolerance_separates_rounding_from_faults(fault):
    """F32_REL_TOL passes the sound f32 analytic path against the f64
    linearize reference, and fails a TF32 contraction and a planted
    formulation fault (each at least 10x above it)."""
    import functools

    from chip_smoke import tf32
    from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config
    from nav2_social_mpc_controller_tpu.ops import fused_iter as fi

    cfg, dims, bt = _batch_problem(benchmark_social_config, 3, seeds=range(8))
    args = (bt["u"], bt["rows"], bt["n_rows"], bt["proj"], bt["present"],
            bt["cmd"], bt["cmo"], bt["cmr"])

    def analytic(*args):
        statics, ops = fi._fused_prep(cfg, dims, *args)
        if fault == "yaw_sensitivity_off_by_one":
            dth = ops["dth"]
            ops = dict(ops, dth=jnp.concatenate([jnp.zeros_like(dth[:, :1]), dth[:, :-1]], 1))
        r, jac = fi.analytic_residual_jacobian(statics, ops)
        if fault == "tf32_contraction":
            r, jac = tf32(r), tf32(jac)
        return fi.normal_equations(r, jac)

    got = jax.jit(analytic)(*args)
    args64 = [a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a
              for a in args]
    ref = jax.jit(jax.vmap(functools.partial(fi._ref_value_grad, cfg, dims)))(*args64)
    err = max(
        float(np.max(np.abs(np.asarray(g_, np.float64) - np.asarray(r_)))
              / np.max(np.abs(np.asarray(r_))))
        for g_, r_ in zip(got[1:], ref[1:])
    )
    if fault == "none":
        assert err <= fi.F32_REL_TOL, err
    else:
        assert err > 10 * fi.F32_REL_TOL, err
