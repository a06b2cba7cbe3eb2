"""OptimizerConfig.warm_start_mode="previous_solution" (framework extension;
see tools/warm_start_study.py): on warm ticks the solver must
start from the previous tick's own block optima and converge in fewer LM
iterations than the reference-semantics row-blend start, without degrading
solution usability."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config
from nav2_social_mpc_controller_tpu.controller.controller import make_carry, step
from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario_batch


def _cfg(mode):
    cfg = benchmark_social_config()
    return dataclasses.replace(
        cfg, optimizer=dataclasses.replace(cfg.optimizer, warm_start_mode=mode)
    )


def _run(cfg, scb, batch, n_ticks):
    vstep = jax.jit(jax.vmap(functools.partial(step, cfg)))
    carry = jax.vmap(lambda _: make_carry(cfg))(jnp.arange(batch))
    iters, cmds, usable = [], [], []
    for t in range(n_ticks):
        sc = scb._replace(robot=scb.robot._replace(pose=scb.robot.pose + 1e-6 * t))
        cmd, aux, carry = vstep(sc, carry)
        iters.append(np.asarray(aux.solve.iterations))
        usable.append(np.asarray(aux.solve.usable))
        cmds.append(np.stack([np.asarray(cmd.linear_x), np.asarray(cmd.angular_z)], -1))
    return np.stack(iters), np.stack(cmds), np.stack(usable)


def test_previous_solution_mode_cuts_warm_iterations():
    batch, n_ticks = 8, 3
    scb = make_scenario_batch(benchmark_social_config(), batch, n_valid_people=3)
    it_ref, cmd_ref, ok_ref = _run(_cfg("reference"), scb, batch, n_ticks)
    it_prev, cmd_prev, ok_prev = _run(_cfg("previous_solution"), scb, batch, n_ticks)

    assert ok_ref.all() and ok_prev.all()
    # Tick 0 has no previous solution: both modes take the reference start
    # and must burn IDENTICAL iterations.
    np.testing.assert_array_equal(it_ref[0], it_prev[0])
    # Warm ticks: restarting from the previous optimum must cut the mean
    # iteration count substantially (measured ~34 -> ~5 on CPU; iteration
    # counts do not depend on the platform;
    # assert a conservative margin).
    assert it_prev[1:].mean() < 0.6 * it_ref[1:].mean(), (
        it_prev[1:].mean(), it_ref[1:].mean())
    # Commands stay finite and inside the box bounds. NOTE: they may differ
    # substantially from reference mode — the problem is nonconvex and the
    # reference's 40-iteration cap binds before convergence on ~half the
    # lanes, so a different (better-converged) start can land in a different
    # minimum. That deviation is the documented cost of the opt-in mode
    # (tools/warm_start_study.py); parity tests always run
    # in the default "reference" mode.
    o = benchmark_social_config().optimizer
    assert np.isfinite(cmd_prev).all()
    assert (cmd_prev[..., 0] >= o.v_min - 1e-6).all()
    assert (cmd_prev[..., 0] <= o.v_max + 1e-6).all()
    assert (np.abs(cmd_prev[..., 1]) <= o.w_max + 1e-6).all()


def test_invalid_mode_rejected():
    cfg = benchmark_social_config()
    with pytest.raises(ValueError):
        dataclasses.replace(
            cfg.optimizer, warm_start_mode="nope"
        )
