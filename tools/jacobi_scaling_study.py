#!/usr/bin/env python
"""Does Ceres' default `jacobi_scaling` change our solves? (VERDICT r3 item 3)

The reference never touches Solver::Options::jacobi_scaling
(the reference's src/optimizer.cpp:98-132), so real Ceres runs with column
scaling ON. Both parity/oracle.py:oracle_lm_solve and solver/lm.py now
implement it behind a flag. Theory says it is an exact no-op here: with
Marquardt damping D = diag(J^T J), a frozen diagonal column scaling S maps
the scaled damped system back to the IDENTICAL unscaled system whenever the
[1e-6, 1e32] diagonal clamp binds in neither space:

    S^{-1} (S J^T J S + (1/r) clamp(diag(S J^T J S))) S^{-1}
  = J^T J + (1/r) S^{-1} clamp(S^2 diag(J^T J)) S^{-1}
  = J^T J + (1/r) clamp'(diag(J^T J))        [clamp' = clamp iff non-binding]

This tool verifies the premise (clamp never binds at benchmark magnitudes)
and the conclusion (iteration counts identical, cmd deltas at f64 rounding)
across all four benchmark configs x seeds, for BOTH the f64 oracle and the
framework solver on CPU x64.

  PYTHONPATH=.:$PYTHONPATH python tools/jacobi_scaling_study.py --seeds 10
"""

import argparse
import json

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def build_problem(cfg, seed, n_people):
    from nav2_social_mpc_controller_tpu.core.types import ControllerCarry
    from nav2_social_mpc_controller_tpu.controller.optimize import (
        ProblemDims,
        build_residual_fn,
        format_to_optimize,
    )
    from nav2_social_mpc_controller_tpu.controller.trajectorizer import trajectorize
    from nav2_social_mpc_controller_tpu.models.sfm import project_people
    from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario
    from parity import oracle

    sc = make_scenario(cfg, seed=seed, n_valid_people=n_people, dtype=np.float64)
    dims = ProblemDims.from_config(cfg)
    res = trajectorize(cfg.trajectorizer, sc.path, jnp.asarray(sc.robot.pose))
    carry = ControllerCarry(
        prev_path=jnp.zeros((dims.maxsize, 3), jnp.float64),
        prev_cmds=jnp.zeros((dims.maxsize, 2), jnp.float64),
        prev_n=jnp.zeros((), jnp.int32),
    )
    rows, n_rows = format_to_optimize(
        cfg, dims, res.poses, res.cmds, res.n_steps, jnp.asarray(sc.robot.speed), carry
    )
    proj = project_people(
        jnp.asarray(sc.people.state, jnp.float64),
        rows, n_rows,
        jnp.asarray(sc.esdf.distances, jnp.float64),
        jnp.asarray(sc.esdf.indexes),
        jnp.asarray(sc.esdf.origin, jnp.float64),
        jnp.asarray(sc.esdf.resolution, jnp.float64),
        jnp.asarray(sc.esdf.valid),
        maxtime=cfg.trajectorizer.max_time,
        dt=cfg.trajectorizer.time_step,
    )
    present = jnp.any(jnp.asarray(sc.people.state)[:, 3] != -1.0)
    rfn = build_residual_fn(cfg, dims, rows, n_rows, proj, present, sc.costmap)

    opt = cfg.optimizer
    n_bounded = dims.horizon // dims.block_length
    lo = np.where((np.arange(dims.n_blocks) < n_bounded)[:, None],
                  [[opt.v_min, opt.w_min]], -np.inf).reshape(-1)
    hi = np.where((np.arange(dims.n_blocks) < n_bounded)[:, None],
                  [[opt.v_max, opt.w_max]], np.inf).reshape(-1)
    u0 = np.clip(np.asarray(rows[: dims.n_blocks, 4:6], np.float64).reshape(-1), lo, hi)

    n = int(n_rows)
    o_proj = [np.asarray(p, np.float64) for p in proj[:n]]
    cm = (np.asarray(sc.costmap.data, np.float64),
          np.asarray(sc.costmap.origin, np.float64), float(sc.costmap.resolution))

    def orfn(u):
        return oracle.oracle_residuals(
            cfg, np.asarray(rows[:n], np.float64), o_proj, bool(present), cm,
            u.reshape(dims.n_blocks, 2))

    return rfn, orfn, u0, lo, hi, dims


def clamp_diagnostics(orfn, u0):
    """diag(J^T J) at u0 in unscaled and scaled space vs the [1e-6,1e32]
    clamp — exact jet Jacobian (parity/jets.py), no FD probe noise."""
    from parity.jets import value_and_jacobian

    _r0, J = value_and_jacobian(orfn, u0)
    d = np.sum(J * J, axis=0)
    s = 1.0 / (1.0 + np.sqrt(d))
    return float(d.min()), float(d.max()), float((s * s * d).min()), float((s * s * d).max())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    from nav2_social_mpc_controller_tpu.core.config import (
        benchmark_obstacle_only_config,
        benchmark_omni_6agents_config,
        benchmark_social_config,
        benchmark_stress_h36_config,
    )
    from nav2_social_mpc_controller_tpu.solver.lm import LMConfig, lm_solve
    from parity import oracle

    configs = {
        "social": (benchmark_social_config, 3),
        "obstacle": (benchmark_obstacle_only_config, 0),
        "omni6": (benchmark_omni_6agents_config, 6),
        "stress36": (benchmark_stress_h36_config, 3),
    }

    rows = []
    diag_lo, diag_hi = np.inf, 0.0
    for name, (cfg_fn, n_people) in configs.items():
        cfg = cfg_fn()
        opt = cfg.optimizer
        for seed in range(args.seeds):
            rfn, orfn, u0, lo, hi, dims = build_problem(cfg, seed, n_people)

            dmin, dmax, sdmin, sdmax = clamp_diagnostics(orfn, u0)
            diag_lo = min(diag_lo, dmin, sdmin)
            diag_hi = max(diag_hi, dmax, sdmax)

            o_res = {}
            for js in (False, True):
                u, c, it = oracle.oracle_lm_solve(
                    orfn, u0, lo, hi, opt.max_iterations, opt.fn_tol,
                    opt.gradient_tol, opt.param_tol, return_iters=True,
                    jacobi_scaling=js)
                o_res[js] = (u, it)
            f_res = {}
            for js in (False, True):
                lm_cfg = LMConfig(
                    max_iterations=opt.max_iterations, fn_tol=opt.fn_tol,
                    gradient_tol=opt.gradient_tol, param_tol=opt.param_tol,
                    jacobi_scaling=js)
                u, stats = lm_solve(rfn, jnp.asarray(u0), jnp.asarray(lo),
                                    jnp.asarray(hi), lm_cfg)
                f_res[js] = (np.asarray(u), int(stats.iterations))

            rows.append(dict(
                config=name, seed=seed,
                oracle_cmd_delta=float(np.max(np.abs(o_res[True][0][:2] - o_res[False][0][:2]))),
                oracle_u_delta=float(np.max(np.abs(o_res[True][0] - o_res[False][0]))),
                oracle_iters=(o_res[False][1], o_res[True][1]),
                fw_cmd_delta=float(np.max(np.abs(f_res[True][0][:2] - f_res[False][0][:2]))),
                fw_u_delta=float(np.max(np.abs(f_res[True][0] - f_res[False][0]))),
                fw_iters=(f_res[False][1], f_res[True][1]),
            ))
        done = [r for r in rows if r["config"] == name]
        print(f"[{name}] {len(done)} seeds: "
              f"max oracle cmd delta {max(r['oracle_cmd_delta'] for r in done):.3e}, "
              f"max fw cmd delta {max(r['fw_cmd_delta'] for r in done):.3e}, "
              f"oracle iter mismatches "
              f"{sum(r['oracle_iters'][0] != r['oracle_iters'][1] for r in done)}, "
              f"fw iter mismatches "
              f"{sum(r['fw_iters'][0] != r['fw_iters'][1] for r in done)}")

    out = {
        "seeds_per_config": args.seeds,
        "diag_range_both_spaces": [diag_lo, diag_hi],
        "clamp": [1e-6, 1e32],
        "clamp_binds": bool(diag_lo < 1e-6 or diag_hi > 1e32),
        "oracle_max_cmd_delta": max(r["oracle_cmd_delta"] for r in rows),
        "oracle_max_u_delta": max(r["oracle_u_delta"] for r in rows),
        "oracle_iter_mismatch_frac": float(np.mean(
            [r["oracle_iters"][0] != r["oracle_iters"][1] for r in rows])),
        "fw_max_cmd_delta": max(r["fw_cmd_delta"] for r in rows),
        "fw_max_u_delta": max(r["fw_u_delta"] for r in rows),
        "fw_iter_mismatch_frac": float(np.mean(
            [r["fw_iters"][0] != r["fw_iters"][1] for r in rows])),
        "within_1e3": bool(
            max(max(r["oracle_cmd_delta"], r["fw_cmd_delta"]) for r in rows) < 1e-3),
    }
    print(json.dumps(out, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
