#!/usr/bin/env python
"""LM iteration economics (VERDICT r1 item 7): compare per-problem iteration
counts of the batched solver vs the Ceres-semantics oracle on identical
problems, and quantify the all-lanes-until-slowest tax of the batched
while_loop (time per tick scales with the batch MAX, not the mean).

Run on CPU (float64):
  PYTHONPATH=.:$PYTHONPATH python tools/lm_economics.py --seeds 24
"""

import argparse
import json

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def solve_pair(cfg, seed, n_people):
    from nav2_social_mpc_controller_tpu.core.types import ControllerCarry
    from nav2_social_mpc_controller_tpu.controller.optimize import (
        ProblemDims,
        build_residual_fn,
        format_to_optimize,
    )
    from nav2_social_mpc_controller_tpu.controller.trajectorizer import trajectorize
    from nav2_social_mpc_controller_tpu.models.sfm import project_people
    from nav2_social_mpc_controller_tpu.solver.lm import LMConfig, lm_solve
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
        rows,
        n_rows,
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

    lm_cfg = LMConfig(
        max_iterations=opt.max_iterations, fn_tol=opt.fn_tol,
        gradient_tol=opt.gradient_tol, param_tol=opt.param_tol,
    )
    u_jax, stats = lm_solve(rfn, jnp.asarray(u0), jnp.asarray(lo), jnp.asarray(hi), lm_cfg)

    n = int(n_rows)
    o_proj = [np.asarray(p, np.float64) for p in proj[:n]]
    cm = (np.asarray(sc.costmap.data, np.float64),
          np.asarray(sc.costmap.origin, np.float64), float(sc.costmap.resolution))

    def orfn(u):
        return oracle.oracle_residuals(
            cfg, np.asarray(rows[:n], np.float64), o_proj, bool(present), cm,
            u.reshape(dims.n_blocks, 2))

    _u, _c, o_iters = oracle.oracle_lm_solve(
        orfn, u0, lo, hi, opt.max_iterations, opt.fn_tol, opt.gradient_tol,
        opt.param_tol, return_iters=True)
    return int(stats.iterations), o_iters, int(stats.termination)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--people", type=int, default=3)
    args = ap.parse_args()

    from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config

    cfg = benchmark_social_config()
    fw, orc, terms = [], [], []
    for seed in range(args.seeds):
        f, o, t = solve_pair(cfg, seed, args.people)
        fw.append(f)
        orc.append(o)
        terms.append(t)
        print(f"seed {seed:3d}: framework {f:3d} iters (term {t}), oracle {o:3d} iters")

    fw = np.array(fw)
    orc = np.array(orc)
    cap = cfg.optimizer.max_iterations
    # All lanes run until the slowest in the batch converges: the per-tick
    # cost of a large batch is ~E[max], the useful work is E[mean].
    tax = float(fw.max()) / max(float(fw.mean()), 1e-9)
    print(json.dumps({
        "seeds": args.seeds,
        "framework_mean": float(fw.mean()),
        "framework_median": float(np.median(fw)),
        "framework_max": int(fw.max()),
        "framework_at_cap_frac": float((fw >= cap).mean()),
        "oracle_mean": float(orc.mean()),
        "oracle_median": float(np.median(orc)),
        "oracle_max": int(orc.max()),
        "oracle_at_cap_frac": float((orc >= cap).mean()),
        "mean_abs_diff": float(np.abs(fw - orc).mean()),
        "batch_slowest_lane_tax": round(tax, 3),
        "term_codes": {str(t): int((np.array(terms) == t).sum()) for t in set(terms)},
    }, indent=2))


if __name__ == "__main__":
    main()
