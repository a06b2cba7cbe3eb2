#!/usr/bin/env python
"""Chaos floor + converged-lane root cause for the cmd_vel parity criterion
(VERDICT r4 next-round item 2).

The on-chip parity study (tools/parity_on_chip.py) reports that cap-bound
lanes — solves that terminate at the 40-iteration cap on a nonconvex
objective — show f32-vs-f64 command deltas up to ~7e-2. The round-4 claim
that this tail is INHERENT (any two equally-legitimate solvers diverge
there) was asserted, not measured. This tool measures it:

  Arm twin64   the f64 oracle vs the f64 oracle with a ~1e-12 perturbation
               of the scripted robot poses — two maximally-legitimate
               solvers whose only difference is below every tolerance.
               Their cap-bound divergence distribution IS the chaos floor
               of the problem itself, independent of implementation.

  Arm twin32   the f32 framework step (CPU) vs itself with a ~1e-7 (one
               f32-ulp-scale) pose perturbation — the floor at production
               precision, which the f32-vs-f64 parity numbers should be
               judged against (representing f64 inputs in f32 is itself a
               ~1e-7 relative perturbation).

  Root cause   every (config, seed, tick) where BOTH the f32 framework and
               the f64 oracle converged (no cap) yet the command delta
               exceeds 1e-3 is classified by a polish test in the oracle's
               own problem: restart the f64 solver from the framework's
               solution with tight tolerances; if it returns to the
               oracle's optimum the delta was a tolerance-stop artifact
               (same basin, different stopping iterate); if it stays at a
               distinct point, the two implementations picked different
               local minima (basin switch) — expected on a nonconvex
               objective with +-w turn minima and NOT a correctness defect
               (both are valid local solutions of optimizer.cpp:381's
               problem).

Runs entirely on host (CPU backend, oracle in NumPy f64 with exact jet
Jacobians). Usage:

  PYTHONPATH=.:$PYTHONPATH python tools/chaos_floor.py \
      --seeds 10 --ticks 3 --json CHAOS_FLOOR_r05.json
"""

import argparse
import copy
import json
import sys

import numpy as np


def scripted_poses(sc, n_ticks, stride=4):
    pts = np.asarray(sc.path.points, np.float64)
    yaw = np.asarray(sc.path.yaw, np.float64)
    n = int(sc.path.n)
    return [
        np.array([pts[i, 0], pts[i, 1], yaw[i]])
        for i in (min(t * stride, n - 1) for t in range(n_ticks))
    ]


def run_oracle(cfg, sc64, poses, pert=0.0, rng=None):
    """Oracle rollout over the scripted poses; returns per-tick rows of
    (cmd, status, capped, iters). pert perturbs each pose additively."""
    from parity import oracle

    plan_pts = [tuple(p) for p in np.asarray(sc64.path.points[: int(sc64.path.n)])]
    memory = {}
    cm = (
        np.asarray(sc64.costmap.data, np.float64),
        np.asarray(sc64.costmap.origin, np.float64),
        float(sc64.costmap.resolution),
    )
    es = (
        np.asarray(sc64.esdf.distances, np.float64),
        np.asarray(sc64.esdf.indexes),
        np.asarray(sc64.esdf.origin, np.float64),
        float(sc64.esdf.resolution),
        bool(sc64.esdf.valid),
    )
    out = []
    snapshots = []
    for pose in poses:
        p = np.asarray(pose, np.float64)
        if pert:
            p = p + pert * rng.standard_normal(3)
        # Snapshot the pre-tick state so offenders can be re-solved later in
        # the IDENTICAL problem (oracle_optimize mutates memory).
        snapshots.append((copy.deepcopy(memory), list(plan_pts), p.copy()))
        cmd, status, plan_pts = oracle.oracle_step(
            cfg, plan_pts, p, np.asarray(sc64.robot.speed, np.float64),
            np.asarray(sc64.people.state, np.float64), cm, es, memory,
        )
        out.append(
            dict(
                cmd=(float(cmd[0]), float(cmd[2])),
                status=status,
                capped=bool(memory.get("last_solve_capped", False)),
                iters=int(memory.get("last_solve_iters", -1)),
            )
        )
    return out, snapshots, (cm, es)


def run_framework(cfg, sc64, poses, pert=0.0, rng=None):
    """f32 framework rollout (ambient backend — CPU under the study env)."""
    import jax
    import jax.numpy as jnp

    from nav2_social_mpc_controller_tpu.core.types import RobotState
    from nav2_social_mpc_controller_tpu.controller.controller import (
        make_carry,
        make_step,
    )
    from nav2_social_mpc_controller_tpu.controller.optimize import ProblemDims
    from nav2_social_mpc_controller_tpu.solver import lm

    step = make_step(cfg)
    dims = ProblemDims.from_config(cfg)
    bl = dims.block_length

    def to_f32(tree):
        return jax.tree.map(
            lambda x: jnp.asarray(x, jnp.float32)
            if np.issubdtype(np.asarray(x).dtype, np.floating)
            else jnp.asarray(x),
            tree,
        )

    sc32 = to_f32(sc64)
    carry = make_carry(cfg)
    out = []
    for pose in poses:
        p = np.asarray(pose, np.float64)
        if pert:
            p = p + pert * rng.standard_normal(3)
        sc_t = sc32._replace(
            robot=RobotState(
                pose=jnp.asarray(p, jnp.float32),
                speed=jnp.asarray(sc32.robot.speed, jnp.float32),
            )
        )
        cmd, aux, carry = step(sc_t, carry)
        # Recover the block decision values from the expanded commands:
        # step b*bl holds block b for b*bl < horizon (optimize_finish).
        starts = np.minimum(np.arange(dims.n_blocks) * bl, dims.maxsize - 1)
        u_fw = np.asarray(aux.cmds)[starts]
        out.append(
            dict(
                cmd=(float(cmd.linear_x), float(cmd.angular_z)),
                status=int(aux.status),
                capped=int(aux.solve.termination) == lm.TERM_NO_CONVERGENCE,
                iters=int(aux.solve.iterations),
                u=u_fw,
            )
        )
    return out


def polish_offender(cfg, snapshot, cm, es, sc64, u_fw):
    """Rebuild the oracle problem at the snapshot and run the tight-tolerance
    f64 solver twice: from its own warm start and from the framework's
    solution. Returns (u_own, u_from_fw, cost_own, cost_from_fw)."""
    from parity import oracle

    memory, plan_pts, pose = snapshot
    memory = copy.deepcopy(memory)

    cm_data, cm_origin, cm_res = cm
    h, w = cm_data.shape
    dist_threshold = max(w * cm_res, h * cm_res) / 2.0
    win = oracle.oracle_transform_global_plan(
        plan_pts, pose, cfg.max_robot_pose_search_dist, dist_threshold
    )
    window, _begin = win
    poses_t, cmds_t = oracle.oracle_trajectorize(cfg.trajectorizer, window, pose)
    people_status, present = oracle.oracle_fov_filter(
        cfg, np.asarray(sc64.people.state, np.float64), pose, cm
    )
    # Problem build mirrors oracle_optimize (memory seeding + format + SFM).
    if memory.get("prev_path") is None or len(memory.get("prev_path", [])) == 0:
        memory["prev_path"] = np.array([[p[0], p[1], p[2]] for p in poses_t])
        memory["prev_cmds"] = np.array([[c[0], c[2]] for c in cmds_t])
    rows = oracle.oracle_format(
        cfg, poses_t, cmds_t, np.asarray(sc64.robot.speed, np.float64),
        memory["prev_path"], memory["prev_cmds"],
    )
    people_proj = oracle.oracle_project_people(
        cfg, people_status, rows, es[:4], esdf_valid=bool(es[4])
    )
    tcfg = cfg.trajectorizer
    n_rows = len(rows)
    n_vel = n_rows - 1
    maxsize = int(round(tcfg.max_time / tcfg.time_step))
    s_max = maxsize - 1
    hh = max(min(cfg.optimizer.control_horizon, s_max, n_vel), 1)
    bl = max(min(cfg.optimizer.parameter_block_length, hh), 1)
    n_blocks = (hh - 1) // bl + 1
    u0 = np.array([[rows[b][4], rows[b][5]] for b in range(n_blocks)])
    opt = cfg.optimizer
    n_bounded = hh // bl
    lo = np.where((np.arange(n_blocks) < n_bounded)[:, None],
                  [[opt.v_min, opt.w_min]], -np.inf).reshape(-1)
    hi = np.where((np.arange(n_blocks) < n_bounded)[:, None],
                  [[opt.v_max, opt.w_max]], np.inf).reshape(-1)

    def rfn(u_flat):
        return oracle.oracle_residuals(
            cfg, rows, people_proj, present, cm,
            np.asarray(u_flat).reshape(n_blocks, 2)
            if np.asarray(u_flat).dtype != object
            else np.asarray(u_flat, dtype=object).reshape(n_blocks, 2),
        )

    # Tight polish: many iterations, tolerances near f64 roundoff.
    tight = dict(max_iter=400, fn_tol=1e-14, grad_tol=1e-12, param_tol=1e-14)
    u_own, c_own = oracle.oracle_lm_solve(rfn, u0.reshape(-1), lo, hi, **tight)
    u_fw64 = np.clip(np.asarray(u_fw, np.float64).reshape(-1)[: 2 * n_blocks], lo, hi)
    u_from_fw, c_from_fw = oracle.oracle_lm_solve(rfn, u_fw64, lo, hi, **tight)
    return u_own, u_from_fw, c_own, c_from_fw


def dstats(deltas):
    if not len(deltas):
        return {}
    d = np.asarray(deltas)
    return dict(
        n=int(len(d)),
        p50=float(np.percentile(d, 50)),
        p90=float(np.percentile(d, 90)),
        max=float(d.max()),
        within_1e3=float(np.mean(d <= 1e-3)),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--pert64", type=float, default=1e-12)
    ap.add_argument("--pert32", type=float, default=1e-7)
    ap.add_argument("--json", default=None)
    ap.add_argument("--configs", default="social,obstacle,omni6,stress36")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from nav2_social_mpc_controller_tpu.core.config import (
        benchmark_obstacle_only_config,
        benchmark_omni_6agents_config,
        benchmark_social_config,
        benchmark_stress_h36_config,
    )
    from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario

    all_configs = {
        "social": (benchmark_social_config, 3),
        "obstacle": (benchmark_obstacle_only_config, 0),
        "omni6": (benchmark_omni_6agents_config, 6),
        "stress36": (benchmark_stress_h36_config, 3),
    }
    configs = {k: all_configs[k] for k in args.configs.split(",")}

    twin64_rows, twin32_rows, cross_rows = [], [], []
    offenders = []
    for name, (cfg_fn, n_people) in configs.items():
        cfg = cfg_fn()
        for seed_i in range(args.seeds):
            sc64 = make_scenario(cfg, seed=seed_i, n_valid_people=n_people,
                                 dtype=np.float64)
            poses = scripted_poses(sc64, args.ticks)
            rng = np.random.default_rng(1000 + seed_i)

            o_base, snaps, (cm, es) = run_oracle(cfg, sc64, poses)
            o_pert, _s, _g = run_oracle(cfg, sc64, poses, pert=args.pert64, rng=rng)
            f_base = run_framework(cfg, sc64, poses)
            f_pert = run_framework(cfg, sc64, poses, pert=args.pert32, rng=rng)

            for t in range(args.ticks):
                d64 = max(abs(o_base[t]["cmd"][0] - o_pert[t]["cmd"][0]),
                          abs(o_base[t]["cmd"][1] - o_pert[t]["cmd"][1]))
                capped64 = o_base[t]["capped"] or o_pert[t]["capped"]
                twin64_rows.append(dict(config=name, seed=seed_i, tick=t,
                                        d=d64, capped=capped64))
                d32 = max(abs(f_base[t]["cmd"][0] - f_pert[t]["cmd"][0]),
                          abs(f_base[t]["cmd"][1] - f_pert[t]["cmd"][1]))
                capped32 = f_base[t]["capped"] or f_pert[t]["capped"]
                twin32_rows.append(dict(config=name, seed=seed_i, tick=t,
                                        d=d32, capped=capped32))
                # Cross comparison fw-f32 vs oracle-f64 (the parity metric)
                dx = max(abs(f_base[t]["cmd"][0] - o_base[t]["cmd"][0]),
                         abs(f_base[t]["cmd"][1] - o_base[t]["cmd"][1]))
                both_conv = (not f_base[t]["capped"]) and (not o_base[t]["capped"])
                cross_rows.append(dict(config=name, seed=seed_i, tick=t, d=dx,
                                       both_converged=both_conv))
                if both_conv and dx > 1e-3 and f_base[t]["status"] == 0:
                    u_own, u_from_fw, c_own, c_from_fw = polish_offender(
                        cfg, snaps[t], cm, es, sc64, f_base[t]["u"]
                    )
                    d_polish = float(np.max(np.abs(u_own[:2] - u_from_fw[:2])))
                    mech = "tolerance_stop" if d_polish <= 1e-4 else "basin_switch"
                    offenders.append(dict(
                        config=name, seed=seed_i, tick=t, delta=dx,
                        polish_delta=d_polish, mechanism=mech,
                        cost_own=float(c_own), cost_from_fw=float(c_from_fw),
                        fw_iters=f_base[t]["iters"], o_iters=o_base[t]["iters"],
                    ))
        print(f"[{name}] done ({args.seeds} seeds x {args.ticks} ticks)",
              file=sys.stderr)

    out = {
        "protocol": {
            "seeds": args.seeds, "ticks": args.ticks,
            "pert64": args.pert64, "pert32": args.pert32,
            "configs": list(configs),
        },
        "twin64": {
            "all": dstats([r["d"] for r in twin64_rows]),
            "cap_bound": dstats([r["d"] for r in twin64_rows if r["capped"]]),
            "converged": dstats([r["d"] for r in twin64_rows if not r["capped"]]),
        },
        "twin32": {
            "all": dstats([r["d"] for r in twin32_rows]),
            "cap_bound": dstats([r["d"] for r in twin32_rows if r["capped"]]),
            "converged": dstats([r["d"] for r in twin32_rows if not r["capped"]]),
        },
        "cross_f32_vs_oracle": {
            "all": dstats([r["d"] for r in cross_rows]),
            "converged_both": dstats(
                [r["d"] for r in cross_rows if r["both_converged"]]),
            "not_converged": dstats(
                [r["d"] for r in cross_rows if not r["both_converged"]]),
        },
        "converged_offenders": {
            "count": len(offenders),
            "of_converged_lanes": int(sum(r["both_converged"] for r in cross_rows)),
            "mechanisms": {
                m: sum(o["mechanism"] == m for o in offenders)
                for m in ("basin_switch", "tolerance_stop")
            },
            "rows": offenders,
        },
    }
    print(json.dumps(out, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
