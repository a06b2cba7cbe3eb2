#!/usr/bin/env python
"""On-device cmd_vel parity: the f32 BATCHED jitted step on the default
backend (the GPU) vs the float64 NumPy oracle.

The BASELINE criterion — cmd_vel parity with Ceres within 1e-3 — is pinned
by the test suite on CPU in f64 (tests/test_parity_step.py). This tool
measures the production-precision gap on the device itself by driving
``make_step_batch`` (seeds of a config batched together), so the measured
path IS the production one, including the analytic value-grad path that
engages only on batched GPU steps.

Protocol: per config, the robot is scripted along each seed's plan for
--ticks ticks (same _scripted_poses protocol as the parity tests); the
batched framework step runs all seeds at once (warm-start carries fed
back), the oracle runs per-seed in f64 on the host, and (v, w), status and
plan-prune cursor are compared per lane per tick.

Chaos-floor context for reading the numbers (CHAOS_FLOOR_r05.json, a CPU
study by tools/chaos_floor.py): representing the inputs in f32 AT ALL is a
~1e-7-scale perturbation that the 40-iteration nonconvex solve amplifies
to the same delta distribution this tool reports. Cap-bound lanes sit
wherever iteration 40 left them; converged-lane offenders root-cause to
tolerance-stops on flat valleys, not basin errors.

Usage:
  python tools/parity_on_chip.py --seeds 10 --ticks 3 --json out.json
  python tools/parity_on_chip.py --cpu      # the same protocol on the CPU
"""

import argparse
import json
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--configs", default="social,obstacle,omni6,stress36")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    sys.path.insert(0, ".")
    from nav2_social_mpc_controller_tpu.core.config import (
        benchmark_obstacle_only_config,
        benchmark_omni_6agents_config,
        benchmark_social_config,
        benchmark_stress_h36_config,
    )
    from nav2_social_mpc_controller_tpu.core.types import RobotState
    from nav2_social_mpc_controller_tpu.controller.controller import (
        make_carry,
        make_step_batch,
    )
    from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario
    from nav2_social_mpc_controller_tpu.solver import lm
    from parity import oracle

    all_configs = {
        "social": (benchmark_social_config, 3),
        "obstacle": (benchmark_obstacle_only_config, 0),
        "omni6": (benchmark_omni_6agents_config, 6),
        "stress36": (benchmark_stress_h36_config, 3),
    }
    configs = {k: all_configs[k] for k in args.configs.split(",")}

    platform = jax.devices()[0].platform
    print(f"backend: {platform}", file=sys.stderr)

    def scripted_poses(sc, n_ticks, stride=4):
        pts = np.asarray(sc.path.points, np.float64)
        yaw = np.asarray(sc.path.yaw, np.float64)
        n = int(sc.path.n)
        return [
            np.array([pts[i, 0], pts[i, 1], yaw[i]])
            for i in (min(t * stride, n - 1) for t in range(n_ticks))
        ]

    def to_f32(tree):
        return jax.tree.map(
            lambda x: jnp.asarray(x, jnp.float32)
            if np.issubdtype(np.asarray(x).dtype, np.floating)
            else jnp.asarray(x),
            tree,
        )

    def stack(trees):
        return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)

    def run_device_batch(cfg, sc32_b, poses_per_seed, n_seeds):
        """Batched framework rollout; returns per (tick, seed) rows."""
        step_b = make_step_batch(cfg)
        carry = jax.vmap(lambda _: make_carry(cfg))(jnp.arange(n_seeds))
        out = []
        for t in range(args.ticks):
            poses_t = jnp.asarray(
                np.stack([poses_per_seed[s][t] for s in range(n_seeds)]),
                jnp.float32,
            )
            sc_t = sc32_b._replace(
                robot=RobotState(pose=poses_t, speed=sc32_b.robot.speed)
            )
            cmd, aux, carry = step_b(sc_t, carry)
            out.append(
                dict(
                    v=np.asarray(cmd.linear_x, np.float64),
                    w=np.asarray(cmd.angular_z, np.float64),
                    status=np.asarray(aux.status),
                    prune=np.asarray(aux.plan_start_index),
                    iters=np.asarray(aux.solve.iterations),
                    capped=np.asarray(aux.solve.termination) == lm.TERM_NO_CONVERGENCE,
                )
            )
        return out

    rows = []
    for name, (cfg_fn, n_people) in configs.items():
        cfg = cfg_fn()
        sc64s = [
            make_scenario(cfg, seed=s, n_valid_people=n_people, dtype=np.float64)
            for s in range(args.seeds)
        ]
        poses_per_seed = [scripted_poses(sc, args.ticks) for sc in sc64s]

        sc32_b = stack([to_f32(sc) for sc in sc64s])
        device_out = run_device_batch(cfg, sc32_b, poses_per_seed, args.seeds)
        print(f"[{name}] device batches done", file=sys.stderr)

        for s in range(args.seeds):
            sc64 = sc64s[s]
            plan_pts = [tuple(p) for p in np.asarray(sc64.path.points[: int(sc64.path.n)])]
            n0 = len(plan_pts)
            memory = {}
            cm = (np.asarray(sc64.costmap.data, np.float64),
                  np.asarray(sc64.costmap.origin, np.float64),
                  float(sc64.costmap.resolution))
            es = (np.asarray(sc64.esdf.distances, np.float64),
                  np.asarray(sc64.esdf.indexes),
                  np.asarray(sc64.esdf.origin, np.float64),
                  float(sc64.esdf.resolution), bool(sc64.esdf.valid))
            for t, pose in enumerate(poses_per_seed[s]):
                o_cmd, o_status, plan_pts = oracle.oracle_step(
                    cfg, plan_pts, pose, np.asarray(sc64.robot.speed, np.float64),
                    np.asarray(sc64.people.state, np.float64), cm, es, memory,
                )
                fr = device_out[t]
                rows.append(
                    dict(
                        config=name, seed=s, tick=t,
                        dv=abs(float(fr["v"][s]) - o_cmd[0]),
                        dw=abs(float(fr["w"][s]) - o_cmd[2]),
                        status_match=int(fr["status"][s]) == o_status,
                        prune_match=int(fr["prune"][s]) == n0 - len(plan_pts),
                        fw_iters=int(fr["iters"][s]),
                        capped=bool(fr["capped"][s]),
                        o_capped=bool(memory.get("last_solve_capped", False)),
                    )
                )
        print(f"[{name}] {args.seeds * args.ticks} lanes compared", file=sys.stderr)

    def stats(sel):
        if not sel:
            return {}
        d = np.array([max(r["dv"], r["dw"]) for r in sel])
        return dict(
            n=len(sel),
            p50=float(np.percentile(d, 50)),
            p90=float(np.percentile(d, 90)),
            max=float(d.max()),
            within_1e3=float(np.mean(d <= 1e-3)),
        )

    out = {
        "backend": platform,
        "protocol": "batched make_step_batch (production path)",
        "seeds": args.seeds,
        "ticks": args.ticks,
        "status_match_frac": float(np.mean([r["status_match"] for r in rows])),
        "prune_match_frac": float(np.mean([r["prune_match"] for r in rows])),
        "all": stats(rows),
        "converged_lanes": stats([r for r in rows if not r["capped"]]),
        "cap_bound_lanes": stats([r for r in rows if r["capped"]]),
        "per_config": {
            name: stats([r for r in rows if r["config"] == name]) for name in configs
        },
    }
    print(json.dumps(out, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
