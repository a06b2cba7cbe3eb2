#!/usr/bin/env python
"""Warm-start iteration economics study (round-2 verdict item 3).

Question: a carry-warm solve whose scenario moved ~1 um since the previous
tick still burns ~33 LM iterations — why, and what would a real warm start
buy?

Protocols (both fully jitted scans over ticks, iteration counts and first
commands captured per tick):
  * bench      — the throughput bench's loop: same scenario every tick with a
                 1e-6*t pose perturbation, carry feeding back.
  * closedloop — the simulator's loop: the robot integrates its own command
                 and pedestrians advance under the SFM each tick.

Modes compared (OptimizerConfig.warm_start_mode):
  * reference         — exact reference semantics: block b starts from
                        optimization ROW b's velocity (measured speed /
                        0.5-blend of trajectorizer and previous cmds at steps
                        0..B-1) — optimizer.cpp:256-260, :484-551.
  * previous_solution — framework extension: block b starts from the
                        previous tick's own block-b optimum.

Outputs per (protocol, mode): per-tick iteration mean/max/frac-at-cap, plus
command deltas between the modes per tick, plus wall-clock per tick. One
JSON summary line at the end.

Usage: python tools/warm_start_study.py [--config social] [--batch 256]
       [--ticks 20] [--json out.json]
"""

import argparse
import dataclasses
import functools
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_program(cfg, protocol, batch):
    from nav2_social_mpc_controller_tpu.controller.controller import make_carry, step
    from nav2_social_mpc_controller_tpu.models.motion import integrate_step
    from nav2_social_mpc_controller_tpu.runtime.simulator import _advance_people

    vstep = jax.vmap(functools.partial(step, cfg))

    def tick_bench(state, t):
        scb, carry = state
        eps = (1e-6 * t).astype(scb.robot.pose.dtype)
        scb_t = scb._replace(robot=scb.robot._replace(pose=scb.robot.pose + eps))
        cmd, aux, carry = vstep(scb_t, carry)
        out = (aux.solve.iterations, cmd.linear_x, cmd.angular_z, aux.solve.termination)
        return (scb, carry), out

    def tick_closed(state, t):
        scb, carry = state
        cmd, aux, carry = vstep(scb, carry)
        pose = scb.robot.pose

        def advance(pose, cmd_v, cmd_y, cmd_w):
            x, y, th = integrate_step(
                pose[0], pose[1], pose[2], cmd_v, cmd_y, cmd_w, cfg.trajectorizer.time_step
            )
            return jnp.stack([x, y, th])

        new_pose = jax.vmap(advance)(pose, cmd.linear_x, cmd.linear_y, cmd.angular_z)
        new_speed = jnp.stack([cmd.linear_x, cmd.angular_z], axis=-1)
        people = jax.vmap(
            functools.partial(_advance_people, cfg), in_axes=(0, 0, 0, 0, None)
        )(scb.people, pose, scb.robot.speed, scb.esdf, cfg.trajectorizer.time_step)
        scb = scb._replace(
            robot=scb.robot._replace(pose=new_pose, speed=new_speed), people=people
        )
        out = (aux.solve.iterations, cmd.linear_x, cmd.angular_z, aux.solve.termination)
        return (scb, carry), out

    tick = {"bench": tick_bench, "closedloop": tick_closed}[protocol]

    @jax.jit
    def run(scb, n_ticks_arr):
        carry0 = jax.vmap(lambda _: make_carry(cfg))(jnp.arange(batch))
        (_, _), outs = jax.lax.scan(tick, (scb, carry0), n_ticks_arr)
        return outs  # each (T, batch)

    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="social",
                    choices=["social", "obstacle", "omni6", "stress36"])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--json", default=None)
    ap.add_argument("--protocols", default="bench,closedloop")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (iteration counts are "
                    "platform-independent; only wall-clock needs the GPU)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, ".")
    from bench import CONFIG_PEOPLE, get_config, make_batch

    base_cfg = get_config(args.config)
    scb, batch = make_batch(base_cfg, args.batch, CONFIG_PEOPLE[args.config])
    ticks = jnp.arange(args.ticks, dtype=jnp.float32)

    summary = {"config": args.config, "batch": batch, "ticks": args.ticks,
               "cap": base_cfg.optimizer.max_iterations, "protocols": {}}

    for protocol in args.protocols.split(","):
        results = {}
        for mode in ["reference", "previous_solution"]:
            cfg = dataclasses.replace(
                base_cfg, optimizer=dataclasses.replace(base_cfg.optimizer, warm_start_mode=mode)
            )
            run = build_program(cfg, protocol, batch)
            t0 = time.perf_counter()
            iters, vx, wz, term = jax.block_until_ready(run(scb, ticks))
            compile_and_run = time.perf_counter() - t0
            t0 = time.perf_counter()
            iters, vx, wz, term = jax.block_until_ready(run(scb, ticks))
            np.asarray(iters)
            wall = time.perf_counter() - t0
            results[mode] = dict(
                iters=np.asarray(iters), vx=np.asarray(vx), wz=np.asarray(wz),
                term=np.asarray(term), wall=wall, compile_s=compile_and_run - wall,
            )
            log(f"[{protocol}/{mode}] {wall*1e3:.1f} ms for {args.ticks} ticks x {batch}")

        cap = base_cfg.optimizer.max_iterations
        rows = []
        print(f"\n=== protocol: {protocol} (config {args.config}, batch {batch}) ===")
        print(f"{'tick':>4} | {'ref mean':>8} {'ref max':>7} {'ref@cap':>8} | "
              f"{'prev mean':>9} {'prev max':>8} {'prev@cap':>8} | "
              f"{'d_vx max':>9} {'d_wz max':>9}")
        for t in range(args.ticks):
            ri = results["reference"]["iters"][t]
            pi = results["previous_solution"]["iters"][t]
            dvx = np.abs(results["reference"]["vx"][t] - results["previous_solution"]["vx"][t])
            dwz = np.abs(results["reference"]["wz"][t] - results["previous_solution"]["wz"][t])
            row = dict(
                tick=t,
                ref_mean=float(ri.mean()), ref_max=int(ri.max()),
                ref_cap_frac=float((ri >= cap).mean()),
                prev_mean=float(pi.mean()), prev_max=int(pi.max()),
                prev_cap_frac=float((pi >= cap).mean()),
                d_vx_max=float(dvx.max()), d_wz_max=float(dwz.max()),
            )
            rows.append(row)
            print(f"{t:>4} | {row['ref_mean']:>8.1f} {row['ref_max']:>7d} "
                  f"{row['ref_cap_frac']:>8.2f} | {row['prev_mean']:>9.1f} "
                  f"{row['prev_max']:>8d} {row['prev_cap_frac']:>8.2f} | "
                  f"{row['d_vx_max']:>9.4f} {row['d_wz_max']:>9.4f}")

        warm = rows[1:]
        # Command-deviation distribution over all warm (tick, lane) samples:
        # the max alone hides that deviations concentrate in the cap-bound
        # (non-converged) lanes.
        dv = np.abs(results["reference"]["vx"][1:] - results["previous_solution"]["vx"][1:])
        dw = np.abs(results["reference"]["wz"][1:] - results["previous_solution"]["wz"][1:])
        dmax = np.maximum(dv, dw).reshape(-1)
        proto_summary = dict(
            per_tick=rows,
            warm_ref_mean=float(np.mean([r["ref_mean"] for r in warm])),
            warm_ref_max=int(np.max([r["ref_max"] for r in warm])),
            warm_prev_mean=float(np.mean([r["prev_mean"] for r in warm])),
            warm_prev_max=int(np.max([r["prev_max"] for r in warm])),
            d_vx_max=float(np.max([r["d_vx_max"] for r in warm])),
            d_wz_max=float(np.max([r["d_wz_max"] for r in warm])),
            d_cmd_p50=float(np.percentile(dmax, 50)),
            d_cmd_p90=float(np.percentile(dmax, 90)),
            d_cmd_p99=float(np.percentile(dmax, 99)),
            d_cmd_frac_within_1e3=float((dmax <= 1e-3).mean()),
            d_cmd_frac_within_0_05=float((dmax <= 0.05).mean()),
            wall_ref_s=results["reference"]["wall"],
            wall_prev_s=results["previous_solution"]["wall"],
            speedup=results["reference"]["wall"] / results["previous_solution"]["wall"],
        )
        # Termination-code histogram on the last warm tick (see solver/lm.py
        # TERM_*: 0 cap, 1 fn_tol, 2 param_tol, 3 gradient_tol).
        for mode in results:
            term = results[mode]["term"][-1]
            proto_summary[f"term_hist_{mode}"] = {
                int(k): int(v) for k, v in zip(*np.unique(term, return_counts=True))
            }
        summary["protocols"][protocol] = proto_summary
        print(f"warm ticks: ref mean {proto_summary['warm_ref_mean']:.1f} / "
              f"prev mean {proto_summary['warm_prev_mean']:.1f} iters; "
              f"wall {proto_summary['wall_ref_s']*1e3:.1f} -> "
              f"{proto_summary['wall_prev_s']*1e3:.1f} ms "
              f"({proto_summary['speedup']:.2f}x); "
              f"cmd delta p50/p90/p99 {proto_summary['d_cmd_p50']:.4f}/"
              f"{proto_summary['d_cmd_p90']:.4f}/{proto_summary['d_cmd_p99']:.4f} "
              f"(max vx {proto_summary['d_vx_max']:.4f} wz {proto_summary['d_wz_max']:.4f}; "
              f"{100*proto_summary['d_cmd_frac_within_1e3']:.1f}% within 1e-3)")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "protocols"}))


if __name__ == "__main__":
    main()
