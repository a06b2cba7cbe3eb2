"""Framework CLI: the user-facing runtime surface the reference delegates to
ROS 2 tooling (`ros2 launch` + Nav2 controller_server + rviz).

Subcommands:
  step    one controller tick on a synthetic scenario (or a reference-format
          params YAML) — prints the command and solve telemetry as JSON
  sim     closed-loop simulation campaign (the Gazebo-validation analogue,
          runtime/simulator.py) — prints behavioral metrics
  bench   batched-throughput measurement on the ambient platform
  dryrun  multi-device sharding dry run on a virtual CPU mesh
  config  load + resolve a config and dump it as JSON

Examples:
  python -m nav2_social_mpc_controller_tpu step --config social
  python -m nav2_social_mpc_controller_tpu sim --ticks 120 --people 3
  python -m nav2_social_mpc_controller_tpu bench --batch 1024 --iters 5
  python -m nav2_social_mpc_controller_tpu dryrun --devices 8
  python -m nav2_social_mpc_controller_tpu config --yaml params.yaml
"""

import argparse
import dataclasses
import json
import sys
import time


def _named_config(name: str, yaml_path=None):
    from nav2_social_mpc_controller_tpu.core.config import (
        benchmark_obstacle_only_config,
        benchmark_omni_6agents_config,
        benchmark_social_config,
        benchmark_stress_h36_config,
        load_config_from_yaml,
    )

    if yaml_path:
        return load_config_from_yaml(yaml_path)
    return {
        "social": benchmark_social_config,
        "obstacle": benchmark_obstacle_only_config,
        "omni6": benchmark_omni_6agents_config,
        "stress36": benchmark_stress_h36_config,
        "default": lambda: __import__(
            "nav2_social_mpc_controller_tpu.core.config", fromlist=["SocialMPCConfig"]
        ).SocialMPCConfig(),
    }[name]()


def _maybe_force_cpu(args):
    if getattr(args, "platform", None) == "cpu":
        import jax

        # The config flag, set before the first computation, wins over
        # whatever the environment selected.
        jax.config.update("jax_platforms", "cpu")


def _add_common(p):
    p.add_argument("--config", default="social",
                   choices=["social", "obstacle", "omni6", "stress36", "default"])
    p.add_argument("--yaml", default=None, help="reference-format params YAML (overrides --config)")
    p.add_argument("--platform", default=None, choices=[None, "cpu"],
                   help="force the CPU backend (default: JAX's default platform)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--people", type=int, default=3)


def cmd_step(args):
    _maybe_force_cpu(args)
    from nav2_social_mpc_controller_tpu.controller.controller import make_carry, make_step
    from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario

    cfg = _named_config(args.config, args.yaml)
    if getattr(args, "debug_optimizer", False):
        cfg = dataclasses.replace(
            cfg, optimizer=dataclasses.replace(cfg.optimizer, debug_optimizer=True)
        )
    sc = make_scenario(cfg, seed=args.seed, n_valid_people=args.people)
    cmd, aux, _ = make_step(cfg)(sc, make_carry(cfg))
    out = {
        "linear_x": float(cmd.linear_x),
        "linear_y": float(cmd.linear_y),
        "angular_z": float(cmd.angular_z),
        "status": int(aux.status),
        "lm_iterations": int(aux.solve.iterations),
        "initial_cost": float(aux.solve.initial_cost),
        "final_cost": float(aux.solve.final_cost),
        "termination": int(aux.solve.termination),
        "usable": bool(aux.solve.usable),
    }
    if aux.lm_trace is not None:
        # Ceres PER_MINIMIZER_ITERATION-style rows (optimizer.cpp:122-130)
        n_it = int(aux.solve.iterations)
        tr = aux.lm_trace
        out["iterations"] = [
            {
                "iter": i,
                "cost": float(tr.cost[i]),
                "cost_change": float(tr.cost_change[i]),
                "gradient_max": float(tr.grad_max[i]),
                "step_norm": float(tr.step_norm[i]),
                "tr_ratio": float(tr.tr_ratio[i]),
                "tr_radius": float(tr.tr_radius[i]),
                "accepted": bool(tr.accepted[i]),
            }
            for i in range(n_it)
        ]
    print(json.dumps(out))


def cmd_sim(args):
    _maybe_force_cpu(args)
    import numpy as np

    from nav2_social_mpc_controller_tpu.runtime.simulator import make_simulate
    from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario

    cfg = _named_config(args.config, args.yaml)
    sc = make_scenario(cfg, seed=args.seed, n_valid_people=args.people)
    res = make_simulate(cfg, args.ticks)(sc)
    cmds = np.asarray(res.cmds)
    status = np.asarray(res.status)
    out = {
        "ticks": args.ticks,
        "goal_dist_final": float(res.goal_dist),
        "min_people_dist": float(res.min_people_dist),
        "mean_v": float(cmds[:, 0].mean()),
        "max_v": float(cmds[:, 0].max()),
        "max_abs_w": float(np.abs(cmds[:, 1]).max()),
        "status_ok_frac": float((status == 0).mean()),
        "robot_final_pose": [float(x) for x in np.asarray(res.robot_traj[-1])],
    }
    if args.dump_traj:
        np.savez(args.dump_traj, robot_traj=np.asarray(res.robot_traj),
                 people_traj=np.asarray(res.people_traj), cmds=cmds, status=status)
        out["trajectory_file"] = args.dump_traj
    print(json.dumps(out))


def cmd_bench(args):
    _maybe_force_cpu(args)
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from nav2_social_mpc_controller_tpu.controller.controller import make_carry, step
    from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario_batch

    cfg = _named_config(args.config, args.yaml)
    scb = jax.tree.map(jnp.asarray,
                       make_scenario_batch(cfg, args.batch, n_valid_people=args.people))
    carry0 = jax.vmap(lambda _: make_carry(cfg))(jnp.arange(args.batch))
    vstep = jax.vmap(functools.partial(step, cfg))

    @functools.partial(jax.jit, static_argnames="n")
    def run(scb, carry, n):
        def tick(c, i):
            eps = (1e-6 * i).astype(scb.robot.pose.dtype)
            cmd, aux, c = vstep(scb._replace(robot=scb.robot._replace(pose=scb.robot.pose + eps)), c)
            return c, cmd.linear_x[0]
        carry, v0 = jax.lax.scan(tick, carry, jnp.arange(n))
        return v0[-1]

    t0 = time.perf_counter()
    np.asarray(run(scb, carry0, 1))
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.asarray(run(scb, carry0, args.iters))
    total = time.perf_counter() - t0
    per_tick = total / args.iters
    print(json.dumps({
        "metric": f"social_mpc_solves_per_s_H{cfg.optimizer.control_horizon}_{args.config}",
        "value": round(args.batch / per_tick, 1),
        "unit": "solves/s/chip",
        "batch": args.batch,
        "iters": args.iters,
        "batch_latency_ms": round(per_tick * 1e3, 3),
        "warmup_s": round(warm, 2),
        "platform": jax.devices()[0].platform,
    }))


def cmd_dryrun(args):
    import __main__  # noqa: F401  (no-op; keeps linters quiet about globals)

    sys.path.insert(0, ".")
    try:
        from __graft_entry__ import dryrun_multichip
    except ImportError:
        from nav2_social_mpc_controller_tpu.parallel.mesh import (
            make_distributed_step,
            make_mesh,
            shard_batch,
        )
        import jax
        import jax.numpy as jnp

        from nav2_social_mpc_controller_tpu.controller.controller import make_carry
        from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario_batch

        def dryrun_multichip(n):
            cfg = _named_config(args.config, args.yaml)
            mesh = make_mesh(n)
            scb = shard_batch(mesh, jax.tree.map(
                jnp.asarray, make_scenario_batch(cfg, n, n_valid_people=args.people, grid_hw=(64, 64))))
            carry = shard_batch(mesh, jax.vmap(lambda _: make_carry(cfg))(jnp.arange(n)))
            cmd, aux, carry, metrics = make_distributed_step(cfg, mesh)(scb, carry)
            jax.block_until_ready(cmd)

    dryrun_multichip(args.devices)
    print(json.dumps({"dryrun": "ok", "devices": args.devices}))


def cmd_config(args):
    cfg = _named_config(args.config, args.yaml)
    print(json.dumps(dataclasses.asdict(cfg), indent=2))


def cmd_multihost(args):
    """Multi-host campaign runner (BASELINE config 5): scenario fleet over a
    global batch mesh with warm-start carry + checkpoint/resume.

    Modes:
      default           real pod — jax.distributed auto-detect, one process
                        per host (launch this on every host)
      --processes N     local fake cluster: spawn N coordinated worker
                        processes x --devices-per-process virtual CPU devices
      --worker          internal: a spawned fake-cluster worker
    """
    from nav2_social_mpc_controller_tpu.runtime import campaign

    tail = [
        "--config", args.config,
        "--ticks", str(args.ticks),
        "--per-device-batch", str(args.per_device_batch),
        "--people", str(args.people),
        "--seed", str(args.seed),
    ]
    if args.yaml:
        tail += ["--yaml", args.yaml]
    if args.checkpoint:
        tail += ["--checkpoint", args.checkpoint]
    if args.checkpoint_every:
        tail += ["--checkpoint-every", str(args.checkpoint_every)]
    if args.resume:
        tail += ["--resume"]

    if args.processes and not args.worker:
        results = campaign.spawn_fake_cluster(
            tail, args.processes, args.devices_per_process, port=args.port
        )
        ok = all(rc == 0 for rc, _ in results)
        for pid, (rc, out) in enumerate(results):
            if rc != 0:
                sys.stderr.write(f"--- worker {pid} (rc {rc}) ---\n{out[-3000:]}\n")
        # Proc 0 prints the summary JSON as its last line.
        last = results[0][1].strip().splitlines()[-1] if results[0][1].strip() else "{}"
        print(last)
        sys.exit(0 if ok else 1)

    import jax

    if args.force_cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.worker:
        from nav2_social_mpc_controller_tpu.parallel import multihost

        multihost.initialize(args.coordinator, args.num_processes, args.process_id)
    elif jax.process_count() == 1 and args.coordinator:
        from nav2_social_mpc_controller_tpu.parallel import multihost

        multihost.initialize(args.coordinator, args.num_processes, args.process_id)
    else:
        # A cluster whose environment JAX can read (e.g. SLURM):
        # auto-detection.
        try:
            jax.distributed.initialize()
        except Exception as e:  # single-process fallback (still functional)
            sys.stderr.write(f"jax.distributed auto-init unavailable ({e}); "
                             "running single-process\n")

    cfg = _named_config(args.config, args.yaml)
    summary = campaign.run_campaign(
        cfg,
        ticks=args.ticks,
        per_device_batch=args.per_device_batch,
        n_people=args.people,
        seed=args.seed,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        log=lambda m: sys.stderr.write(m + "\n"),
    )
    print(json.dumps(summary))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="social-mpc-tpu", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("step", help="one controller tick")
    _add_common(p)
    p.add_argument("--debug-optimizer", action="store_true",
                   help="per-LM-iteration trace (Ceres PER_MINIMIZER_ITERATION analogue)")
    p.set_defaults(fn=cmd_step)

    p = sub.add_parser("sim", help="closed-loop simulation")
    _add_common(p)
    p.add_argument("--ticks", type=int, default=100)
    p.add_argument("--dump-traj", default=None, help="write trajectories to this .npz")
    p.set_defaults(fn=cmd_sim)

    p = sub.add_parser("bench", help="batched throughput measurement")
    _add_common(p)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=5)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("dryrun", help="multi-device sharding dry run")
    _add_common(p)
    p.add_argument("--devices", type=int, default=8)
    p.set_defaults(fn=cmd_dryrun)

    p = sub.add_parser("config", help="resolve + dump a config as JSON")
    _add_common(p)
    p.set_defaults(fn=cmd_config)

    p = sub.add_parser("multihost", help="multi-host scenario campaign (BASELINE config 5)")
    _add_common(p)
    p.add_argument("--ticks", type=int, default=10)
    p.add_argument("--per-device-batch", type=int, default=8)
    p.add_argument("--checkpoint", default=None, help="carry checkpoint base path")
    p.add_argument("--checkpoint-every", type=int, default=0, help="ticks between snapshots")
    p.add_argument("--resume", action="store_true", help="restore carry from --checkpoint")
    p.add_argument("--processes", type=int, default=0,
                   help="spawn a local fake cluster of N worker processes")
    p.add_argument("--devices-per-process", type=int, default=4)
    p.add_argument("--port", type=int, default=0,
                   help="coordinator port (0 = pick an ephemeral port)")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    p.add_argument("--num-processes", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--process-id", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--force-cpu", action="store_true", help=argparse.SUPPRESS)
    p.set_defaults(fn=cmd_multihost)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
