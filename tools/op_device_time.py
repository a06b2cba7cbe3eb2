#!/usr/bin/env python
"""Device time per call, from a profiler trace, of the plain-XLA ops that
replaced the former hand-written kernels (batched bicubic sample, damped
SPD solve, LM propose/commit, SFM projection scan) — the figures a Hopper
kernel for one of them must beat. Also summarises any GPU profile.

  python tools/op_device_time.py [--batch 1024] [--configs social,stress36]
  python tools/op_device_time.py --summarize DIR   # e.g. bench.py --profile DIR

Each op runs at the config's real shapes (bench scenarios, B lanes), 20
calls inside one profiler trace; the device time per call is the union of
the event intervals on the GPU's stream lines over those calls. Writes
<--out>/op_device_time.json and prints it.
"""

import argparse
import functools
import glob
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from nav2_social_mpc_controller_tpu.controller.controller import (  # noqa: E402
    make_carry,
    step_pre,
)
from nav2_social_mpc_controller_tpu.controller.optimize import ProblemDims  # noqa: E402
from nav2_social_mpc_controller_tpu.utils.device import (  # noqa: E402
    device_summary,
    setup_compile_cache,
)


def prepared_inputs(name, batch):
    """(cfg, dims, u0, rows, n_rows, scenario batch) at the bench's size."""
    cfg = bench.get_config(name)
    scb, b = bench.make_batch(cfg, batch, bench.CONFIG_PEOPLE[name])
    carry = jax.vmap(lambda _: make_carry(cfg))(jnp.arange(b))
    prep = jax.jit(jax.vmap(functools.partial(step_pre, cfg)))(scb, carry).prep
    return cfg, ProblemDims.from_config(cfg), prep.u0, prep.rows, prep.n_rows, scb


def trace_lines(tag):
    """Per device line: events, busy union (ns) and the top event names by
    total duration, from the newest xplane under tag."""
    path = sorted(glob.glob(f"{tag}/plugins/profile/*/*.xplane.pb"))[-1]
    from jax.profiler import ProfileData

    lines = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            ivs = sorted((e.start_ns, e.start_ns + e.duration_ns) for e in evs)
            busy, end = 0.0, -1.0
            for s0, e0 in ivs:
                if s0 > end:
                    busy += e0 - s0
                    end = e0
                elif e0 > end:
                    busy += e0 - end
                    end = e0
            tot = {}
            for e in evs:
                tot[e.name] = tot.get(e.name, 0.0) + e.duration_ns
            top = sorted(tot.items(), key=lambda kv: -kv[1])[:25]
            lines[f"{plane.name}|{line.name}"] = {
                "events": len(ivs), "busy_ns": busy,
                "span_ns": (ivs[-1][1] - ivs[0][0]) if ivs else 0.0, "top": top,
            }
    return lines


def device_time_per_call(fn, args, trace_dir, calls=20):
    """Device busy time per call from a profiler trace: the union of the
    event intervals on the GPU plane's stream lines, over `calls` calls."""
    jfn = jax.jit(fn)
    jax.block_until_ready(jfn(*args))
    tag = f"{trace_dir}/{getattr(fn, '__name__', 'op')}_{time.time_ns()}"
    with jax.profiler.trace(tag):
        for _ in range(calls):
            out = jfn(*args)
        jax.block_until_ready(out)
    lines = trace_lines(tag)
    stream = {k: v for k, v in lines.items() if "Stream" in k}
    busy = sum(v["busy_ns"] for v in (stream or lines).values())
    return {"us_per_call": busy / calls / 1e3, "lines": lines}


def op_cases(cfg, dims, u0, rows, n_rows, scb):
    """The plain-XLA replacements of the former kernels, at real shapes."""
    from nav2_social_mpc_controller_tpu.models.sfm import project_people
    from nav2_social_mpc_controller_tpu.solver import lm
    from nav2_social_mpc_controller_tpu.world.grid import bicubic_linearize

    b, d = u0.shape
    s = dims.s
    win = cfg.optimizer.obstacle_window_cells
    rng = np.random.default_rng(0)
    grid = jnp.asarray(np.rint(rng.uniform(0, 254, (b, win, win))), jnp.float32)
    coords = jnp.asarray(rng.uniform(0, win - 1, (2, b, s)), jnp.float32)
    m = rng.standard_normal((b, d, d)).astype(np.float32)
    spd = jnp.asarray(np.einsum("bij,bkj->bik", m, m) + np.eye(d, dtype=np.float32))
    rhs = jnp.asarray(rng.standard_normal((b, d)), jnp.float32)
    lm_cfg = lm.LMConfig(max_iterations=cfg.optimizer.max_iterations)
    radius = jnp.full((b,), 10.0, jnp.float32)
    lo = jnp.full((b, d), -1.0, jnp.float32)
    hi = jnp.full((b, d), 1.0, jnp.float32)

    def propose(u, g, jtj, r, lo, hi):
        return jax.vmap(functools.partial(lm.propose, lm_cfg))(u, g, jtj, r, lo, hi)

    st = lm._LMState(
        u=u0, cost=jnp.ones((b,)), g=rhs, jtj=spd, radius=radius,
        decrease_factor=jnp.full((b,), 2.0), iters=jnp.zeros((b,), jnp.int32),
        done=jnp.zeros((b,), bool), term=jnp.zeros((b,), jnp.int32),
        failed=jnp.zeros((b,), bool), trace=None,
    )

    def commit(st, u_new, delta, mc, c, g, j):
        return jax.vmap(lambda *a: lm.commit(lm_cfg, *a)[0])(st, u_new, delta, mc, c, g, j)

    def sfm(people, rows, n_rows, dist, idx, org, res, valid):
        return jax.vmap(
            lambda *a: project_people(
                *a, maxtime=cfg.trajectorizer.max_time, dt=cfg.trajectorizer.time_step,
                people_desired_vel=cfg.people_desired_vel,
                people_radius=cfg.people_radius,
                robot_desired_vel=cfg.robot_sfm_desired_vel,
                robot_radius=cfg.robot_sfm_radius, goal_radius=cfg.goal_radius,
                esdf_window=cfg.esdf_window_cells,
            )
        )(people, rows, n_rows, dist, idx, org, res, valid)

    e = scb.esdf
    return {
        "bicubic": (lambda g, r, c: jax.vmap(bicubic_linearize)(g, r, c),
                    (grid, coords[0], coords[1])),
        "spd_solve": (jax.vmap(lm.default_linear_solve), (spd, rhs)),
        "propose": (propose, (u0, rhs, spd, radius, lo, hi)),
        "commit": (commit, (st, u0, rhs, jnp.ones((b,)), jnp.ones((b,)) * 0.5, rhs, spd)),
        "sfm_scan": (sfm, (scb.people.state, rows, n_rows, e.distances, e.indexes,
                           e.origin, e.resolution, e.valid)),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--configs", default="social,stress36")
    ap.add_argument("--out", default="measurements", help="output directory")
    ap.add_argument("--summarize", metavar="DIR",
                    help="only print the per-line summary of the profile under DIR")
    args = ap.parse_args()
    if args.summarize:
        print(json.dumps(trace_lines(args.summarize), indent=1))
        return

    cache = setup_compile_cache()
    dev = device_summary()
    print(f"device {dev} cache {cache}", flush=True)
    if dev["platform"] != "gpu":
        sys.exit("needs a GPU")
    out = {"device": dev, "batch": args.batch, "configs": {}}
    for name in args.configs.split(","):
        cfg, dims, u0, rows, n_rows, scb = prepared_inputs(name, args.batch)
        out["configs"][name] = {
            k: device_time_per_call(f, a, os.path.join(args.out, "traces"))["us_per_call"]
            for k, (f, a) in op_cases(cfg, dims, u0, rows, n_rows, scb).items()
        }
        print(f"[{name}] us per call: {out['configs'][name]}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "op_device_time.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
