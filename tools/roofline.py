#!/usr/bin/env python
"""Whole-tick roofline / MFU accounting (VERDICT r2 item 1).

Answers "how far from the hardware ceiling is the tick?" with three
ingredients, all measured on the CURRENT backend:

1. CALIBRATED ceilings — microbenchmarks measure this device's achievable
   bf16 matrix flops/s, f32 elementwise flops/s, and HBM stream bandwidth
   (the calibration numbers are what a kernel can actually reach; state
   published peaks, with the card's power limit, beside them).
2. XLA's own per-executable cost model — compiled.cost_analysis() gives
   exact HLO flop and byte counts per stage program (no hand-counted flops).
3. Measured wall time per stage — bench.py's slope protocol: each stage runs
   inside ONE dynamic-n fori_loop program (every float input nudged by
   i*1e-30 so nothing hoists, every output leaf reduced into the carry so
   nothing dead-codes), timed at n=2 and n=N, cost = slope, so fixed
   dispatch cost cancels.

Per stage this yields: measured time, flop/byte counts, the roofline bound
  t_bound = max(bytes / BW_meas, flops / FLOPS_meas)
(taking the elementwise ceiling for scalar-heavy stages and the matrix
ceiling for the dot-dominated ones is reported as both utilizations; the
bound uses the stage's dominant unit), and headroom = measured / t_bound.

Output: a ranked table + one JSON line. No device table keyed by
device_kind exists yet; PERF.md holds the interpretation.

Usage:
  python tools/roofline.py --config social --batch 1024
  python tools/roofline.py --calibrate-only
"""

import argparse
import functools
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _loop_time(fn, args, n1=2, n2=12, repeats=3):
    """Per-iteration cost of fn via the bench.py slope protocol: ONE dynamic-n
    fori_loop program (single dispatch per measurement), timed at n1 and n2
    iterations, cost = (t2 - t1)/(n2 - n1). This cancels the fixed
    dispatch + completion round-trip, which can exceed the programs being
    measured.

    fn(*args, i) may return any pytree; every leaf is sum-reduced into the
    loop carry so XLA can neither hoist the body out of the loop (callers
    make fn i-dependent) nor dead-code-eliminate any output. The extra
    reduce re-reads each stage's outputs once — accounted as part of the
    stage, negligible next to the stages' own traffic."""

    @jax.jit
    def run(n, *args):
        def body(i, acc):
            out = fn(*args, i)
            s = acc
            for leaf in jax.tree.leaves(out):
                s = s + jnp.sum(leaf).astype(jnp.float32)
            return s

        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    def timed(n):
        best = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(run(np.int32(n), *args))
            best = min(best, time.perf_counter() - t0)
        return best

    timed(n1)  # compile + warm
    t1, t2 = timed(n1), timed(n2)
    if t2 <= t1:  # noise swamped the loop; report a lower bound
        return t2 / n2
    return (t2 - t1) / (n2 - n1)


def calibrate(repeats=3):
    """Measure achievable ceilings on this device (slope protocol throughout)."""
    peaks = {}
    # bf16 matrix: big square matmul, i-dependent so nothing hoists out of the
    # timing loop (i*0 on an int does NOT fold once cast to bf16 at trace
    # time; keep the add on the f32 accumulator side to be safe).
    n = 4096
    a = jnp.ones((n, n), jnp.bfloat16)
    b = jnp.ones((n, n), jnp.bfloat16)

    def mm(a, b, i):
        # Perturb ONE row only: upcasting/downcasting the full 4096x4096
        # operand each iteration added hundreds of MB of HBM traffic per
        # ~137 GFLOP dot and biased the measured ceiling low (~82% of
        # nominal). The single-row epilogue is <0.1% of the dot's bytes.
        row = (a[0].astype(jnp.float32) + i * 1e-30).astype(jnp.bfloat16)
        ai = a.at[0].set(row)
        out = jnp.dot(ai, b, preferred_element_type=jnp.float32)
        # Square before the loop's sum-reduce: slicing or summing a plain dot
        # invites algebraic shortcuts (XLA rewrote dot(...)[0,0] into ONE
        # row-by-column product and read 3.6 PFLOP/s); sum(out*out) has none.
        return out * out

    t = _loop_time(mm, (a, b), n1=2, n2=16, repeats=repeats)
    peaks["matrix_bf16_flops"] = 2.0 * n * n * n / t

    # f32 matrix at HIGHEST precision (what the framework's exact one-hot
    # and stencil matmuls use). A DEFAULT-precision f32 dot may run in TF32
    # on the GPU.
    af = jnp.ones((n, n), jnp.float32)

    def mmf(a, b, i):
        out = jnp.dot(a + i * 1e-30, b, precision=jax.lax.Precision.HIGHEST)
        return out * out

    t = _loop_time(mmf, (af, af), n1=2, n2=10, repeats=repeats)
    peaks["matrix_f32_highest_flops"] = 2.0 * n * n * n / t

    # Elementwise f32: chained NONLINEAR maps on cache-resident tiles. An affine chain
    # (y = y*a + b) algebraically collapses in XLA's simplifier and reads as
    # an impossible peak; the Newton-for-reciprocal map y*(2 - y) (2 flops/
    # element/step, converges stably to 1) cannot fold. n_chains independent
    # chains fill the pipeline (one chain is latency-bound: each step
    # depends on the previous).
    m = (1024, 1024)
    n_chains = 8
    xs = tuple(jnp.full(m, 1.0 + 1e-7 * (k + 1), jnp.float32) for k in range(n_chains))
    k_steps = 32

    def elementwise(*args):
        *ys, i = args
        ys = [y + i * 1e-30 for y in ys]
        for _ in range(k_steps):
            ys = [y * (2.0 - y) for y in ys]
        # Full arrays out (the loop sum-reduces them): slicing here lets XLA
        # push the slice through the whole elementwise chain to scalar ops.
        return tuple(ys)

    # Long loops: per-iteration deltas of tens of us need n2 in the hundreds
    # to clear run-to-run jitter.
    t = _loop_time(elementwise, xs, n1=10, n2=400, repeats=repeats)
    peaks["elementwise_f32_flops"] = n_chains * (2.0 * k_steps + 2.0) * m[0] * m[1] / t

    # HBM stream: fused multiply-reduce over an array >> cache — pure-read
    # traffic of size bytes/iteration at ~0.5 flop/byte (bandwidth-bound).
    big = jnp.ones((64 * 1024 * 1024,), jnp.float32)  # 256 MB

    def stream(x, i):
        return jnp.sum(x * (1.0 + i * 1e-9))

    t = _loop_time(stream, (big,), n1=5, n2=100, repeats=repeats)
    peaks["hbm_stream_bytes"] = big.size * 4.0 / t
    return peaks


def _cost(compiled):
    ca = compiled.cost_analysis()
    d = ca[0] if isinstance(ca, (list, tuple)) else ca
    return float(d.get("flops", 0.0)), float(d.get("bytes accessed", 0.0))


def stage_programs(cfg, scb, carry, batch):
    """(name, fn, args, unit) per pipeline stage; unit selects the flop
    ceiling for the bound ('elementwise' or 'matrix')."""
    from nav2_social_mpc_controller_tpu.controller import optimize as opt
    from nav2_social_mpc_controller_tpu.controller.controller import step
    from nav2_social_mpc_controller_tpu.controller.trajectorizer import trajectorize
    from nav2_social_mpc_controller_tpu.models.sfm import project_people
    from nav2_social_mpc_controller_tpu.solver.lm import LMConfig, lm_solve

    dims = opt.ProblemDims.from_config(cfg)

    def s_traj(scb):
        return jax.vmap(functools.partial(trajectorize, cfg.trajectorizer))(
            scb.path, scb.robot.pose
        )

    traj = jax.jit(s_traj)(scb)

    def s_format(scb, traj, carry):
        return jax.vmap(functools.partial(opt.format_to_optimize, cfg, dims))(
            traj.poses, traj.cmds, traj.n_steps, scb.robot.speed, carry
        )

    rows_n = jax.jit(s_format)(scb, traj, carry)

    def s_proj(scb, rows_n):
        rows, n_rows = rows_n

        def one(people, rows, n_rows, esdf):
            return project_people(
                people, rows, n_rows, esdf.distances, esdf.indexes, esdf.origin,
                esdf.resolution, esdf.valid,
                maxtime=cfg.trajectorizer.max_time, dt=cfg.trajectorizer.time_step,
                esdf_window=cfg.esdf_window_cells,
            )

        return jax.vmap(one)(scb.people.state, rows, n_rows, scb.esdf)

    proj = jax.jit(s_proj)(scb, rows_n)

    def s_resid(scb, rows_n, proj):
        rows, n_rows = rows_n

        def one(rows, n_rows, proj, costmap):
            rfn = opt.build_residual_fn(
                cfg, dims, rows, n_rows, proj, jnp.asarray(True), costmap
            )
            u0 = rows[0 : dims.n_blocks, 4:6].reshape(-1)
            y, f_lin = jax.linearize(rfn, u0)
            j = jax.vmap(f_lin)(jnp.eye(u0.shape[0], dtype=u0.dtype))
            return y, j

        return jax.vmap(one)(rows, n_rows, proj, scb.costmap)

    def s_solve(scb, rows_n, proj):
        rows, n_rows = rows_n
        o = cfg.optimizer
        lm_cfg = LMConfig(o.max_iterations, o.fn_tol, o.gradient_tol, o.param_tol)

        def one(rows, n_rows, proj, costmap):
            rfn = opt.build_residual_fn(cfg, dims, rows, n_rows, proj, jnp.asarray(True), costmap)
            u0 = rows[0 : dims.n_blocks, 4:6].reshape(-1)
            lo = jnp.full((dims.n_blocks * 2,), -1e9, rows.dtype)
            hi = jnp.full((dims.n_blocks * 2,), 1e9, rows.dtype)
            return lm_solve(rfn, u0, lo, hi, lm_cfg)

        return jax.vmap(one)(rows, n_rows, proj, scb.costmap)

    def s_step(scb, carry):
        return jax.vmap(functools.partial(step, cfg))(scb, carry)

    return [
        ("trajectorize", s_traj, (scb,), "elementwise"),
        ("format_blend", s_format, (scb, traj, carry), "elementwise"),
        ("project_people", s_proj, (scb, rows_n), "elementwise"),
        ("residual+jacobian_x1", s_resid, (scb, rows_n, proj), "matrix"),
        ("lm_solve_full", s_solve, (scb, rows_n, proj), "matrix"),
        ("full_tick", s_step, (scb, carry), "matrix"),
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="social",
                    choices=["social", "obstacle", "omni6", "stress36"])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--loop-iters", type=int, default=10,
                    help="n2 of the slope protocol (per-stage loop length)")
    ap.add_argument("--calibrate-only", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    log("calibrating ceilings...")
    peaks = calibrate(repeats=args.repeats)
    for k, v in peaks.items():
        unit = "GB/s" if "bytes" in k else "GFLOP/s"
        log(f"  {k:22s} {v/1e9:12.1f} {unit}")
    if args.calibrate_only:
        print(json.dumps(peaks))
        return

    sys.path.insert(0, ".")
    from bench import CONFIG_PEOPLE, get_config, make_batch
    from nav2_social_mpc_controller_tpu.controller.controller import make_carry

    cfg = get_config(args.config)
    scb, batch = make_batch(cfg, args.batch, CONFIG_PEOPLE[args.config])
    carry = jax.vmap(lambda _: make_carry(cfg))(jnp.arange(batch))

    def perturbed(fn):
        """i-dependent variant: nudge every float leaf by i*1e-30 (numerically
        identity in f32; fuses into each leaf's first consumer) so XLA cannot
        hoist any part of the stage out of the timing loop."""

        def wrapped(*fa):
            *fargs, i = fa
            fargs = jax.tree.map(
                lambda x: x + i * 1e-30 if jnp.issubdtype(x.dtype, jnp.floating) else x,
                tuple(fargs),
            )
            return fn(*fargs)

        return wrapped

    rows = []
    mean_iters = None
    for name, fn, fargs, unit in stage_programs(cfg, scb, carry, batch):
        exe = jax.jit(fn).lower(*fargs).compile()
        flops, bytes_ = _cost(exe)
        t = _loop_time(perturbed(fn), fargs, n1=2, n2=args.loop_iters,
                       repeats=args.repeats)
        if name == "lm_solve_full":
            out = exe(*fargs)
            mean_iters = float(np.mean(np.asarray(out[1].iterations)))
        flop_peak = peaks["matrix_bf16_flops"] if unit == "matrix" else peaks["elementwise_f32_flops"]
        t_flops = flops / flop_peak
        t_bw = bytes_ / peaks["hbm_stream_bytes"]
        t_bound = max(t_flops, t_bw)
        rows.append(
            dict(
                stage=name,
                measured_ms=t * 1e3,
                flops=flops,
                bytes=bytes_,
                bound_ms=t_bound * 1e3,
                bound_kind="flops" if t_flops >= t_bw else "bandwidth",
                headroom=t / max(t_bound, 1e-12),
                mfu=flops / (t * peaks["matrix_bf16_flops"]),
                elem_util=flops / (t * peaks["elementwise_f32_flops"]),
                bw_util=bytes_ / (t * peaks["hbm_stream_bytes"]),
            )
        )
        log(f"  {name:22s} {t*1e3:9.2f} ms  ({flops/1e9:.2f} GFLOP, {bytes_/1e6:.1f} MB)")

    print(f"\n=== roofline ({args.config}, batch {batch}, "
          f"{jax.devices()[0].platform}) ===")
    print(f"{'stage':22s} {'meas ms':>9} {'bound ms':>9} {'headroom':>9} "
          f"{'bound':>10} {'MFU%':>6} {'ELEM%':>6} {'BW%':>6}")
    for r in rows:
        print(f"{r['stage']:22s} {r['measured_ms']:9.2f} {r['bound_ms']:9.3f} "
              f"{r['headroom']:8.1f}x {r['bound_kind']:>10} "
              f"{100*r['mfu']:6.2f} {100*r['elem_util']:6.1f} {100*r['bw_util']:6.1f}")

    full = rows[-1]
    out = {
        "config": args.config,
        "batch": batch,
        "platform": jax.devices()[0].platform,
        "peaks": peaks,
        "stages": rows,
        "mean_lm_iters": mean_iters,
        "headline": {
            "tick_ms": full["measured_ms"],
            "tick_headroom_vs_bound": full["headroom"],
            "tick_mfu": full["mfu"],
            "tick_elementwise_util": full["elem_util"],
            "tick_bw_util": full["bw_util"],
        },
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out["headline"]))


if __name__ == "__main__":
    main()
