#!/usr/bin/env python
"""Smoke test of the batched social-MPC controller on an NVIDIA GPU.

  python chip_smoke.py            # one card: value-grad, main-path, parity phases
  python chip_smoke.py --four     # four cards: sharded step vs one-card step

Drives the controller through its user entry points (make_step_batch,
make_step_batch_compacted, parallel.mesh.make_distributed_step) at the
bench's real size — B=1024 scenarios per card, 120x120 costmaps and ESDFs,
the four bench configs — with scenarios made from --seed by the native
generator, built from its sources on this machine.

Phases (one card):
  value-grad  the production LM value-and-gradient on the card (the
            analytic path, plain XLA — no hand-written kernel survived the
            measurement in PERF.md) and the linearize path: per-call times,
            each chained inside one executable and fenced with
            block_until_ready; at the end, max|d|/max|ref| <= F32_REL_TOL
            (1e-5, ops/fused_iter.py) on cost, g and JtJ against the
            linearize reference in f64, while the same J contracted in TF32
            must land above it (the limit catches that regression here).
  main      per config at B=1024, and social at B=4096: cold compile
            seconds, compiled.memory_analysis(), three ticks with every
            command finite, usable_frac / mean_lm_iters / termination split,
            and the tick time; then the warm-start + compaction lane.
  parity    social and stress36 at B=1024: f32 commands on the card against
            the same lanes in f64 on the card; the share of lanes within
            1e-3 may not fall more than 5 points below the CPU's own
            f32-vs-f64 share on the same seeds (CPU_WITHIN_1E3 below); and
            the one-hot window crops equal plain slicing bit for bit.

Any failed phase exits non-zero without a result line. On success the last
line is {"ok": true, "device": {"platform", "kind", "count"}}. Without a GPU
the script exits with code 2 before doing anything.
"""

import argparse
import functools
import json
import os
import sys
import time
import traceback

# The CPU's f32-vs-f64 agreement on the parity lanes (share of lanes whose
# first-tick commands agree within 1e-3), measured with this script's
# --cpu-parity option at --seed 0, B=1024 (the native generator's
# 512-scenario base tiled twice) on an x86-64 CPU with JAX 0.9.0; both
# configs' median |d| there is 2.4e-8.
CPU_WITHIN_1E3 = {"social": 0.98046875, "stress36": 0.91015625}
PARITY_SLACK = 0.05
CONFIGS = ("obstacle", "social", "omni6", "stress36")
BATCH = 1024  # scenarios per card: the bench's headline batch


def log(msg):
    print(msg, flush=True)


def rel_err(got, ref):
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def tf32(x):
    """x (f32) rounded to TF32's 10 mantissa bits, as a DEFAULT-precision
    f32 contraction may round its operands on the GPU."""
    import jax
    import jax.numpy as jnp

    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    bits = (bits + jnp.uint32(0x1000)) & jnp.uint32(0xFFFFE000)
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def chained(fn, u0, data, n1=5, n2=45, repeats=3):
    """(first-call outputs, per-call seconds) of fn chained inside ONE
    executable with a dynamic trip count, fenced with block_until_ready:
    per call = (t_n2 - t_n1) / (n2 - n1). The outputs come from the same
    executable (n=1), so accuracy and time cost one compile."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    @jax.jit
    def loop(u, n, *data):
        first = fn(u, *data)

        def body(i, acc):
            c, g, j = fn(u + 1e-7 * i.astype(u.dtype), *data)
            return acc + jnp.sum(c) + jnp.sum(g) + jnp.sum(j)

        return first, jax.lax.fori_loop(0, n, body, jnp.zeros((), u.dtype))

    first, _ = jax.block_until_ready(loop(u0, np.int32(1), *data))

    def timed(n):
        best = None
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(loop(u0, np.int32(n), *data))
            t = time.perf_counter() - t0
            best = t if best is None else min(best, t)
        return best

    return jax.device_get(first), (timed(n2) - timed(n1)) / (n2 - n1)


class Smoke:
    def __init__(self, batch, seed):
        self.batch = batch
        self.seed = seed
        self.failed = []
        self.results = {}
        self.batches = {}
        self.vg_inputs = {}

    def phase(self, key, fn):
        t0 = time.perf_counter()
        log(f"== {key}")
        try:
            res = fn()
            self.results[key] = res
            log(f"-- {key} ok ({time.perf_counter() - t0:.1f}s): {json.dumps(res, default=str)}")
        except Exception:  # noqa: BLE001 — recorded, and the run exits non-zero
            self.failed.append(key)
            log(f"-- {key} FAILED ({time.perf_counter() - t0:.1f}s):\n{traceback.format_exc()}")

    def scenarios(self, name, batch, dtype=None):
        """(cfg, scenario batch, fresh carry) on the device, cached."""
        import bench
        import jax
        import jax.numpy as jnp

        from nav2_social_mpc_controller_tpu.controller.controller import make_carry

        key = (name, batch)
        if key not in self.batches:
            cfg = bench.get_config(name)
            scb, b = bench.make_batch(cfg, batch, bench.CONFIG_PEOPLE[name], base_seed=self.seed)
            assert b == batch, (b, batch)
            self.batches[key] = (cfg, scb)
        cfg, scb = self.batches[key]
        if dtype is not None:
            scb = jax.tree.map(
                lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating) else x, scb
            )
        carry = jax.vmap(lambda _: make_carry(cfg, dtype=dtype or jnp.float32))(jnp.arange(batch))
        return cfg, scb, carry

    # -- value-grad phase --------------------------------------------------
    def value_grad(self, name):
        """The value-grad at the config's real widths: outputs and per-call
        times of both implementations; the outputs are checked against the
        f64 linearize reference in value_grad_accuracy, after every f32
        phase."""
        import jax

        from nav2_social_mpc_controller_tpu.controller.controller import step_pre
        from nav2_social_mpc_controller_tpu.controller.optimize import ProblemDims
        from nav2_social_mpc_controller_tpu.ops import fused_iter

        cfg, scb, carry = self.scenarios(name, self.batch)
        dims = ProblemDims.from_config(cfg)
        prep = jax.jit(jax.vmap(functools.partial(step_pre, cfg)))(scb, carry).prep
        data = fused_iter.value_grad_data(
            prep.rows, prep.n_rows, prep.people_proj, prep.people_present, prep.costmap
        )
        u0 = prep.u0
        impls = {
            "analytic": functools.partial(fused_iter.fused_batched, cfg, dims),
            "linearize": jax.vmap(functools.partial(fused_iter._ref_value_grad, cfg, dims)),
        }
        if name not in ("social", "stress36"):
            del impls["linearize"]  # timed on D=6 and D=12 only: compile time
        outs, us = {}, {}
        for k, f in impls.items():
            outs[k], sec = chained(f, u0, data)
            us[k] = sec * 1e6

        @jax.jit
        def analytic_tf32(u, *data):
            r, jac = fused_iter.analytic_residual_jacobian(
                *fused_iter._fused_prep(cfg, dims, u, *data)
            )
            return fused_iter.normal_equations(tf32(r), tf32(jac))

        outs["analytic_tf32"] = jax.device_get(analytic_tf32(u0, *data))
        self.vg_inputs[name] = (cfg, dims, u0, data, outs)
        return {
            "production": "analytic" if fused_iter._fused_dispatch_ok(cfg, u0) else "linearize",
            "us_per_call": us,
        }

    def value_grad_accuracy(self):
        """Every f32 value-grad output against the linearize reference in
        f64 (x64 is on by now): max|d|/max|ref| <= F32_REL_TOL on cost, g
        and JtJ for the production analytic path, and above it on g or JtJ
        for the TF32-rounded contraction of the same J."""
        import jax
        import jax.numpy as jnp

        from nav2_social_mpc_controller_tpu.ops import fused_iter

        res, bad = {}, {}
        for name, (cfg, dims, u0, data, outs) in self.vg_inputs.items():
            d64 = [x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x
                   for x in data]
            ref = jax.jit(jax.vmap(functools.partial(fused_iter._ref_value_grad, cfg, dims)))(
                u0.astype(jnp.float64), *d64
            )
            res[name] = {
                k: {f: rel_err(a, r) for f, a, r in zip(("cost", "g", "jtj"), o, ref)}
                for k, o in outs.items()
            }
            tol = fused_iter.F32_REL_TOL
            for f, e in res[name]["analytic"].items():
                if not e <= tol:
                    bad[f"{name}/{f}"] = e
            if not max(res[name]["analytic_tf32"][f] for f in ("g", "jtj")) > tol:
                bad[f"{name}/tf32 not caught"] = res[name]["analytic_tf32"]
        assert not bad, f"max|d|/max|ref| against {fused_iter.F32_REL_TOL}: {bad}; all: {res}"
        return res

    # -- main-path phase ---------------------------------------------------
    def main_path(self, name, batch):
        import jax
        import jax.numpy as jnp
        import numpy as np

        import bench
        from nav2_social_mpc_controller_tpu.controller.controller import (
            make_step_batch,
            step,
        )

        cfg, scb, carry = self.scenarios(name, batch)
        t0 = time.perf_counter()
        compiled = jax.jit(jax.vmap(functools.partial(step, cfg))).lower(scb, carry).compile()
        compile_s = time.perf_counter() - t0
        step_batch = make_step_batch(cfg)  # the user entry point (cache-warm)
        ticks_s = []
        for t in range(3):
            t0 = time.perf_counter()
            cmd, aux, carry = jax.block_until_ready(step_batch(scb, carry))
            ticks_s.append(time.perf_counter() - t0)
            for f in (cmd.linear_x, cmd.angular_z):
                assert bool(jnp.all(jnp.isfinite(f))), f"{name} tick {t}: non-finite command"
            if t == 0:
                first = (np.asarray(cmd.linear_x), np.asarray(cmd.angular_z))
        if batch == self.batch:
            self.results.setdefault("first_tick_cmds", {})[name] = first
        usable = np.asarray(aux.solve.usable)
        return {
            "batch": batch,
            "compile_s": compile_s,
            "memory": bench.memory_summary(compiled),
            "tick_ms": [t * 1e3 for t in ticks_s],
            "tick_ms_warm_mean": float(np.mean(ticks_s[1:])) * 1e3,
            "usable_frac": float(np.mean(usable)),
            "mean_lm_iters": float(np.mean(np.asarray(aux.solve.iterations))),
            "termination_split": bench._termination_split(
                aux.solve.termination, aux.solve.iterations
            ),
        }

    def compaction(self):
        import jax
        import jax.numpy as jnp
        import numpy as np

        import bench
        from nav2_social_mpc_controller_tpu.controller.controller import (
            make_carry,
            make_step_batch_compacted,
        )

        cfg = bench.get_config("social", warm_start_mode="previous_solution")
        _, scb, _ = self.scenarios("social", self.batch)
        carry = jax.vmap(lambda _: make_carry(cfg))(jnp.arange(self.batch))
        step_c = make_step_batch_compacted(cfg, 0.25)
        ticks_s = []
        for t in range(3):
            t0 = time.perf_counter()
            cmd, aux, carry = jax.block_until_ready(step_c(scb, carry))
            ticks_s.append(time.perf_counter() - t0)
            assert bool(jnp.all(jnp.isfinite(cmd.linear_x)) & jnp.all(jnp.isfinite(cmd.angular_z)))
        return {
            "tick_ms": [t * 1e3 for t in ticks_s],
            "usable_frac": float(np.mean(np.asarray(aux.solve.usable))),
            "mean_lm_iters": float(np.mean(np.asarray(aux.solve.iterations))),
        }

    # -- parity phase ------------------------------------------------------
    def crops(self):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from nav2_social_mpc_controller_tpu.world.grid import (
            crop_esdf_obstacle_window,
            crop_grid_window,
        )

        cfg, scb, _ = self.scenarios("social", self.batch)
        cm = scb.costmap
        center = scb.robot.pose[:, 0:2]
        n = cfg.optimizer.obstacle_window_cells
        win, _ = jax.jit(jax.vmap(lambda d, o, r, c: crop_grid_window(d, o, r, c, n)))(
            cm.data, cm.origin, cm.resolution, center
        )
        h, w = cm.data.shape[-2:]
        cell = jnp.floor((center - cm.origin) / cm.resolution[:, None]).astype(jnp.int32)
        c0 = jnp.clip(cell[:, 0] - n // 2, 0, w - n)
        r0 = jnp.clip(cell[:, 1] - n // 2, 0, h - n)
        ref = jax.jit(jax.vmap(lambda d, r, c: jax.lax.dynamic_slice(d, (r, c), (n, n))))(
            cm.data, r0, c0
        )
        assert np.array_equal(np.asarray(win), np.asarray(ref)), "costmap crop is not a copy"

        e = scb.esdf
        m = cfg.esdf_window_cells
        people = scb.people.state[:, :, 0:2]
        oxy, sc, sr = jax.jit(
            jax.vmap(lambda i, p, o, r: crop_esdf_obstacle_window(i, p, o, r, m))
        )(e.indexes, people, e.origin, e.resolution)
        ref_idx = jax.jit(jax.vmap(jax.vmap(
            lambda idx, r, c: jax.lax.dynamic_slice(idx, (r, c), (m, m)).reshape(-1),
            in_axes=(None, 0, 0),
        )))(e.indexes, sr, sc)
        oxy = np.asarray(oxy).astype(np.int64)
        ref_idx = np.asarray(ref_idx)
        assert np.array_equal(oxy & 0xFF, ref_idx % w) and np.array_equal(oxy >> 8, ref_idx // w), (
            "ESDF crop is not a copy"
        )
        return {"costmap_lanes": int(win.shape[0]), "esdf_tables": int(oxy.shape[0] * oxy.shape[1])}

    def parity_f64(self, names):
        """f64 first ticks on the card, against the f32 ones kept by the
        main phase. x64 is switched on only here, after every f32 phase."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        from nav2_social_mpc_controller_tpu.controller.controller import step

        jax.config.update("jax_enable_x64", True)
        res = {}
        for name in names:
            cfg, scb, carry = self.scenarios(name, self.batch, dtype=jnp.float64)
            cmd, _aux, _ = jax.block_until_ready(
                jax.jit(jax.vmap(functools.partial(step, cfg)))(scb, carry)
            )
            vx32, wz32 = self.results["first_tick_cmds"][name]
            d = np.maximum(np.abs(vx32 - np.asarray(cmd.linear_x)),
                           np.abs(wz32 - np.asarray(cmd.angular_z)))
            share = float(np.mean(d <= 1e-3))
            entry = {"within_1e3": share, "p50_abs_diff": float(np.median(d)),
                     "cpu_within_1e3": CPU_WITHIN_1E3[name]}
            res[name] = entry
            floor = CPU_WITHIN_1E3[name]
            assert floor is not None, f"no CPU share recorded for {name}"
            assert share >= floor - PARITY_SLACK, (
                f"{name}: card f32-vs-f64 share {share:.4f} < CPU {floor:.4f} - {PARITY_SLACK}"
            )
        return res

    # -- four cards ----------------------------------------------------------
    def four(self):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from nav2_social_mpc_controller_tpu.controller.controller import step
        from nav2_social_mpc_controller_tpu.parallel.mesh import (
            make_distributed_step,
            make_mesh,
            shard_batch,
        )

        n_dev = 4
        assert len(jax.devices()) >= n_dev, f"need {n_dev} cards, have {len(jax.devices())}"
        jax.config.update("jax_enable_x64", True)
        cfg, scb, carry = self.scenarios("social", self.batch * n_dev, dtype=jnp.float64)
        mesh = make_mesh(n_dev)
        sharded = make_distributed_step(cfg, mesh)
        args_d = (shard_batch(mesh, scb), shard_batch(mesh, carry))
        single = jax.jit(jax.vmap(functools.partial(step, cfg)))
        args_u = jax.device_put((scb, carry), jax.devices()[0])
        times = {}
        for key, fn, args in (("sharded", sharded, args_d), ("single", single, args_u)):
            for call in ("first_call_s", "second_call_s"):  # compile + tick, then tick
                t0 = time.perf_counter()
                out = jax.block_until_ready(fn(*args))
                times[f"{key}_{call}"] = time.perf_counter() - t0
            if key == "sharded":
                cmd_d, aux_d, _, metrics = out
            else:
                cmd_u, aux_u, _ = out
        # f64, as __graft_entry__.dryrun_multichip: in f32 the two batch
        # shapes' different reduction orders are amplified chaotically by
        # LM accept/reject branching.
        np.testing.assert_allclose(np.asarray(cmd_d.linear_x), np.asarray(cmd_u.linear_x),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(cmd_d.angular_z), np.asarray(cmd_u.angular_z),
                                   rtol=1e-5, atol=1e-6)
        assert np.array_equal(np.asarray(aux_d.status), np.asarray(aux_u.status))
        assert int(metrics.n_scenarios) == self.batch * n_dev
        assert int(metrics.n_usable) == int(np.sum(np.asarray(aux_u.solve.usable)))
        assert int(metrics.total_iterations) == int(np.sum(np.asarray(aux_u.solve.iterations)))
        return {
            "lanes": self.batch * n_dev,
            "devices": n_dev,
            "max_abs_diff_linear_x": float(np.max(np.abs(
                np.asarray(cmd_d.linear_x) - np.asarray(cmd_u.linear_x)))),
            "n_usable": int(metrics.n_usable),
            **times,
        }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on a 4-card mesh vs one card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="measurements",
                    help="directory for the detailed JSON result")
    ap.add_argument("--cpu-parity", action="store_true",
                    help="measure CPU_WITHIN_1E3 on the CPU (no device phases)")
    args = ap.parse_args()

    import jax

    if args.cpu_parity:
        jax.config.update("jax_platforms", "cpu")
    from nav2_social_mpc_controller_tpu.utils.device import (
        device_summary,
        setup_compile_cache,
    )

    cache_dir = setup_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.cpu_parity:
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {dev.platform!r}", file=sys.stderr)
        sys.exit(2)
    summary = device_summary()
    log(f"device_kind: {summary['kind']} count: {summary['count']} jax: {summary['jax']}")
    log(f"XLA_FLAGS: {summary['xla_flags']!r} compile cache: {cache_dir}")

    smoke = Smoke(BATCH, args.seed)
    if args.cpu_parity:
        return cpu_parity(smoke)
    if args.four:
        smoke.phase("four_card_sharded_vs_single", smoke.four)
        count = 4
    else:
        for name in CONFIGS:
            smoke.phase(f"value_grad/{name}", functools.partial(smoke.value_grad, name))
        for name in CONFIGS:
            smoke.phase(f"main/{name}", functools.partial(smoke.main_path, name, BATCH))
        smoke.phase("main/social_b4096", functools.partial(smoke.main_path, "social", 4 * BATCH))
        smoke.phase("main/compaction", smoke.compaction)
        smoke.phase("parity/crops", smoke.crops)
        smoke.phase("parity/f32_vs_f64", functools.partial(smoke.parity_f64, ("social", "stress36")))
        smoke.phase("value_grad/accuracy_vs_f64", smoke.value_grad_accuracy)
        count = len(jax.devices())
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        res = {k: v for k, v in smoke.results.items() if k != "first_tick_cmds"}
        json.dump({"device": summary, "results": res, "failed": smoke.failed}, f,
                  indent=1, default=str)
    log(f"card: {summary['card']}")
    log(summary["card"])
    if smoke.failed:
        log(f"FAILED phases: {smoke.failed}")
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))


def cpu_parity(smoke):
    """The CPU's f32-vs-f64 first-tick agreement on the parity lanes."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nav2_social_mpc_controller_tpu.controller.controller import step

    out = {}
    for name in ("social", "stress36"):
        cmds = {}
        for dt in (jnp.float32, jnp.float64):
            jax.config.update("jax_enable_x64", dt == jnp.float64)
            cfg, scb, carry = smoke.scenarios(name, smoke.batch, dtype=dt)
            cmd, _, _ = jax.block_until_ready(
                jax.jit(jax.vmap(functools.partial(step, cfg)))(scb, carry)
            )
            cmds[dt] = (np.asarray(cmd.linear_x, np.float64), np.asarray(cmd.angular_z, np.float64))
        d = np.maximum(np.abs(cmds[jnp.float32][0] - cmds[jnp.float64][0]),
                       np.abs(cmds[jnp.float32][1] - cmds[jnp.float64][1]))
        out[name] = {"within_1e3": float(np.mean(d <= 1e-3)), "p50_abs_diff": float(np.median(d))}
        log(f"{name}: {out[name]}")
    print(json.dumps({"cpu_parity": out, "seed": smoke.seed, "batch": smoke.batch}))


if __name__ == "__main__":
    main()
