"""One LM iteration (solver/lm.py): the batched propose/commit halves
against per-lane NumPy references, and end-to-end solver equality between
the default and the debug-trace paths."""

import jax
import jax.numpy as jnp
import numpy as np

from nav2_social_mpc_controller_tpu.solver import lm
from nav2_social_mpc_controller_tpu.solver.lm import LMConfig, lm_solve


def _random_state(rng, b, d, with_done=True):
    # SPD jtj via A A^T + eps I, magnitudes like the benchmark problems.
    a = rng.standard_normal((b, d, d)).astype(np.float32)
    jtj = np.einsum("bij,bkj->bik", a, a) * 10.0 + 1e-3 * np.eye(d, dtype=np.float32)
    g = rng.standard_normal((b, d)).astype(np.float32) * 5.0
    u = rng.uniform(-0.5, 0.5, (b, d)).astype(np.float32)
    radius = 10.0 ** rng.uniform(-2, 4, b).astype(np.float32)
    lower = np.full((b, d), -0.7, np.float32)
    upper = np.full((b, d), 0.7, np.float32)
    done = (rng.uniform(0, 1, b) < 0.3) if with_done else np.zeros(b, bool)
    return u, g, jtj.astype(np.float32), radius.astype(np.float32), lower, upper, done


def _propose_numpy(cfg, u, g, jtj, radius, lower, upper):
    """Per-lane float64 reference of lm.propose."""
    u, g, jtj = (np.asarray(x, np.float64) for x in (u, g, jtj))
    diag = np.clip(np.diagonal(jtj), cfg.min_diagonal, cfg.max_diagonal)
    delta = np.linalg.solve(jtj + np.diag(diag / float(radius)), -g)
    u_new = np.clip(u + delta, lower, upper)
    delta = u_new - u
    mc = -delta @ g - 0.5 * delta @ jtj @ delta
    return u_new, delta, mc


def test_batched_propose_matches_per_lane_reference():
    cfg = LMConfig()
    rng = np.random.default_rng(0)
    for b, d in [(5, 6), (130, 6), (7, 12), (64, 2)]:
        u, g, jtj, radius, lower, upper, _ = _random_state(rng, b, d)
        got = jax.vmap(lambda *a: lm.propose(cfg, *a))(
            *map(jnp.asarray, (u, g, jtj, radius, lower, upper))
        )
        for i in range(b):
            ref = _propose_numpy(cfg, u[i], g[i], jtj[i], radius[i], lower[i], upper[i])
            # f32 Cholesky vs f64 LAPACK: linear-solver-grade tolerance.
            for gk, rk, name in zip(got, ref, ("u_new", "delta", "mc")):
                np.testing.assert_allclose(
                    np.asarray(gk[i]), rk, rtol=2e-3, atol=5e-5, err_msg=name
                )


def test_batched_commit_matches_per_lane():
    cfg = LMConfig(max_iterations=40, fn_tol=1e-5, gradient_tol=1e-8, param_tol=1e-9)
    rng = np.random.default_rng(1)
    for b, d in [(9, 6), (130, 6), (6, 12)]:
        u, g, jtj, radius, lower, upper, done = _random_state(rng, b, d)
        u_new, delta, mc = jax.vmap(lambda *a: lm.propose(cfg, *a))(
            *map(jnp.asarray, (u, g, jtj, radius, lower, upper))
        )
        # Trial results spanning accept, reject, and invalid-step lanes:
        cost = rng.uniform(1.0, 100.0, b).astype(np.float32)
        new_cost = cost * rng.uniform(0.2, 1.5, b).astype(np.float32)
        new_cost[0] = np.inf  # invalid-step lane
        st = lm._LMState(
            u=jnp.asarray(u), cost=jnp.asarray(cost), g=jnp.asarray(g),
            jtj=jnp.asarray(jtj), radius=jnp.asarray(radius),
            decrease_factor=jnp.full((b,), 2.0, jnp.float32),
            iters=jnp.asarray(rng.integers(0, 40, b).astype(np.int32)),
            done=jnp.asarray(done), term=jnp.zeros((b,), jnp.int32),
            failed=jnp.zeros((b,), bool), trace=None,
        )
        trial = (u_new, delta, mc, jnp.asarray(new_cost), jnp.asarray(g * 0.5),
                 jnp.asarray(jtj * 0.9))
        got, _ = jax.vmap(lambda s, *t: lm.commit(cfg, s, *t))(st, *trial)
        for i in range(b):
            lane = jax.tree.map(lambda x: x[i], st)
            ref, _ = lm.commit(cfg, lane, *(t[i] for t in trial))
            for name in ("u", "cost", "g", "jtj", "radius", "decrease_factor",
                         "iters", "done", "term", "failed"):
                gk = np.asarray(getattr(got, name)[i])
                rk = np.asarray(getattr(ref, name))
                if rk.dtype in (bool, np.int32):
                    np.testing.assert_array_equal(gk, rk, err_msg=name)
                else:
                    np.testing.assert_allclose(gk, rk, rtol=2e-6, atol=1e-6, err_msg=name)
        # The infinite trial cost is rejected, never accepted.
        assert float(got.cost[0]) == float(cost[0])


def test_lm_solve_with_ops_matches_without():
    """lm_solve results must be identical with and without the debug trace
    layered on the same iteration."""
    cfg = LMConfig(max_iterations=30, fn_tol=1e-6, gradient_tol=1e-9, param_tol=1e-10)

    def residual_fn(u):
        return jnp.stack([
            10.0 * (u[1] - u[0] ** 2),
            1.0 - u[0],
            0.5 * (u[2] + u[3] - 1.0),
            u[2] * u[3] - 0.2,
            jnp.sum(u**2) - 1.0,
        ])

    u0 = jnp.asarray([0.3, -0.2, 0.4, 0.1], jnp.float32)
    lo = jnp.full((4,), -2.0, jnp.float32)
    hi = jnp.full((4,), 2.0, jnp.float32)
    u_ops, stats_ops = lm_solve(residual_fn, u0, lo, hi, cfg)
    u_leg, stats_leg, _tr = lm_solve(residual_fn, u0, lo, hi, cfg, trace_len=30)
    np.testing.assert_allclose(np.asarray(u_ops), np.asarray(u_leg), rtol=0, atol=0)
    assert int(stats_ops.iterations) == int(stats_leg.iterations)
    assert int(stats_ops.termination) == int(stats_leg.termination)


def test_batched_lm_solve_with_ops_matches_per_lane():
    """vmapped lm_solve equals per-lane solves — frozen-lane semantics
    preserved."""
    cfg = LMConfig(max_iterations=25)

    def make_rfn(c):
        def rfn(u):
            return jnp.stack([u[0] * u[0] - c, u[1] - u[0] * 0.5, u[1] * u[0] - 0.1])

        return rfn

    cs = jnp.asarray([0.3, 0.6, 1.2, 0.05], jnp.float32)
    u0 = jnp.tile(jnp.asarray([0.5, 0.5], jnp.float32), (4, 1))
    lo = jnp.full((4, 2), -3.0, jnp.float32)
    hi = jnp.full((4, 2), 3.0, jnp.float32)

    def solve_one(c, u0_l, lo_l, hi_l):
        def rfn(u):
            return jnp.stack([u[0] * u[0] - c, u[1] - u[0] * 0.5, u[1] * u[0] - 0.1])

        return lm_solve(rfn, u0_l, lo_l, hi_l, cfg)

    u_b, stats_b = jax.vmap(solve_one)(cs, u0, lo, hi)
    for i in range(4):
        u_i, stats_i = solve_one(cs[i], u0[i], lo[i], hi[i])
        np.testing.assert_allclose(np.asarray(u_b[i]), np.asarray(u_i), atol=1e-7)
        assert int(stats_b.iterations[i]) == int(stats_i.iterations)
