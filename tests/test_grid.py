"""Unit tests for world.grid: Catmull-Rom bicubic parity properties and the
ESDF nearest-obstacle gather (vs closed forms / brute force)."""

import jax
import jax.numpy as jnp
import numpy as np

from nav2_social_mpc_controller_tpu.world.grid import (
    bicubic_interpolate,
    esdf_nearest_obstacle_diff,
    sample_costmap,
)


def _catmull_rom_1d(p, x):
    p0, p1, p2, p3 = p
    return p1 + 0.5 * x * (
        (p2 - p0) + x * ((2 * p0 - 5 * p1 + 4 * p2 - p3) + x * (3 * (p1 - p2) + p3 - p0))
    )


def test_interpolates_exact_on_grid_points():
    rng = np.random.default_rng(0)
    g = rng.uniform(0, 255, (16, 16)).astype(np.float32)
    rows = np.arange(2, 14, dtype=np.float32)
    cols = np.arange(3, 15, dtype=np.float32)
    out = bicubic_interpolate(jnp.asarray(g), jnp.asarray(rows), jnp.asarray(cols))
    np.testing.assert_allclose(np.asarray(out), g[rows.astype(int), cols.astype(int)], rtol=1e-5)


def test_matches_separable_catmull_rom_reference():
    rng = np.random.default_rng(1)
    g = rng.uniform(0, 255, (12, 12)).astype(np.float64)
    r, c = 5.3, 6.7
    fr, fc = r - 5, c - 6
    # Direct separable evaluation: interpolate along cols for 4 rows, then rows
    rows_vals = []
    for dr in (-1, 0, 1, 2):
        samples = g[5 + dr, 5:9]  # cols 5..8 -> floor(c)-1 .. floor(c)+2 = 5..8
        rows_vals.append(_catmull_rom_1d(samples, fc))
    expected = _catmull_rom_1d(np.array(rows_vals), fr)
    out = bicubic_interpolate(jnp.asarray(g), jnp.asarray(r), jnp.asarray(c))
    np.testing.assert_allclose(float(out), expected, rtol=1e-12)


def test_reproduces_cubic_surface_exactly():
    # Catmull-Rom reproduces polynomials up to degree 3 in the interior.
    ys, xs = np.mgrid[0:20, 0:20].astype(np.float64)
    g = 0.5 * xs**2 + 0.25 * ys**2 - 0.1 * xs * ys + 3.0 * xs + 1.0
    pts_r = np.array([4.3, 9.9, 12.5])
    pts_c = np.array([5.1, 8.8, 14.2])
    out = bicubic_interpolate(jnp.asarray(g), jnp.asarray(pts_r), jnp.asarray(pts_c))
    expected = 0.5 * pts_c**2 + 0.25 * pts_r**2 - 0.1 * pts_c * pts_r + 3.0 * pts_c + 1.0
    np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-10)


def test_border_clamping_is_flat():
    g = np.ones((8, 8), np.float64) * 7.0
    out = bicubic_interpolate(jnp.asarray(g), jnp.asarray(-3.5), jnp.asarray(100.2))
    np.testing.assert_allclose(float(out), 7.0, rtol=1e-12)


def test_gradient_matches_finite_difference():
    rng = np.random.default_rng(2)
    g = jnp.asarray(rng.uniform(0, 255, (16, 16)).astype(np.float64))

    def f(rc):
        return bicubic_interpolate(g, rc[0], rc[1])

    rc0 = jnp.asarray([6.37, 7.91])
    grad = jax.grad(f)(rc0)
    eps = 1e-6
    for i in range(2):
        e = np.zeros(2)
        e[i] = eps
        fd = (f(rc0 + e) - f(rc0 - e)) / (2 * eps)
        np.testing.assert_allclose(float(grad[i]), float(fd), rtol=1e-4)


def test_sample_costmap_world_convention():
    # ObstacleCost convention: grid coords (p - origin)/res, Evaluate(y, x)
    g = np.zeros((10, 10), np.float64)
    g[4, 7] = 100.0  # row=y_cell 4, col=x_cell 7
    origin = jnp.asarray([-1.0, -2.0])
    res = 0.5
    # world point exactly at cell (x=7, y=4): x = -1 + 7*0.5, y = -2 + 4*0.5
    pt = jnp.asarray([2.5, 0.0])
    out = sample_costmap(jnp.asarray(g), origin, res, pt)
    np.testing.assert_allclose(float(out), 100.0, rtol=1e-9)


def test_esdf_gather_matches_reference_arithmetic():
    h, w = 12, 16
    res = 0.1
    origin = np.array([0.5, -0.5])
    indexes = np.zeros((h, w), np.int32)
    # nearest obstacle for every cell: cell (x=3, y=2) -> flat 3 + 2*16 = 35
    indexes[:, :] = 35
    distances = np.ones((h, w), np.float32)
    pt = jnp.asarray([1.23, 0.07])  # cell: floor((1.23-0.5)/0.1)=7, floor((0.07+0.5)/0.1)=5
    diff, ok = esdf_nearest_obstacle_diff(
        jnp.asarray(distances), jnp.asarray(indexes), jnp.asarray(origin), res, pt
    )
    obstacle = np.array([3 * res + origin[0], 2 * res + origin[1]])
    np.testing.assert_allclose(np.asarray(diff), np.asarray(pt) - obstacle, rtol=1e-5)
    assert bool(ok)
    # out of bounds
    _, ok2 = esdf_nearest_obstacle_diff(
        jnp.asarray(distances), jnp.asarray(indexes), jnp.asarray(origin), res, jnp.asarray([99.0, 0.0])
    )
    assert not bool(ok2)


def test_matmul_formulation_matches_gather_stencil():
    """The one-hot stencil-matmul formulation must agree with the classic
    16-point gather stencil (values, point-Jacobians, and grid cotangents)
    everywhere including far out-of-range queries."""
    import jax

    from nav2_social_mpc_controller_tpu.world.grid import (
        bicubic_interpolate,
        bicubic_interpolate_gather,
    )

    rng = np.random.default_rng(7)
    g = jnp.asarray(rng.uniform(0.0, 254.0, (37, 53)))
    row = jnp.asarray(rng.uniform(-6.0, 60.0, (200,)))
    col = jnp.asarray(rng.uniform(-6.0, 60.0, (200,)))

    np.testing.assert_allclose(
        np.asarray(bicubic_interpolate(g, row, col)),
        np.asarray(bicubic_interpolate_gather(g, row, col)),
        atol=1e-10,
    )
    ja = jax.jacfwd(lambda rc: bicubic_interpolate(g, rc[0], rc[1]))(jnp.stack([row, col]))
    jb = jax.jacfwd(lambda rc: bicubic_interpolate_gather(g, rc[0], rc[1]))(jnp.stack([row, col]))
    np.testing.assert_allclose(np.asarray(ja), np.asarray(jb), atol=1e-10)
    # Grid cotangent (exercises the non-zero dgrid branch of the custom JVP
    # through transposition)
    ga = jax.grad(lambda gg: jnp.sum(bicubic_interpolate(gg, row[:9], col[:9])))(g)
    gb = jax.grad(lambda gg: jnp.sum(bicubic_interpolate_gather(gg, row[:9], col[:9])))(g)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(gb), atol=1e-12)


def test_window_crop_is_exact_on_controller_step():
    """The rolling-window costmap crop must not change controller output at
    all when the window covers the reachable set (the benchmark sizing)."""
    import dataclasses
    import functools

    import jax

    from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config
    from nav2_social_mpc_controller_tpu.controller.controller import make_carry, step
    from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario_batch

    cfg_win = benchmark_social_config()
    assert cfg_win.optimizer.obstacle_window_cells == 64
    cfg_full = dataclasses.replace(
        cfg_win, optimizer=dataclasses.replace(cfg_win.optimizer, obstacle_window_cells=0)
    )
    scb = jax.tree.map(jnp.asarray, make_scenario_batch(cfg_win, 8, n_valid_people=3))
    carry = jax.vmap(lambda _: make_carry(cfg_win))(jnp.arange(8))
    cmd_w, aux_w, _ = jax.jit(jax.vmap(functools.partial(step, cfg_win)))(scb, carry)
    cmd_f, aux_f, _ = jax.jit(jax.vmap(functools.partial(step, cfg_full)))(scb, carry)
    np.testing.assert_array_equal(np.asarray(cmd_w.linear_x), np.asarray(cmd_f.linear_x))
    np.testing.assert_array_equal(np.asarray(cmd_w.angular_z), np.asarray(cmd_f.angular_z))
    np.testing.assert_array_equal(
        np.asarray(aux_w.solve.final_cost), np.asarray(aux_f.solve.final_cost)
    )
