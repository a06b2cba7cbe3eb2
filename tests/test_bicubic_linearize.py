"""Batched bicubic sampling with derivatives (world.grid.bicubic_linearize)
against the gather-stencil reference, and the one-hot window crops against
plain slicing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nav2_social_mpc_controller_tpu.world.grid import (
    bicubic_interpolate,
    bicubic_interpolate_gather,
    bicubic_linearize,
    crop_esdf_obstacle_window,
    crop_grid_window,
)


def _random_case(rng, b, s, h, w, margin=2.0, integer_grid=True):
    # Integer-valued grids are the production domain (nav2 Costmap2D is
    # unsigned char; the reference interpolates Grid2D<u_char>).
    grid = rng.uniform(0.0, 254.0, size=(b, h, w)).astype(np.float32)
    if integer_grid:
        grid = np.rint(grid)
    # Include out-of-range coords to exercise border clamping.
    rowf = rng.uniform(-margin, h - 1 + margin, size=(b, s)).astype(np.float32)
    colf = rng.uniform(-margin, w - 1 + margin, size=(b, s)).astype(np.float32)
    return jnp.asarray(grid), jnp.asarray(rowf), jnp.asarray(colf)


def _gather_reference(grid, rowf, colf):
    """Value and both derivatives from the 16-point gather stencil."""

    def one(g, r, c):
        val = jax.vmap(lambda rr, cc: bicubic_interpolate_gather(g, rr, cc))(r, c)
        dr = jax.vmap(jax.grad(bicubic_interpolate_gather, argnums=1), in_axes=(None, 0, 0))(g, r, c)
        dc = jax.vmap(jax.grad(bicubic_interpolate_gather, argnums=2), in_axes=(None, 0, 0))(g, r, c)
        return val, dr, dc

    return jax.vmap(one)(grid, rowf, colf)


@pytest.mark.parametrize("b,s,h,w", [(5, 30, 40, 40), (4, 32, 48, 80), (3, 59, 64, 64)])
def test_batched_linearize_matches_gather_stencil(b, s, h, w):
    rng = np.random.default_rng(b * 100 + s)
    grid, rowf, colf = _random_case(rng, b, s, h, w, margin=0.0)
    got = jax.vmap(bicubic_linearize)(grid, rowf, colf)
    ref = _gather_reference(grid, rowf, colf)
    for g_, r_ in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g_), np.asarray(r_), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("coord,expect", [(-7.0, 0.0), (11.0, 24.0)])
def test_border_clamp_flat(coord, expect):
    # Far outside the grid every tap clamps to the border row/col: the value
    # is the corner value and both derivatives vanish.
    grid = jnp.broadcast_to(jnp.arange(25, dtype=jnp.float32).reshape(1, 5, 5), (3, 5, 5))
    rowf = jnp.full((3, 9), coord, jnp.float32)
    colf = jnp.full((3, 9), coord, jnp.float32)
    val, dr, dc = jax.vmap(bicubic_linearize)(grid, rowf, colf)
    np.testing.assert_allclose(np.asarray(val), expect, atol=1e-5)
    np.testing.assert_allclose(np.asarray(dr), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(dc), 0.0, atol=1e-5)


def test_vmapped_matches_unbatched():
    rng = np.random.default_rng(2)
    grid, rowf, colf = _random_case(rng, b=4, s=12, h=20, w=20)
    batched = jax.vmap(bicubic_linearize)(grid, rowf, colf)
    for i in range(4):
        single = bicubic_linearize(grid[i], rowf[i], colf[i])
        for got, exp in zip(batched, single):
            np.testing.assert_allclose(np.asarray(got[i]), np.asarray(exp), rtol=1e-6)


def test_shared_grid_batch():
    # One grid shared across the batch (grid unbatched under vmap).
    rng = np.random.default_rng(3)
    _, rowf, colf = _random_case(rng, b=6, s=10, h=16, w=16)
    grid = jnp.asarray(rng.uniform(0.0, 254.0, size=(16, 16)).astype(np.float32))
    batched = jax.vmap(bicubic_linearize, in_axes=(None, 0, 0))(grid, rowf, colf)
    for i in range(6):
        single = bicubic_linearize(grid, rowf[i], colf[i])
        for got, exp in zip(batched, single):
            np.testing.assert_allclose(np.asarray(got[i]), np.asarray(exp), rtol=1e-6)


def test_linearize_inside_lm_transform_stack():
    # The production pattern of the linearize reference: vmap over
    # scenarios of a jax.linearize through the custom-JVP bicubic sample.
    # Tangents must match jacfwd of the gather-stencil formulation.
    rng = np.random.default_rng(4)
    grid, rowf, colf = _random_case(rng, b=3, s=7, h=24, w=24, margin=0.0)

    def f(g, r, c):
        y, f_lin = jax.linearize(lambda rc: bicubic_interpolate(g, rc[0], rc[1]), jnp.stack([r, c]))
        tr = f_lin(jnp.stack([jnp.ones_like(r), jnp.zeros_like(c)]))
        tc = f_lin(jnp.stack([jnp.zeros_like(r), jnp.ones_like(c)]))
        return y, tr, tc

    y, tr, tc = jax.vmap(f)(grid, rowf, colf)
    ev, er, ec = _gather_reference(grid, rowf, colf)
    np.testing.assert_allclose(np.asarray(y), np.asarray(ev), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(tr), np.asarray(er), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(tc), np.asarray(ec), rtol=1e-4, atol=1e-3)


def test_scenario_costmaps_are_integer_valued():
    from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config
    from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario

    sc = make_scenario(benchmark_social_config(), seed=0, n_valid_people=3)
    data = np.asarray(sc.costmap.data)
    assert np.array_equal(data, np.rint(data))


@pytest.mark.parametrize("integer_grid", [True, False])
def test_costmap_crop_equals_dynamic_slice(integer_grid):
    """The one-hot crop is a pure copy for ANY f32 cost values (HIGHEST
    selector products), bit for bit equal to lax.dynamic_slice."""
    rng = np.random.default_rng(5)
    h = w = 120
    data = rng.uniform(0.0, 254.0, (h, w)).astype(np.float32)
    if integer_grid:
        data = np.rint(data)
    data = jnp.asarray(data)
    origin = jnp.asarray([-1.0, -3.0], jnp.float32)
    res = jnp.float32(0.05)
    for cx, cy in [(0.3, -0.2), (-1.0, -3.0), (4.9, 2.9), (2.0, 0.1)]:
        center = jnp.asarray([cx, cy], jnp.float32)
        win, win_origin = jax.jit(crop_grid_window, static_argnums=4)(data, origin, res, center, 64)
        cell = np.floor((np.asarray(center) - np.asarray(origin)) / 0.05).astype(int)
        c0 = int(np.clip(cell[0] - 32, 0, w - 64))
        r0 = int(np.clip(cell[1] - 32, 0, h - 64))
        ref = jax.lax.dynamic_slice(data, (r0, c0), (64, 64))
        np.testing.assert_array_equal(np.asarray(win), np.asarray(ref))
        np.testing.assert_allclose(
            np.asarray(win_origin), np.asarray(origin) + np.array([c0, r0]) * 0.05, atol=1e-6
        )


def test_esdf_crop_equals_index_slices():
    """The byte-plane one-hot ESDF crop reproduces the nearest-obstacle
    cell coordinates of plain slicing exactly at the bench's 120x120."""
    rng = np.random.default_rng(6)
    h = w = 120
    idx = jnp.asarray(rng.integers(0, h * w, (h, w)), jnp.int32)
    origin = jnp.asarray([-1.0, -3.0], jnp.float32)
    res = jnp.float32(0.05)
    centers = jnp.asarray([[0.3, -0.2], [-1.0, -3.0], [4.9, 2.9]], jnp.float32)
    window = 32
    oxy, start_col, start_row = jax.jit(crop_esdf_obstacle_window, static_argnums=4)(
        idx, centers, origin, res, window
    )
    oxy = np.asarray(oxy).astype(np.int64)
    idx_np = np.asarray(idx)
    for k in range(centers.shape[0]):
        r0, c0 = int(start_row[k]), int(start_col[k])
        ref = idx_np[r0 : r0 + window, c0 : c0 + window].reshape(-1)
        np.testing.assert_array_equal(oxy[k] & 0xFF, ref % w)
        np.testing.assert_array_equal(oxy[k] >> 8, ref // w)
