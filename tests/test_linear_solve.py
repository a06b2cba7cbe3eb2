"""The damped normal-equation solve (solver.lm.default_linear_solve):
batched Cholesky against a float64 NumPy reference, and batched against
per-lane calls."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nav2_social_mpc_controller_tpu.solver.lm import default_linear_solve


def _random_spd(rng, n, d, dtype=np.float32):
    m = rng.normal(size=(n, d, d)).astype(dtype)
    a = np.einsum("nij,nkj->nik", m, m) + 0.5 * np.eye(d, dtype=dtype)
    b = rng.normal(size=(n, d)).astype(dtype)
    return a, b


@pytest.mark.parametrize("n,d,tol", [(37, 6, 2e-4), (1024, 12, 2e-3)])
def test_batched_solve_matches_numpy(n, d, tol):
    rng = np.random.default_rng(d)
    a, b = _random_spd(rng, n, d)
    x = np.asarray(jax.vmap(default_linear_solve)(jnp.asarray(a), jnp.asarray(b)))
    expected = np.linalg.solve(a.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(x, expected, rtol=tol, atol=tol / 10)


def test_spd_solve_unbatched_and_vmapped_agree():
    rng = np.random.default_rng(2)
    a, b = _random_spd(rng, 16, 6)
    single = np.stack(
        [np.asarray(default_linear_solve(jnp.asarray(a[i]), jnp.asarray(b[i]))) for i in range(16)]
    )
    batched = np.asarray(jax.vmap(default_linear_solve)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(batched, single, rtol=1e-4, atol=1e-5)


def test_spd_solve_f64_path():
    rng = np.random.default_rng(3)
    a, b = _random_spd(rng, 8, 6, dtype=np.float64)
    x = np.asarray(jax.vmap(default_linear_solve)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(x, np.linalg.solve(a, b[..., None])[..., 0], rtol=1e-10)
