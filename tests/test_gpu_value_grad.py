"""Card-only: the analytic LM value-and-gradient as the GPU compiles it
against the linearize reference in f64. Skips without a GPU; run with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_fused_iter import _batch_problem


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["benchmark_social_config", "benchmark_stress_h36_config"])
def test_analytic_value_grad_on_gpu_matches_f64_reference(gpu, config):
    from nav2_social_mpc_controller_tpu.core import config as cfgs
    from nav2_social_mpc_controller_tpu.ops.fused_iter import (
        F32_REL_TOL,
        _ref_value_grad,
        fused_batched,
    )

    cfg, dims, bt = _batch_problem(getattr(cfgs, config), 3, seeds=range(8))
    args = (bt["u"], bt["rows"], bt["n_rows"], bt["proj"], bt["present"],
            bt["cmd"], bt["cmo"], bt["cmr"])
    got = jax.jit(functools.partial(fused_batched, cfg, dims))(*args)
    args64 = [a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a
              for a in args]
    ref = jax.jit(jax.vmap(functools.partial(_ref_value_grad, cfg, dims)))(*args64)
    for g_, r_ in zip(got, ref):
        assert g_.dtype == jnp.float32
        g_, r_ = np.asarray(g_, np.float64), np.asarray(r_)
        assert np.max(np.abs(g_ - r_)) <= F32_REL_TOL * np.max(np.abs(r_))
