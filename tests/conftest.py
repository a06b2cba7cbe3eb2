"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh (the standard JAX fake-cluster
technique, SURVEY.md section 4d) so multi-device sharding logic is exercised
without accelerator hardware. x64 is ENABLED (not forced onto arrays) so
parity tests can compare against the float64 oracle while f32-typed inputs
still exercise the default precision path.

The CPU is the default platform. Tests marked `gpu` need an NVIDIA GPU and
skip elsewhere; run them on a card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
# Set the flag directly: it must hold before the first computation.
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided when the test
    runs, never at import, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda -m gpu)")
