"""The measurement entry points refuse to run without a GPU, and keep the
compile cache where the environment says (utils/device.py)."""

import json
import os
import shutil
import subprocess
import sys

import jax

from nav2_social_mpc_controller_tpu.utils import device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=ROOT):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )


def _has_result_line(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    if not lines:
        return False
    try:
        return json.loads(lines[-1]).get("ok") is True
    except (json.JSONDecodeError, AttributeError):
        return False


def test_smoke_refuses_cpu_only_machine():
    proc = _run(["chip_smoke.py"])
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "needs an NVIDIA GPU" in proc.stderr
    assert not _has_result_line(proc.stdout)


def test_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert not _has_result_line(proc.stdout)


def test_bench_refuses_cpu_without_flag():
    proc = _run(["bench.py", "--config", "social", "--batch", "8"])
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "no GPU found" in proc.stderr
    assert proc.stdout.strip() == ""


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert device.setup_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before  # untouched

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert device.setup_compile_cache() == device.DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == device.DEFAULT_CACHE_DIR
        assert device.DEFAULT_CACHE_DIR == os.path.join(ROOT, ".jax_cache")
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_summary_names_the_device(monkeypatch):
    monkeypatch.setenv("PATH", "")  # no nvidia-smi on the path
    s = device.device_summary()
    assert s["platform"] == "cpu" and s["count"] == len(jax.devices())
    assert s["card"].startswith("nvidia-smi unavailable")
    assert set(s) == {"platform", "kind", "count", "card", "xla_flags", "jax"}


def test_main_path_runs_without_pyyaml():
    """Only load_config_from_yaml needs PyYAML: the package imports and a
    batched tick runs with it blocked."""
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "import jax, jax.numpy as jnp\n"
        "import nav2_social_mpc_controller_tpu\n"
        "from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config\n"
        "from nav2_social_mpc_controller_tpu.controller.controller import make_carry, make_step_batch\n"
        "from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario_batch\n"
        "cfg = benchmark_social_config()\n"
        "scb = make_scenario_batch(cfg, 2, n_valid_people=3, grid_hw=(64, 64))\n"
        "carry = jax.vmap(lambda _: make_carry(cfg))(jnp.arange(2))\n"
        "cmd, aux, carry = make_step_batch(cfg)(scb, carry)\n"
        "assert bool(jnp.all(jnp.isfinite(cmd.linear_x)))\n"
        "print('tick ok')\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "tick ok" in proc.stdout


def test_card_line_reads_nvidia_smi(monkeypatch, tmp_path):
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 400.00 W'\necho 'second card'\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert device.card_line() == "NVIDIA H100 80GB HBM3, 400.00 W"


def test_native_generator_build_failure_raises(monkeypatch, tmp_path):
    """The measurement paths never fall back when the native build fails."""
    import pytest

    from nav2_social_mpc_controller_tpu.runtime import scenario_native as sn

    monkeypatch.setattr(sn, "_lib", None)
    monkeypatch.setattr(sn, "_LIB", str(tmp_path / "libscenario.so"))
    monkeypatch.setattr(sn, "_SRCS", [str(tmp_path / "missing.cpp")])
    (tmp_path / "missing.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="building the native scenario generator failed"):
        sn.require_native()
    assert sn._lib is None


def test_bench_memory_summary_reports_bytes():
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    import bench

    exe = jax.jit(lambda x: jnp.sin(x) @ x).lower(jnp.ones((8, 8))).compile()
    mem = bench.memory_summary(exe)
    assert mem is not None and mem["argument_size_in_bytes"] == 8 * 8 * 8
