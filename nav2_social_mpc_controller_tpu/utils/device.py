"""What the measurement paths (bench.py, chip_smoke.py) record about the
device they ran on, and where they keep JAX's persistent compile cache."""

import os
import subprocess

import jax

# Repo checkout root (the package's parent directory).
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_ROOT, ".jax_cache")


def setup_compile_cache() -> str:
    """Persistent compile cache: JAX_COMPILATION_CACHE_DIR when the
    environment sets it (JAX reads it itself), else a fixed directory inside
    the checkout — a fixed path, because the path is part of the cache key.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, or a
    note saying why there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[0] if lines else "nvidia-smi returned no card"


def device_summary() -> dict:
    """The device fields every measurement prints beside its numbers."""
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "card": card_line(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "jax": jax.__version__,
    }
