"""Multi-host scenario campaigns: the BASELINE config-5 entry point
(100k+ concurrent scenarios, multi-tick with warm-start carry and
checkpoint/resume) on a multi-host cluster — or a local
fake cluster of N processes x M virtual CPU devices.

The reference's fleet story is one robot per process tree (Nav2 controller
server + DDS); the batched equivalent is scenario data-parallelism over a
global (hosts x local-devices) batch mesh (SURVEY.md section 2.3/5.8):
each host generates its local scenario shard, the distributed step runs under
shard_map with psum'd FleetMetrics as the only cross-chip traffic, and the
warm-start carry feeds back tick over tick exactly like the single-chip path.

Usage (CLI wiring in __main__.py):
  # real pod (one process per host, jax.distributed auto-detect):
  python -m nav2_social_mpc_controller_tpu multihost --ticks 100

  # local fake cluster, 2 processes x 4 virtual CPU devices:
  python -m nav2_social_mpc_controller_tpu multihost --processes 2 \
      --devices-per-process 4 --ticks 10 --per-device-batch 8
"""

import json
import os
import time
from typing import Optional

import numpy as np


def _carry_ckpt_path(base: str, process_index: int) -> str:
    return f"{base}.proc{process_index}"


def run_campaign(
    cfg,
    ticks: int,
    per_device_batch: int,
    n_people: int = 3,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    log=lambda m: None,
):
    """Worker body: run `ticks` distributed control ticks over the global
    mesh. Call AFTER jax.distributed is initialized (or standalone for a
    single process). Each process contributes per_device_batch x
    local_device_count scenarios; the carry (TrajectoryMemory equivalent) is
    checkpointed host-locally every `checkpoint_every` ticks and restored
    with --resume. Returns a summary dict (identical on every process)."""
    import jax
    import jax.numpy as jnp

    from nav2_social_mpc_controller_tpu.controller.controller import make_carry
    from nav2_social_mpc_controller_tpu.parallel import multihost
    from nav2_social_mpc_controller_tpu.parallel.mesh import make_distributed_step
    from nav2_social_mpc_controller_tpu.utils.checkpoint import restore_carry, save_carry
    from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario_batch

    pid = jax.process_index()
    mesh = multihost.make_global_mesh()
    local_batch = per_device_batch * jax.local_device_count()
    global_batch = local_batch * jax.process_count()

    log(f"[proc {pid}] generating {local_batch} local scenarios...")
    scb_local = make_scenario_batch(
        cfg, local_batch, base_seed=seed + 100_000 * pid, n_valid_people=n_people,
        grid_hw=(64, 64),
    )
    carry_local = jax.tree.map(
        np.asarray, jax.vmap(lambda _: make_carry(cfg))(jnp.arange(local_batch))
    )
    start_tick = 0
    if resume and checkpoint_path:
        p = _carry_ckpt_path(checkpoint_path, pid)
        meta_p = p + ".meta.json"
        if os.path.exists(p + ".npz") or os.path.isdir(p):
            carry_local = restore_carry(p, carry_local)
            if os.path.exists(meta_p):
                with open(meta_p) as f:
                    start_tick = json.load(f)["tick"]
            log(f"[proc {pid}] resumed carry from {p} at tick {start_tick}")

    scb = multihost.host_local_to_global(mesh, scb_local)
    carry = multihost.host_local_to_global(mesh, carry_local)
    step = make_distributed_step(cfg, mesh)  # already jitted

    def save(tick):
        if not checkpoint_path:
            return
        # Host-local shards only: each process persists what it can address.
        local = jax.tree.map(
            lambda x: np.concatenate([np.asarray(s.data) for s in x.addressable_shards]),
            carry,
        )
        p = save_carry(_carry_ckpt_path(checkpoint_path, pid), local, use_orbax=False)
        with open(_carry_ckpt_path(checkpoint_path, pid) + ".meta.json", "w") as f:
            json.dump({"tick": tick, "local_batch": local_batch}, f)
        log(f"[proc {pid}] checkpointed tick {tick} -> {p}")

    t0 = time.perf_counter()
    metrics = None
    for t in range(start_tick, ticks):
        # Per-tick pose jitter keeps every stage live (see bench.py).
        eps = np.float32(1e-6 * t)
        scb_t = scb._replace(robot=scb.robot._replace(pose=scb.robot.pose + eps))
        cmd, aux, carry, metrics = step(scb_t, carry)
        if checkpoint_every and (t + 1) % checkpoint_every == 0:
            jax.block_until_ready(carry)
            save(t + 1)
    jax.block_until_ready(carry)
    elapsed = time.perf_counter() - t0
    if checkpoint_path:
        save(ticks)

    n_ticks_run = ticks - start_tick
    summary = {
        "global_batch": global_batch,
        "processes": jax.process_count(),
        "devices": jax.device_count(),
        "ticks": n_ticks_run,
        "resumed_from_tick": start_tick,
        "elapsed_s": round(elapsed, 3),
        "solves_per_s": round(global_batch * max(n_ticks_run, 0) / max(elapsed, 1e-9), 1),
        "n_scenarios": int(metrics.n_scenarios) if metrics is not None else 0,
        "n_usable": int(metrics.n_usable) if metrics is not None else 0,
        "n_status_ok": int(metrics.n_status_ok) if metrics is not None else 0,
        "mean_lm_iters": (
            float(metrics.total_iterations) / max(int(metrics.n_scenarios), 1)
            if metrics is not None
            else 0.0
        ),
        "mean_final_cost": float(metrics.mean_final_cost) if metrics is not None else 0.0,
    }
    return summary


def find_free_port() -> int:
    """Reserve an ephemeral localhost port (bind-0 trick) for fake-cluster
    coordinators, so parallel test/CI runs never collide on a fixed port."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_fake_cluster(
    argv_tail,
    processes: int,
    devices_per_process: int,
    port: int = 0,
    timeout: float = 540.0,
):
    """Launch `processes` copies of the CLI in --worker mode on a localhost
    coordinator, each with `devices_per_process` virtual CPU devices (the
    standard JAX fake-cluster technique; SURVEY.md section 4d). Returns the
    list of (returncode, output) per process. port=0 picks an ephemeral
    port."""
    import subprocess
    import sys

    if port == 0:
        port = find_free_port()

    env_base = dict(os.environ)
    env_base.pop("JAX_PLATFORMS", None)
    flags = env_base.get("XLA_FLAGS", "")
    # Replace any inherited device-count flag with the per-process one.
    parts = [f for f in flags.split() if "xla_force_host_platform_device_count" not in f]
    parts.append(f"--xla_force_host_platform_device_count={devices_per_process}")
    env_base["XLA_FLAGS"] = " ".join(parts)

    procs = []
    for pid in range(processes):
        cmd = [
            sys.executable,
            "-m",
            "nav2_social_mpc_controller_tpu",
            "multihost",
            "--worker",
            "--coordinator",
            f"localhost:{port}",
            "--num-processes",
            str(processes),
            "--process-id",
            str(pid),
            "--force-cpu",
        ] + argv_tail
        procs.append(
            subprocess.Popen(
                cmd,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                env=env_base,
                text=True,
            )
        )
    results = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        results.append((p.returncode, out))
    return results
