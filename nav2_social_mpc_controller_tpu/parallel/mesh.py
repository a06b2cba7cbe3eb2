"""Multi-device scale-out: mesh construction, scenario sharding, and the
distributed batched step.

There is no reference equivalent — the reference is single-problem,
single-thread CPU (SURVEY.md section 2.3); its "communication backend" is ROS
DDS pub/sub. The batched replacement (SURVEY.md section 5.8):

  * a 1-D ``batch`` device mesh (optionally (host, batch) on multi-host
    slices), scenarios data-parallel across it;
  * ``shard_map`` over the batch axis — scenario solves are independent, so
    the only collectives are ``psum`` reductions of METRICS (solve counters,
    mean iterations, status histograms) over the device interconnect;
  * host-side scenario feeding via ``jax.device_put`` with NamedSharding.

Use ``jax.distributed.initialize()`` before building the mesh on multi-host
deployments; single-host multi-chip and the CPU fake cluster
(``--xla_force_host_platform_device_count=N``) need no initialization.
"""

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nav2_social_mpc_controller_tpu.controller.controller import step
from nav2_social_mpc_controller_tpu.core.config import SocialMPCConfig

BATCH_AXIS = "batch"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D batch mesh over the first n_devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (BATCH_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(BATCH_AXIS))


def shard_batch(mesh: Mesh, pytree):
    """Place a host batch (leading axis divisible by mesh size) onto the mesh,
    split along the batch axis."""
    sh = batch_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), pytree)


class FleetMetrics(NamedTuple):
    """Cross-chip psum-reduced telemetry (the only inter-chip communication
    in the framework — scenarios are independent)."""

    n_scenarios: jnp.ndarray
    n_usable: jnp.ndarray
    n_status_ok: jnp.ndarray
    total_iterations: jnp.ndarray
    mean_final_cost: jnp.ndarray


def make_distributed_step(cfg: SocialMPCConfig, mesh: Mesh):
    """Jitted shard_map'd batched step over the mesh's batch axis.

    Input scenario/carry pytrees must have a leading axis divisible by the
    mesh size. Returns (cmd, aux, carry') sharded like the inputs, plus
    FleetMetrics replicated on every device.
    """

    def local_step(scenario, carry):
        cmd, aux, new_carry = jax.vmap(functools.partial(step, cfg))(scenario, carry)
        n_local = aux.status.shape[0]
        metrics = FleetMetrics(
            n_scenarios=jax.lax.psum(jnp.asarray(n_local, jnp.int32), BATCH_AXIS),
            n_usable=jax.lax.psum(jnp.sum(aux.solve.usable.astype(jnp.int32)), BATCH_AXIS),
            n_status_ok=jax.lax.psum(jnp.sum((aux.status == 0).astype(jnp.int32)), BATCH_AXIS),
            total_iterations=jax.lax.psum(jnp.sum(aux.solve.iterations), BATCH_AXIS),
            mean_final_cost=jax.lax.pmean(jnp.mean(aux.solve.final_cost), BATCH_AXIS),
        )
        return cmd, aux, new_carry, metrics

    # check_vma=False: the LM while_loop carries batch-invariant scalars
    # (trust-region constants) that the varying-manual-axes checker would
    # force through pcast; there are no cross-scenario collectives inside the
    # solver, so the check is safely relaxed.
    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
        out_specs=(P(BATCH_AXIS), P(BATCH_AXIS), P(BATCH_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(sharded)
