"""Multi-host scale-out: jax.distributed initialization, global meshes, and
host-local scenario feeding.

The accelerator replacement for the reference's process/topic architecture at
fleet scale (SURVEY.md section 5.8): each host process generates/ingests its
local scenario shard, arrays are assembled into jax.Arrays over a global
(hosts x local-devices) batch mesh, the distributed step runs under
shard_map with collectives only for metric reductions.

Tested without accelerator hardware via the standard fake-cluster technique: N local
processes, each with M virtual CPU devices, coordinated through
jax.distributed (tests/test_multihost.py spawns 2x4).
"""

from typing import Optional

import jax
import numpy as np

from nav2_social_mpc_controller_tpu.parallel.mesh import BATCH_AXIS, batch_sharding, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """jax.distributed.initialize wrapper. Where the cluster environment is
    one JAX can read (e.g. SLURM), call with no arguments (auto-detection);
    otherwise — a fake CPU cluster, or GPU hosts without such an
    environment — pass coordinator/num/id explicitly."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_global_mesh():
    """1-D batch mesh over ALL global devices (every process must call with
    the same arguments, like any jax collective setup)."""
    return make_mesh(devices=jax.devices())


def host_local_to_global(mesh, host_local_batch):
    """Assemble per-process host-local scenario batches (leading axis =
    local batch) into global jax.Arrays sharded over the batch mesh.

    Each process contributes its own rows; the global batch is the
    concatenation in process order (jax.make_array_from_process_local_data).
    """
    sharding = batch_sharding(mesh)

    def build(x):
        x = np.asarray(x)
        global_shape = (x.shape[0] * jax.process_count(),) + x.shape[1:]
        return jax.make_array_from_process_local_data(sharding, x, global_shape)

    return jax.tree.map(build, host_local_batch)


def global_batch_size(mesh, per_device: int) -> int:
    return per_device * mesh.devices.size
