"""Multi-host (multi-process) initialization and 2-D host x chip meshes.

The reference has no distributed backend at all (no NCCL/MPI/Gloo anywhere;
``nn.DataParallel`` is single-process — SURVEY §2.3).  Here the story is
``jax.distributed`` + SPMD: every host runs the same program, sees only its
local devices, and XLA inserts the collectives (the gradient all-reduce
rides NVLink among the cards of one host, which are joined all to all, and
the network between hosts).

For the encrypted-eval workload the sharding story is unchanged at any
scale: ciphertext batches are embarrassingly parallel, server keys are
replicated (a one-time broadcast), and the only cross-host traffic is the
per-batch metric reduction.

Tested without hardware by spawning N processes on one machine with the
CPU backend (tests/test_multihost.py), the way a multi-host fleet runs one
process per host.
"""
import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import data_mesh, replicate, shard_batch  # noqa: F401


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> None:
    """Bring up the multi-process runtime (idempotent single-process no-op).

    The coordinator address (``host:port``), process count and process id
    are passed explicitly: nothing in the environment announces a cluster
    (the multi-process CPU tests pass them the same way).
    """
    if num_processes is None and coordinator_address is None:
        # single-process runs (the common local case): nothing to do
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def host_chip_mesh(chips_per_host: int | None = None) -> Mesh:
    """2-D ('host', 'chip') mesh over all global devices.

    Rows are processes (the network between hosts), columns are each
    host's local cards (NVLink).  Data parallelism shards batches over BOTH
    axes (the flattened mesh); layouts that need intra-host locality (e.g.
    a future GLWE tensor-parallel split) would shard their axis over 'chip'
    only so its collectives stay on NVLink.
    """
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_proc = jax.process_count()
    per = len(devs) // n_proc if chips_per_host is None else chips_per_host
    grid = np.asarray(devs).reshape(n_proc, per)
    return Mesh(grid, ("host", "chip"))


def global_data_mesh() -> Mesh:
    """1-D 'data' mesh over all global devices (all hosts)."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devs), ("data",))


def local_batch_to_global(mesh: Mesh, tree):
    """Assemble a globally-sharded batch from PER-HOST local shards.

    Every process passes its LOCAL portion of the batch (leading axis =
    global_batch / process_count); the returned arrays are global jax.Arrays
    sharded over the mesh's flattened device list, addressable-shard-wise
    backed by the local data.  This is the multi-host analog of
    ``mesh.shard_batch`` and the input side of a data-parallel step.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    axes = mesh.axis_names

    def put(x):
        x = np.asarray(x)
        spec = P(axes if len(axes) > 1 else axes[0],
                 *([None] * (x.ndim - 1)))
        global_shape = (x.shape[0] * jax.process_count(), *x.shape[1:])
        sharding = NamedSharding(mesh, spec)
        local_devs = [d for d in mesh.devices.ravel()
                      if d.process_index == jax.process_index()]
        per_dev = np.split(x, len(local_devs))
        bufs = [jax.device_put(s, d) for s, d in zip(per_dev, local_devs)]
        return jax.make_array_from_single_device_arrays(
            global_shape, sharding, bufs)
    return jax.tree_util.tree_map(put, tree)
