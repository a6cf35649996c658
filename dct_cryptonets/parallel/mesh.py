"""Device-mesh helpers for data-parallel training and ciphertext-batch
sharding.

The reference has no working multi-device path (``nn.DataParallel`` pinned
to one GPU; "Multi-GPU training is not currently supported with QAT
Brevitas", reference train.py:328-333, run_train.sh:13).  Here parallelism
is first-class.  The mesh is 1-D over ``jax.devices()``: the cards of a host
are joined all to all by NVLink, so no device order is better than another.

* training — 1-D ``data`` mesh; batches sharded on the leading axis, params
  replicated; XLA inserts the gradient all-reduce.
* encrypted eval — ciphertext batches are embarrassingly parallel across
  cards; the same `shard_batch` shards the PBS site axis while server keys
  are broadcast once (replicated sharding).
"""
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def data_mesh(num_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.asarray(devs), ("data",))


def shard_batch(mesh: Mesh, tree):
    """Shard the leading (batch) axis of every leaf across the mesh."""
    def put(x):
        spec = P("data", *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(put, tree)


def replicate(mesh: Mesh, tree):
    """Fully replicate a pytree (params, keys) across the mesh."""
    def put(x):
        return jax.device_put(x, NamedSharding(mesh, P()))
    return jax.tree_util.tree_map(put, tree)
