"""Mesh construction and sharding helpers.

The scaling strategy (SURVEY.md section 2.5): rays are i.i.d., so the load-
bearing axis is pure data parallelism — shard the ``[N, 3, 3]`` ray batch
over a 1-D ``data`` mesh axis, replicate the (small) params, and let GSPMD
insert the gradient ``psum`` across the devices.  A ``model`` axis is reserved in the
mesh API for future tensor sharding but stays size 1 for these model sizes.

Multi-host: call :func:`init_distributed` before touching devices; each
process then contributes its local batch slice via
:func:`global_batch_from_local`.
"""

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the JAX distributed runtime for multi-host meshes.

    No-op for single-process runs (the common case: one process drives
    every card of a host).
    With explicit flags it initializes exactly as asked; with NO flags it
    still calls ``jax.distributed.initialize()`` (argless autodetection)
    when the environment carries a multi-host launcher's coordinates —
    otherwise a user launching on several hosts without
    ``--num_processes`` would silently get per-host independent models
    racing writes to the same checkpoint path.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif num_processes is None and any(
        os.environ.get(var)
        for var in (
            "JAX_COORDINATOR_ADDRESS",  # jax.distributed's own env spec
            "COORDINATOR_ADDRESS",
        )
    ):
        jax.distributed.initialize()


def default_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """A ``(data, model)`` mesh over all devices, model axis size 1."""
    if devices is None:
        devices = jax.devices()
    arr = np.asarray(devices).reshape(len(devices), 1)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (ray) axis over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Fully replicated (params, scalars)."""
    return NamedSharding(mesh, P())


def macro_batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a ``[k, N, ...]`` multi-step batch over rays (axis 1); the
    leading scan axis stays replicated."""
    return NamedSharding(mesh, P(None, DATA_AXIS))


def global_batch_from_local(mesh: Mesh, local_batch: np.ndarray) -> jax.Array:
    """Assemble a globally-sharded batch from this process's local rows.

    Single-process: a plain ``device_put`` with the batch sharding.
    Multi-host: each host contributes its slice;
    ``jax.make_array_from_process_local_data`` stitches the global array
    without gathering rows onto any single host.
    """
    sharding = batch_sharding(mesh)
    if jax.process_count() == 1:
        return jax.device_put(local_batch, sharding)
    return jax.make_array_from_process_local_data(sharding, local_batch)
