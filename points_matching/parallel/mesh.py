"""Device-mesh runtime (SURVEY.md §2.3 P7): mesh construction, sharding
helpers, and multi-host bring-up.

The reference is single-process/single-machine (SURVEY.md §2.3); here the
unit of scale is a ``jax.sharding.Mesh`` whose axes the rest of the
framework names:

  * ``data``  — batch of image pairs / frames / RANSAC hypothesis groups
                (DP axis, BASELINE configs 1 and 4),
  * ``model`` — landmark / descriptor-row sharding inside one problem
                (TP axis: Schur reduction, all-pairs distance tiles).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axes: Tuple[str, ...] = (DATA_AXIS,),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a named device mesh.

    Defaults to a 1-D mesh over all local devices on the ``data`` axis.
    ``shape`` must multiply to the device count when given.
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axes) - 1)
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axes)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-controller bring-up (``jax.distributed.initialize``).

    No-op when running single-process (tests, single host).  On a
    multi-host cluster each host calls this before touching devices, with
    the coordinator address, process count and its own process id.
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def shard(mesh: Mesh, *spec) -> NamedSharding:
    """``NamedSharding`` shorthand: ``shard(mesh, 'data', None)``."""
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def host_local_to_global(mesh: Mesh, spec: "P", local_arr) -> jax.Array:
    """Assemble a global sharded array from each process's host-local shard
    (``jax.make_array_from_process_local_data``) — the per-host data feed
    path for multi-host runs (SURVEY.md §2.3 P7)."""
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, np.asarray(local_arr))
