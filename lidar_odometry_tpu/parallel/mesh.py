"""Device-mesh helpers for the sharded map and distributed PGO.

The reference's only "parallelism" is three CPU threads (SURVEY.md §2.3);
distribution here is a new design mandated by the north star: a `Mesh`
with a `map` axis (spatial key-range shards of the voxel tables — the
tensor-parallel analog) and a `data` axis (independent sequences for
throughput — the data-parallel analog). Collectives are psum/all_gather
inside shard_map; on a multi-GPU host XLA lowers them to NCCL over NVLink.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "initialize_multihost", "P", "Mesh", "NamedSharding"]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data", "map")) -> Mesh:
    """Build a mesh over the first n devices (all when None). With two
    axes the device count is factored as evenly as possible
    (data-major). Raises ValueError when fewer than n devices exist."""
    available = jax.devices()
    n = n_devices or len(available)
    if n > len(available):
        raise ValueError(
            f"a {n}-device mesh was requested but only {len(available)} "
            f"{available[0].platform} device(s) exist")
    devices = available[:n]
    if len(axis_names) == 1:
        return Mesh(np.asarray(devices), axis_names)
    d = 1
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            d = cand
            break
    shape = (d, n // d)
    return Mesh(np.asarray(devices).reshape(shape), axis_names)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> int:
    """Join a multi-host process group (SURVEY.md §2.5: process groups via
    `jax.distributed.initialize`; collectives run over NVLink within a
    host and the cluster network across hosts once every process
    contributes its local devices).

    Call once per process before any JAX computation; after it,
    `jax.devices()` spans ALL hosts and `make_mesh()` builds global
    meshes, so the sharded map / distributed PGO run unchanged across
    hosts. Arguments fall back to the standard env vars
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID) or
    JAX's cluster auto-detection where the scheduler provides it.
    Returns this process's id."""
    import os
    kw = {}
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        kw["coordinator_address"] = addr
    if num_processes is not None or os.environ.get("JAX_NUM_PROCESSES"):
        kw["num_processes"] = int(num_processes
                                  if num_processes is not None
                                  else os.environ["JAX_NUM_PROCESSES"])
    if process_id is not None or os.environ.get("JAX_PROCESS_ID"):
        kw["process_id"] = int(process_id
                               if process_id is not None
                               else os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(**kw)
    return jax.process_index()
