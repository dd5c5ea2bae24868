"""Multi-host process groups and meshes (SURVEY §5.8).

The reference has no distribution at all (no MPI/NCCL/sockets — its only OS
interface is mmap, reference virtual_array.cpp:15-24).  This build's
multi-host story is the JAX-native one:

* ``jax.distributed.initialize`` forms the process group (NCCL between
  GPUs, gloo for CPU process groups),
* one global 1-D device mesh spans all hosts' devices; the Morton-range
  sharding of ``parallel.sharded`` is laid over it unchanged — XLA routes
  the block-row halo ``all_to_all`` through the collectives library,
* each host feeds its local shard of the point batch
  (``host_local_points`` / ``global_shard_array``), and finalization
  gathers per-shard block extracts host-side (submap merge,
  core/submap.finalize_sharded).

On a single-host environment these helpers degrade to the local device
mesh, so the same driver script runs everywhere.  A true 2-process run is
exercised by tests/test_distributed.py, which spawns two CPU processes with
gloo collectives and checks the sharded insert against the single-device
oracle — the "multi-host without a cluster" idiom of SURVEY §4.
"""

from __future__ import annotations

import os

import jax
import numpy as np

from .sharded import make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize the multi-host process group.

    No-ops on single-process runs.  Arguments default from the standard
    environment (JAX_COORDINATOR_ADDRESS etc.).  On the CPU backend the
    gloo collectives implementation is selected so cross-process
    all_to_all/psum work without accelerators.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return
    # NOTE: must not touch the backend (jax.devices()/default_backend())
    # before jax.distributed.initialize — inspect config/env only.
    if "cpu" in (os.environ.get("JAX_PLATFORMS", "") or
                 (jax.config.jax_platforms or "")):
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axis: str = "shard"):
    """One 1-D mesh over every chip of every host."""
    return make_mesh(axis=axis)


def global_shard_array(host_value: np.ndarray, mesh, spec):
    """Build a global jax.Array from an identically-computed host value.

    In multi-controller JAX a jitted function may only consume host numpy
    directly when it is fully replicated; sharded inputs must be global
    ``jax.Array``s.  Every process passes the same full ``host_value``
    (deterministically computed, e.g. the Morton-split scan) and receives
    the global array holding only its addressable shards.
    """
    from jax.sharding import NamedSharding
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        host_value.shape, sharding, lambda idx: host_value[idx])


def host_local_points(points: np.ndarray, max_points_per_device: int):
    """Split this host's point cloud across its addressable devices and pad
    to the static per-device capacity.

    Returns (padded (n_local_devices * cap, 3) f32, n_per_device i32).
    """
    local = jax.local_device_count()
    cap = max_points_per_device
    out = np.zeros((local * cap, 3), np.float32)
    n_per = np.zeros((local,), np.int32)
    chunks = np.array_split(np.asarray(points, np.float32), local)
    for i, c in enumerate(chunks):
        c = c[:cap]
        out[i * cap:i * cap + len(c)] = c
        n_per[i] = len(c)
    return out, n_per


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": jax.local_device_count(),
        "global_devices": jax.device_count(),
    }
