"""Multi-host SPMD runtime helpers.

The reference is single-process (SURVEY.md §2.4); this framework scales
across hosts by running one process per host with `jax.distributed` and a
global mesh (NVLink within a host, the network across hosts).  Nothing else
in the framework changes: the shard_map programs in sdft_tpu.parallel.sharded
are already SPMD, so the same code runs on 1 device or N hosts.

Typical driver:

    from sdft_tpu.parallel import multihost, make_mesh, sharded_sdft
    multihost.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = multihost.global_mesh(time=jax.device_count() // 2, bins=2)
    ...
    state, dfts = sharded_sdft(plan, mesh, state, samples)

Host-local input: use `host_local_to_global` to assemble a global sharded
array from each host's shard of the sample stream without materializing the
full stream anywhere.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import AXES


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize the jax.distributed process group (idempotent).

    Pass all three arguments unless the cluster environment provides them
    to jax.distributed (SPMD contract: every host runs the same program).

    Must run before any other JAX call: probing the backend first (even
    ``jax.process_count()``) initializes a single-process runtime and makes
    the distributed setup fail — which is why this function must not
    "check then initialize" (a bug the real 2-process test caught; the
    mocked tier never exercised the ordering).
    """
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:
        if "already initialized" in str(e).lower():
            return  # idempotent re-entry
        if coordinator_address is None and num_processes is None:
            # best-effort auto-detect outside any cluster env: fall back to
            # the single-process runtime (SPMD code still works)
            return
        raise
    except ValueError:
        if coordinator_address is None and num_processes is None:
            return
        raise


def global_mesh(channel: int = 1, time: int = 1, bins: int = 1) -> Mesh:
    """Mesh over *all* processes' devices (jax.devices() is global)."""
    n = channel * time * bins
    devices = jax.devices()
    if n != len(devices):
        raise ValueError(
            f"mesh {channel}x{time}x{bins}={n} must use all {len(devices)} "
            f"global devices for multi-host SPMD")
    grid = np.array(devices).reshape(channel, time, bins)
    return Mesh(grid, AXES)


def host_local_to_global(mesh: Mesh, spec: P, host_arrays) -> jax.Array:
    """Assemble a global array from per-host local shards.

    Each process passes only its own slice of the data (e.g. its portion of
    a multi-channel sample stream); the result is a global sharded array
    usable with the sharded ops.
    """
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, np.asarray(host_arrays))


def global_array(mesh: Mesh, spec: P, host_value) -> jax.Array:
    """Build a global sharded array from a host value every process holds in
    full (e.g. the replicated carry State after a checkpoint restore): each
    local device's shard is sliced out of it, no cross-host transfer."""
    sharding = NamedSharding(mesh, spec)
    host_value = np.asarray(host_value)
    return jax.make_array_from_callback(host_value.shape, sharding,
                                        lambda idx: host_value[idx])
