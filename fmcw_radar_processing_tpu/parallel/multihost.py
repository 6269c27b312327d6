"""Multi-host orchestration: distributed init, global input feed, host-0
payload assembly.

The reference scales by running more Azure service replicas, each
processing a whole recording alone (SURVEY §2.3, README.md:35-38). Here
the model is one *program* spanning hosts: every process holds a shard of
the frame axis, the chain runs SPMD over the global mesh (NVLink within a
host, the network across hosts — XLA inserts the collectives from
sharding annotations), and process 0 assembles/uploads the JSON payloads
(SURVEY §5.8: "all_gather to host 0 for JSON assembly").

Single-process use (tests, one chip, the virtual CPU mesh) degrades to
no-ops: `initialize()` skips `jax.distributed`, the "global" mesh is the
local mesh, and gathers are identity copies.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.experimental import multihost_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fmcw_radar_processing_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> int:
    """Bring up jax.distributed when multi-process; return process index.

    With no arguments and no cluster environment, this is a no-op
    (single-process). Where no cluster environment tells JAX the
    coordinator, pass ``coordinator_address`` (e.g. ``localhost:<port>``),
    ``num_processes`` and ``process_id`` explicitly.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index()


def global_mesh(model: int = 1, devices=None) -> Mesh:
    """(data, model) mesh over every device of every process."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n % model:
        raise ValueError(f"{n} devices not divisible by model={model}")
    arr = np.asarray(devices).reshape(n // model, model)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def distribute_frames(raw_local: np.ndarray, mesh: Mesh) -> jax.Array:
    """Build the frame-sharded global array from per-host local shards.

    raw_local: this host's contiguous chunk of the frame axis (equal chunk
    per host). Returns a global jax.Array sharded P(data, ...) over the
    mesh — the input format of parallel.sharded_chain. Single-process:
    just device_put with the sharding.
    """
    sharding = NamedSharding(
        mesh, P(DATA_AXIS, *([None] * (raw_local.ndim - 1)))
    )
    if jax.process_count() == 1:
        return jax.device_put(raw_local, sharding)
    return multihost_utils.host_local_array_to_global_array(
        raw_local, mesh, P(DATA_AXIS, *([None] * (raw_local.ndim - 1)))
    )


def gather_to_all(tree):
    """Fetch fully-replicated NumPy copies of (possibly sharded) outputs.

    Cross-host shards ride the DCN allgather; single-process it is a
    device-to-host copy. Every process returns the same values.
    """
    if jax.process_count() == 1:
        return jax.tree_util.tree_map(np.asarray, tree)
    return multihost_utils.process_allgather(tree, tiled=True)


def on_host0(fn, *args, **kwargs):
    """Run fn only on process 0 (payload writes, uploads); None elsewhere.

    A barrier follows so no process races ahead of the artifact writes —
    the moral equivalent of the reference's sequential upload step
    (radar_processing_with_azure.m:67-85).
    """
    result = None
    if jax.process_index() == 0:
        result = fn(*args, **kwargs)
    if jax.process_count() > 1:
        multihost_utils.sync_global_devices("fmcw_host0_barrier")
    return result
