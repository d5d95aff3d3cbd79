"""Multi-process backend: jax.distributed for meshes that span processes.

Reference analog: none — the reference is a single-process OpenMP tool
(SURVEY.md §2.3); this is the layer the distributed reorder
(parallel/dist.py) uses when its mesh spans several processes.

Run protocol (one process per host, same command everywhere):

    SPRING_TPU_COORD=host0:8476 SPRING_TPU_NPROCS=4 SPRING_TPU_PROC=$i \
        python -m spring_tpu.cli -c -i ... -o ...   # with SPRING_TPU_DIST=1

`maybe_initialize()` picks those up and calls jax.distributed.initialize
with the coordinator address, process count and process id; the device
mesh then spans every process's devices in jax.devices() order. Every
process loads the same input; device arrays are built through the helpers
below so each process only materializes its addressable shards:

  * put_replicated — same host value on every device (lengths, claimed
    bitmap, scalar knobs);
  * put_sharded    — global host array laid out along the mesh axis;
    each process carves out its addressable rows;
  * to_host        — fetch a (possibly non-addressable) device array back
    to every host, all_gathering across processes when needed.

Single-process (the tested path: the CPU tests run an 8-device virtual
mesh, and one process drives every GPU of a machine) these reduce to
plain device_put/np.asarray with the same semantics, so dist.py has ONE
code path for both.
"""
from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as Pspec

_initialized = False


def maybe_initialize() -> bool:
    """jax.distributed.initialize from SPRING_TPU_COORD/NPROCS/PROC (or
    standard JAX env). Idempotent; returns True when a multi-process
    runtime is (already) up.

    The env check comes FIRST: jax.process_count() initializes the XLA
    backend, and jax.distributed.initialize refuses to run after that
    (2-process smoke caught this — tools/multihost_smoke.py)."""
    global _initialized
    if _initialized:
        return True
    coord = os.environ.get("SPRING_TPU_COORD")
    if coord:
        nprocs = int(os.environ["SPRING_TPU_NPROCS"])
        proc = int(os.environ["SPRING_TPU_PROC"])
        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=nprocs, process_id=proc)
        _initialized = True
        return True
    if jax.process_count() > 1:
        _initialized = True
        return True
    return False


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def put_replicated(mesh: Mesh, x) -> jax.Array:
    """Host value -> device array replicated over the mesh (every process
    must pass the same value)."""
    return jax.device_put(np.asarray(x), NamedSharding(mesh, Pspec()))


def put_sharded(mesh: Mesh, x, axis: str = "shard") -> jax.Array:
    """Global host array -> device array sharded on dim 0 along `axis`.
    Multi-process: every process passes the same global array and jax
    materializes only the addressable shards."""
    return jax.device_put(np.asarray(x), NamedSharding(mesh, Pspec(axis)))


def to_host(x) -> np.ndarray:
    """Device array (any sharding) -> full host numpy on every process."""
    if not is_multiprocess() or x.is_fully_addressable:
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(
        x, tiled=True))
