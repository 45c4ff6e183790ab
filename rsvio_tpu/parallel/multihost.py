"""Multi-host setup helpers: process initialization + per-host data feeding.

Greenfield capability (SURVEY.md §5 "Distributed communication backend" and
§7 step 9): the reference is single-process. On a multi-host GPU cluster each
host process calls `initialize_distributed()` once; the global mesh then
spans all hosts' devices and the landmark-sharded BA (parallel.dist_ba)
reduces across them transparently through the same psum collectives.

Data feeding follows the standard JAX multi-host recipe: every process
feeds only the shard of the global batch that lives on its local devices
(`host_local_slice`), and `jax.make_array_from_single_device_arrays` (via
`jax.device_put` with a NamedSharding) assembles the global array view.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import LANDMARK_AXIS


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed for a multi-host run. No-op when the
    process count is 1 (single-host) or when already initialized."""
    if num_processes in (None, 1):
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    except RuntimeError:
        pass  # already initialized


def global_mesh() -> Mesh:
    """1-D landmark mesh over ALL devices across hosts (NVLink within a
    host, the network between hosts — XLA routes the psum accordingly)."""
    return Mesh(np.asarray(jax.devices()), (LANDMARK_AXIS,))


def host_local_slice(global_len: int):
    """(start, stop) of this host's shard of a globally landmark-sharded
    axis of length global_len (must divide evenly by process count)."""
    n_proc = jax.process_count()
    per = global_len // n_proc
    start = jax.process_index() * per
    return start, start + per


def shard_landmark_arrays(mesh: Mesh, *arrays, axis_index: int = 0):
    """Place arrays with their `axis_index` dimension sharded over the
    landmark axis (each host supplies only its local shard when running
    multi-process — pass host-local arrays of global logical shape via
    jax.make_array_from_process_local_data for that case)."""
    out = []
    for a in arrays:
        spec = [None] * np.ndim(a)
        spec[axis_index] = LANDMARK_AXIS
        out.append(jax.device_put(a, NamedSharding(mesh, P(*spec))))
    return tuple(out) if len(out) > 1 else out[0]
