"""Host gather of (possibly multi-host-sharded) device fields.

The reference's only device->host movement is ``cp.asnumpy`` before VTK
writes (waam_from_stl_v7_mm.py:499-501).  The JAX equivalent must
also cover fields sharded over a ``jax.sharding.Mesh`` that spans
*processes*: ``np.asarray`` only works when every shard is addressable from
this process, which is false on a real multi-host pod.

``gather_to_host`` handles all three cases:

  * unsharded / single-process sharded -> plain ``np.asarray`` (the shards
    are addressable; jax assembles them);
  * multi-process sharded -> ``multihost_utils.process_allgather`` (an
    all-gather across processes; every process receives the full array — write
    output on process 0 only, see ``is_output_process``);
  * plain numpy input -> returned as-is.
"""
from __future__ import annotations

import jax
import numpy as np

__all__ = ["gather_to_host", "is_output_process"]


def gather_to_host(field) -> np.ndarray:
    """Materialize ``field`` on this host as a full (unsharded) numpy array,
    regardless of its device sharding.  Safe to call from every process of a
    multi-host run (it is collective there — every process must call it)."""
    if isinstance(field, np.ndarray):
        return field
    field = jax.numpy.asarray(field)
    if field.is_fully_addressable:
        return np.asarray(field)
    from jax.experimental import multihost_utils

    return np.asarray(
        multihost_utils.process_allgather(field, tiled=True))


def is_output_process() -> bool:
    """True on the process that should write VTK/checkpoint/log output
    (process 0; trivially true single-process)."""
    return jax.process_index() == 0
