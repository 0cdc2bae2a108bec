"""Data parallelism and the tensor-parallel FC head over a ("data", "model") mesh.

Port of yolo_tpu/parallel/. One process per device joins a
``torch.distributed`` process group (:func:`initialize_distributed`);
:func:`make_mesh` lays the ranks out as JAX's ``("data", "model")`` mesh.
JAX's names map to the port's so:

- ``batch_sharding`` / ``put_sharded`` -> :func:`batch_slice` (this rank's
  rows of a global batch);
- ``param_shardings`` -> :func:`shard_head` (fc1 column-parallel, fc2
  row-parallel, everything else replicated), with
  :func:`sync_batch_norm` for the global batch's BN statistics;
- ``state_shardings`` -> :func:`full_state_dict` /
  :func:`load_full_state_dict` (the unsharded state in, out);
- ``replicated``: a tensor that no rule cuts is simply held whole by every
  rank.
"""

from yolo_tpu_torch.parallel.distributed import initialize_distributed
from yolo_tpu_torch.parallel.mesh import (
    batch_slice,
    full_state_dict,
    load_full_state_dict,
    make_mesh,
    shard_head,
    sync_batch_norm,
)

__all__ = [
    "batch_slice",
    "full_state_dict",
    "initialize_distributed",
    "load_full_state_dict",
    "make_mesh",
    "shard_head",
    "sync_batch_norm",
]
