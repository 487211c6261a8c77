"""Distributed bootstrap and the data-parallel device choice of the PyTorch
port, with the JAX package's names where they exist
(``pytorch_distributed_tpu/parallel/__init__.py``): the process group
``torch.distributed`` creates stands where the JAX package builds a mesh.
``zero`` (weight-update sharding) and ``overlap`` (bucketed gradient sync)
are the gradient-communication stack's, with ``ops/qcomm.py``.
"""

from pytorch_distributed_tpu_torch.parallel.dist import (
    DistContext,
    initialize,
    process_count,
    process_index,
    shutdown,
)
from pytorch_distributed_tpu_torch.parallel.mesh import device_for, local_device_count
from pytorch_distributed_tpu_torch.parallel import overlap, zero
from pytorch_distributed_tpu_torch.parallel.overlap import (
    bucketed_psum,
    bucketed_reduce_scatter,
    plan_buckets,
    resolve_overlap,
)
from pytorch_distributed_tpu_torch.parallel.zero import (
    gather_momentum,
    resolve_zero,
    shard_momentum,
)

__all__ = [
    "DistContext",
    "bucketed_psum",
    "bucketed_reduce_scatter",
    "device_for",
    "gather_momentum",
    "initialize",
    "local_device_count",
    "overlap",
    "plan_buckets",
    "process_count",
    "process_index",
    "resolve_overlap",
    "resolve_zero",
    "shard_momentum",
    "shutdown",
    "zero",
]
