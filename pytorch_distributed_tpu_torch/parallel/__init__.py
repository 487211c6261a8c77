"""Distributed bootstrap, meshes and parallel layouts of the PyTorch port,
with the JAX package's names where they exist
(``pytorch_distributed_tpu/parallel/__init__.py``): ``initialize`` joins
the launcher's process group, ``build_mesh`` lays a ``data × model`` mesh
over it, ``tp`` (Megatron) and ``fsdp`` split the LM over its axes.
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
from pytorch_distributed_tpu_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    build_mesh,
    data_parallel_mesh,
    device_for,
    local_device_count,
)
from pytorch_distributed_tpu_torch.parallel import fsdp, overlap, tp, zero
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
    "Mesh",
    "MeshSpec",
    "build_mesh",
    "data_parallel_mesh",
    "fsdp",
    "tp",
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
