"""Distributed bootstrap and the data-parallel device choice of the PyTorch
port, with the JAX package's names where they exist
(``pytorch_distributed_tpu/parallel/__init__.py``): the process group
``torch.distributed`` creates stands where the JAX package builds a mesh.
"""

from pytorch_distributed_tpu_torch.parallel.dist import (
    DistContext,
    initialize,
    process_count,
    process_index,
    shutdown,
)
from pytorch_distributed_tpu_torch.parallel.mesh import device_for, local_device_count

__all__ = [
    "DistContext",
    "device_for",
    "initialize",
    "local_device_count",
    "process_count",
    "process_index",
    "shutdown",
]
