"""Input pipeline of the PyTorch port (mirrors pytorch_distributed_tpu/data):
the sampler, the ImageFolder and synthetic datasets, the transforms, the
padded-batch loader with its uint8 wire modes and worker processes, the
device feeder, and the C++ data plane (``native/``).  Images are decoded
without PIL (``imageio.py``): the port does not depend on it.

Only ``loader.py`` imports torch, and it is imported when first asked for,
so a spawned loader worker, which unpickles a dataset of this package and
runs ``workers.py``, never imports torch."""

from pytorch_distributed_tpu_torch.data.datasets import ImageFolder, SyntheticImageDataset
from pytorch_distributed_tpu_torch.data.sampler import DistributedShardSampler


def __getattr__(name):
    if name in ("DataLoader", "DeviceFeeder"):
        from pytorch_distributed_tpu_torch.data import loader

        return getattr(loader, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["DistributedShardSampler", "SyntheticImageDataset", "ImageFolder", "DataLoader",
           "DeviceFeeder"]
