"""Input pipeline of the PyTorch port (mirrors pytorch_distributed_tpu/data):
the sampler, the ImageFolder and synthetic datasets, the transforms, the
padded-batch loader with its uint8 wire modes and worker processes, the
device feeder, and the C++ data plane (``native/``).  Images are decoded
without PIL (``imageio.py``): the port does not depend on it."""

from pytorch_distributed_tpu_torch.data.datasets import ImageFolder, SyntheticImageDataset
from pytorch_distributed_tpu_torch.data.loader import DataLoader, DeviceFeeder
from pytorch_distributed_tpu_torch.data.sampler import DistributedShardSampler

__all__ = ["DistributedShardSampler", "SyntheticImageDataset", "ImageFolder", "DataLoader",
           "DeviceFeeder"]
