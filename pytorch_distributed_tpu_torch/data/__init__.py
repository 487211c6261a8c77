"""Input pipeline of the PyTorch port (mirrors pytorch_distributed_tpu/data):
the sampler, the synthetic image dataset, the padded-batch loader and the
device feeder.  ``ImageFolder`` and the transforms wait for ROADMAP.md item
A17."""

from pytorch_distributed_tpu_torch.data.datasets import SyntheticImageDataset
from pytorch_distributed_tpu_torch.data.loader import DataLoader, DeviceFeeder
from pytorch_distributed_tpu_torch.data.sampler import DistributedShardSampler

__all__ = ["DistributedShardSampler", "SyntheticImageDataset", "DataLoader", "DeviceFeeder"]
