"""Device choice for data parallelism, the port of the pure-DP part of
``pytorch_distributed_tpu/parallel/mesh.py``.

Under ``torch.distributed`` each process drives one device, so the port's
whole "mesh" for data parallelism is the rank -> device map: the local
rank's card (``cuda:<local_rank>``, wrapped over the host's cards when
ranks share them), or the CPU.  The ``model``, ``seq``, ``pipe`` and
``expert`` axes wait for ROADMAP.md item A10.
"""

from __future__ import annotations

import torch

from pytorch_distributed_tpu_torch.parallel.dist import DistContext
from pytorch_distributed_tpu_torch.utils.device import resolve_device


def local_device_count(device: str = "cuda") -> int:
    """Devices of ``device``'s type this host addresses: the reference's
    ``torch.cuda.device_count()``, or 1 for the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def device_for(ctx: DistContext, device: str = "cuda") -> torch.device:
    """The device rank ``ctx`` computes on: ``cuda:<local_rank>`` (modulo
    the cards), or ``device`` itself when it is not CUDA or names an index.
    Raises for CUDA without a card."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", ctx.local_rank % max(1, torch.cuda.device_count()))
