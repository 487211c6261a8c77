"""The device mesh over the process group, the port of
``pytorch_distributed_tpu/parallel/mesh.py`` (``MeshSpec``, ``build_mesh``,
``data_parallel_mesh``).

Under ``torch.distributed`` each process drives one device, so a mesh is a
shape laid over the ranks, row-major with the last axis innermost, as the
JAX package lays it over ``jax.devices()``: for ``("data", "model")`` of
shape ``(dp, tp)`` rank ``r`` sits at data index ``r // tp`` and model index
``r % tp``, so a model group is ``tp`` consecutive ranks and never spans
two data replicas.  Each axis line gets its own ``torch.distributed``
subgroup (every rank creates every line's group, in one order, as
``new_group`` requires); an axis that spans every rank takes the process
group itself (at world 1 too), another axis of size 1 has no group, and
every collective over it is a no-op.  Without a process group the mesh is
one rank and has no groups at all.

Also the rank -> device map: the local rank's card (``cuda:<local_rank>``,
wrapped over the host's cards when ranks share them), or the CPU.
``build_hybrid_mesh`` (multi-slice) is not ported (ROADMAP.md item A10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.parallel.dist import DistContext
from pytorch_distributed_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape.  ``-1`` for at most one axis means "all remaining
    devices" (like a reshape wildcard).  A copy of the JAX class."""

    axes: Tuple[str, ...] = ("data",)
    shape: Tuple[int, ...] = (-1,)

    def resolve(self, n_devices: int) -> Tuple[int, ...]:
        shape = list(self.shape)
        wild = [i for i, s in enumerate(shape) if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {self.shape}")
        fixed = int(np.prod([s for s in shape if s != -1])) if shape else 1
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}"
                )
            shape[wild[0]] = n_devices // fixed
        if int(np.prod(shape)) != n_devices:
            raise ValueError(
                f"mesh shape {tuple(shape)} != device count {n_devices}"
            )
        return tuple(shape)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh: ``shape`` per axis name, its ``coords``
    along each axis, the subgroup of its line along each (None for an axis
    of size 1) and ``world``, the group of every rank (None without a
    process group)."""

    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, Optional[object]]
    world: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    def size(self, axis: str) -> int:
        """The axis's size (1 for an axis the mesh lacks)."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    @property
    def is_primary(self) -> bool:
        return self.rank == 0


def build_mesh(spec: MeshSpec = MeshSpec(), ctx: Optional[DistContext] = None) -> Mesh:
    """The mesh of ``spec`` over the process group of ``ctx`` (or over the
    one process when there is none).  Collective: every rank of the group
    calls it with the same spec."""
    group = ctx.group if ctx is not None else None
    world = ctx.process_count if group is not None else 1
    rank = ctx.process_index if group is not None else 0
    sizes = spec.resolve(world)
    coords_arr = np.unravel_index(rank, sizes)
    coords = {a: int(c) for a, c in zip(spec.axes, coords_arr)}
    ranks = np.arange(world).reshape(sizes)
    groups: Dict[str, Optional[object]] = {}
    for i, axis in enumerate(spec.axes):
        groups[axis] = None
        if sizes[i] == world and group is not None:
            # Every rank on this axis (at world 1 too: a launcher's group of
            # one still runs the collectives, as a card runs NCCL).
            groups[axis] = group
            continue
        if sizes[i] == 1:
            continue
        lines = np.moveaxis(ranks, i, -1).reshape(-1, sizes[i])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    return Mesh(tuple(spec.axes), tuple(sizes), rank, coords, groups, group)


def data_parallel_mesh(ctx: Optional[DistContext] = None) -> Mesh:
    """The reference-parity 1-D mesh: every rank on one ``data`` axis."""
    return build_mesh(MeshSpec(("data",), (-1,)), ctx)


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
