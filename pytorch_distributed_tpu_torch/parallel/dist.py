"""Multi-process bootstrap, the port of ``pytorch_distributed_tpu/parallel/dist.py``.

One ``initialize()`` resolves who this process is and, when a launcher
named a world, creates the ``torch.distributed`` process group.  The
resolution order is the JAX package's, with the launcher's own environment
in the place of the TPU pod auto-detect:

1. explicit arguments;
2. ``PTD_TPU_COORDINATOR`` / ``PTD_TPU_NUM_PROCESSES`` /
   ``PTD_TPU_PROCESS_ID`` (the package's launcher contract);
3. SLURM (``SLURM_PROCID``, ``SLURM_NTASKS``, the first host of the
   nodelist, port ``PTD_TPU_PORT`` or 12355), counting processes, not nodes;
4. ``torch.distributed.run``'s environment: ``RANK``, ``WORLD_SIZE``,
   ``MASTER_ADDR:MASTER_PORT``, ``LOCAL_RANK``;
5. else one process and no group, as in JAX.

A world named by any launcher gets a process group even at world size 1,
so a single card runs the NCCL path.  The backend is NCCL when every local
rank has its own card, gloo on the CPU, and gloo on CUDA tensors when the
local ranks outnumber the cards and share them (several ranks on one
card); the choice is printed.  A failed init raises.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
from typing import Optional

import torch
import torch.distributed as dist

_LOOPBACK = ("127.0.0.1", "localhost", "::1")


@dataclasses.dataclass(frozen=True)
class DistContext:
    """Who am I in the job?  ``group`` is None without a launcher; then
    ``process_count`` is 1."""

    process_index: int
    process_count: int
    coordinator: Optional[str]
    local_rank: int = 0
    backend: Optional[str] = None
    group: Optional[object] = None

    @property
    def is_primary(self) -> bool:
        """Rank-0 guard for checkpointing and logging."""
        return self.process_index == 0


def _first_slurm_host(nodelist: str) -> str:
    """First hostname of a SLURM nodelist, dashed-hostname safe (a copy of
    the JAX function): ``scontrol show hostnames`` when present, else the
    bracket range expanded, never split on ``-`` outside brackets."""
    if not nodelist:
        return "127.0.0.1"
    try:
        out = subprocess.run(
            ["scontrol", "show", "hostnames", nodelist],
            capture_output=True, text=True, timeout=10,
        )
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.split()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    head = nodelist.split(",")[0]
    if "[" in head:
        prefix, rest = head.split("[", 1)
        first_token = rest.rstrip("]").split(",")[0].split("-")[0]
        return prefix + first_token
    return head


def _slurm_env() -> Optional[dict]:
    """Topology from SLURM, counting processes not nodes (a copy of the JAX
    function)."""
    if "SLURM_PROCID" not in os.environ:
        return None
    nodelist = os.environ.get("SLURM_STEP_NODELIST", os.environ.get("SLURM_NODELIST", ""))
    first = _first_slurm_host(nodelist)
    return {
        "process_id": int(os.environ["SLURM_PROCID"]),
        "num_processes": int(os.environ.get("SLURM_NTASKS", os.environ.get("SLURM_NPROCS", "1"))),
        "coordinator_address": f"{first}:{os.environ.get('PTD_TPU_PORT', '12355')}",
    }


def _launcher_env() -> Optional[dict]:
    """``torch.distributed.run``'s contract (reference ``start.sh:2``)."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    return {
        "process_id": int(env["RANK"]),
        "num_processes": int(env["WORLD_SIZE"]),
        "coordinator_address": f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                               f"{env.get('MASTER_PORT', '29500')}",
    }


def resolve(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
            process_id: Optional[int] = None) -> Optional[dict]:
    """``{"coordinator_address", "num_processes", "process_id", "source"}``
    from the first source in the order above that names a world, or None
    (one process, no launcher)."""
    env = os.environ
    if coordinator_address is not None:
        return {"coordinator_address": coordinator_address,
                "num_processes": int(num_processes or 1), "process_id": int(process_id or 0),
                "source": "arguments"}
    if "PTD_TPU_COORDINATOR" in env:
        return {"coordinator_address": env["PTD_TPU_COORDINATOR"],
                "num_processes": int(env.get("PTD_TPU_NUM_PROCESSES", "1")),
                "process_id": int(env.get("PTD_TPU_PROCESS_ID", "0")), "source": "PTD_TPU"}
    for source, found in (("SLURM", _slurm_env()), ("torch.distributed.run", _launcher_env())):
        if found is not None:
            return {**found, "source": source}
    return None


def _local_world(world: int, coordinator: str) -> int:
    """How many ranks of the job share this host."""
    env = os.environ
    if "LOCAL_WORLD_SIZE" in env:
        return int(env["LOCAL_WORLD_SIZE"])
    per_node = env.get("SLURM_NTASKS_PER_NODE", "")
    if per_node[:1].isdigit():  # "4" or "4(x2)"
        return int(per_node.split("(")[0])
    host = coordinator.rsplit(":", 1)[0].strip("[]")
    return world if host in _LOOPBACK else 1


def local_rank_of(process_id: int, n_cards: int) -> int:
    """This process's rank on its host: the launcher's ``LOCAL_RANK`` or
    ``SLURM_LOCALID``, else the global rank modulo the host's cards."""
    env = os.environ
    for key in ("LOCAL_RANK", "SLURM_LOCALID"):
        if key in env:
            return int(env[key])
    return process_id % max(1, n_cards)


def choose_backend(device_type: str, local_world: int, n_cards: int) -> str:
    """NCCL when each local rank has its own card; gloo on the CPU and for
    ranks that share a card."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if local_world <= n_cards else "gloo"


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: str = "cuda") -> DistContext:
    """Create the process group the launcher names (on ``device``'s type:
    ``cuda`` or ``cpu``) and return this process's ``DistContext``; with
    no launcher, one process and no group."""
    found = resolve(coordinator_address, num_processes, process_id)
    if found is None:
        return DistContext(0, 1, None)
    device_type = torch.device(device).type
    n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda" and n_cards == 0:
        raise RuntimeError(f"{found['source']} names a world of {found['num_processes']} on "
                           "cuda, but no CUDA device is present (pass --device cpu)")
    world, rank = found["num_processes"], found["process_id"]
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} is outside a world of {world}")
    coord = found["coordinator_address"]
    local_rank = local_rank_of(rank, n_cards)
    backend = choose_backend(device_type, _local_world(world, coord), n_cards)
    if device_type == "cuda":
        torch.cuda.set_device(local_rank % n_cards)
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group already exists in this process")
    dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=world,
                            rank=rank)
    print(f"=> process group: {backend} over {found['source']} ({coord}), rank {rank} of "
          f"{world}, local rank {local_rank}", flush=True)
    return DistContext(rank, world, coord, local_rank, backend, dist.group.WORLD)


def shutdown(ctx: DistContext) -> None:
    """Destroy the group ``initialize`` created (no-op without one)."""
    if ctx.group is not None and dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
