"""The port's data-parallel bootstrap and image recipes on the CPU, one
process each (the two-rank runs are in ``test_torch_dist_train.py``).

- ``parallel/dist.py``: the resolution order of ``initialize`` under each
  launcher contract (explicit arguments, ``PTD_TPU_*``, SLURM,
  ``torch.distributed.run``, none), the SLURM host parser against the JAX
  function on the same nodelists, the backend rule, a real world-1 gloo
  group, the JAX trainer's batch-division error.
- The six recipes and ``tpu_native``, one epoch each at resnet18, 32x32,
  batch 16, as ``tests/test_recipes.py`` runs the JAX ones, with each
  recipe's defaults; ``--dist-file`` accepted; ``--grad-compress int8``
  still exits naming ROADMAP.md item A9.
"""

import os
import socket

import pytest
import torch

from pytorch_distributed_tpu.parallel import dist as jax_dist
from pytorch_distributed_tpu_torch.parallel import DistContext, device_for, dist
from pytorch_distributed_tpu_torch.recipes import (
    apex_distributed,
    dataparallel,
    distributed,
    distributed_slurm_main,
    horovod_distributed,
    multiprocessing_distributed,
    tpu_native,
)
from pytorch_distributed_tpu_torch.recipes._common import finish
from pytorch_distributed_tpu_torch.train.config import parse_config
from pytorch_distributed_tpu_torch.train.trainer import Trainer

SMOKE_ARGS = ["--device", "cpu", "--synthetic", "--synthetic-length", "32", "-a", "resnet18",
              "--image-size", "32", "--num-classes", "4", "-b", "16", "--epochs", "1",
              "-p", "1", "--seed", "0"]
LAUNCH_VARS = ("PTD_TPU_COORDINATOR", "PTD_TPU_NUM_PROCESSES", "PTD_TPU_PROCESS_ID",
               "PTD_TPU_PORT", "SLURM_PROCID", "SLURM_NTASKS", "SLURM_NPROCS",
               "SLURM_NODELIST", "SLURM_STEP_NODELIST", "SLURM_LOCALID",
               "SLURM_NTASKS_PER_NODE", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
               "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _set(monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))


def test_no_launcher_is_one_process_without_a_group():
    assert dist.resolve() is None
    ctx = dist.initialize(device="cpu")
    assert (ctx.process_index, ctx.process_count, ctx.group) == (0, 1, None)


def test_resolution_order(monkeypatch):
    _set(monkeypatch, RANK=3, WORLD_SIZE=8, MASTER_ADDR="10.0.0.9", MASTER_PORT=29501)
    assert dist.resolve() == {"coordinator_address": "10.0.0.9:29501", "num_processes": 8,
                              "process_id": 3, "source": "torch.distributed.run"}
    _set(monkeypatch, SLURM_PROCID=5, SLURM_NTASKS=16, SLURM_NODELIST="gpu-node-[07-09]",
         PTD_TPU_PORT=4000)
    assert dist.resolve() == {"coordinator_address": "gpu-node-07:4000", "num_processes": 16,
                              "process_id": 5, "source": "SLURM"}
    _set(monkeypatch, PTD_TPU_COORDINATOR="127.0.0.1:23456", PTD_TPU_NUM_PROCESSES=2,
         PTD_TPU_PROCESS_ID=1)
    assert dist.resolve() == {"coordinator_address": "127.0.0.1:23456", "num_processes": 2,
                              "process_id": 1, "source": "PTD_TPU"}
    assert dist.resolve("h:1", 4, 2) == {"coordinator_address": "h:1", "num_processes": 4,
                                         "process_id": 2, "source": "arguments"}


def test_slurm_world_of_one_still_names_a_world(monkeypatch):
    """Unlike the JAX bootstrap (which skips a 1-process SLURM job), a world
    a launcher names gets a group at size 1, so one card runs NCCL."""
    _set(monkeypatch, SLURM_PROCID=0, SLURM_NTASKS=1)
    assert dist.resolve() == {"coordinator_address": "127.0.0.1:12355", "num_processes": 1,
                              "process_id": 0, "source": "SLURM"}


@pytest.mark.parametrize("nodelist", ["", "tpu-host[01-04]", "gpu-node-01",
                                      "node[3,5-7],other1", "a1,b2", "rack2-n[010-012]"])
def test_slurm_host_parser_matches_jax(nodelist):
    assert dist._first_slurm_host(nodelist) == jax_dist._first_slurm_host(nodelist)


def test_slurm_env_matches_jax(monkeypatch):
    _set(monkeypatch, SLURM_PROCID=2, SLURM_NPROCS=6, SLURM_STEP_NODELIST="n[4-5]",
         SLURM_NODELIST="ignored[1-2]")
    assert dist._slurm_env() == jax_dist._slurm_env()


def test_backend_and_local_rank_rules(monkeypatch):
    assert dist.choose_backend("cuda", 1, 1) == "nccl"
    assert dist.choose_backend("cuda", 4, 4) == "nccl"
    assert dist.choose_backend("cuda", 2, 1) == "gloo"   # two ranks share one card
    assert dist.choose_backend("cpu", 1, 0) == "gloo"
    assert dist._local_world(2, "127.0.0.1:23456") == 2
    assert dist._local_world(8, "10.1.2.3:23456") == 1
    _set(monkeypatch, SLURM_NTASKS_PER_NODE="4(x2)")
    assert dist._local_world(8, "10.1.2.3:23456") == 4
    _set(monkeypatch, LOCAL_WORLD_SIZE=1)
    assert dist._local_world(8, "127.0.0.1:1") == 1
    assert dist.local_rank_of(5, 4) == 1 and dist.local_rank_of(1, 1) == 0
    _set(monkeypatch, LOCAL_RANK=3)
    assert dist.local_rank_of(5, 4) == 3


def test_device_follows_the_local_rank():
    assert device_for(DistContext(3, 4, None, local_rank=3), "cpu") == torch.device("cpu")


def test_world_one_gloo_group_on_the_cpu(monkeypatch):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    _set(monkeypatch, PTD_TPU_COORDINATOR=f"127.0.0.1:{port}", PTD_TPU_NUM_PROCESSES=1,
         PTD_TPU_PROCESS_ID=0)
    ctx = dist.initialize(device="cpu")
    try:
        assert (ctx.backend, ctx.process_count, ctx.is_primary) == ("gloo", 1, True)
        t = torch.ones(3)
        torch.distributed.all_reduce(t, group=ctx.group)
        assert t.tolist() == [1.0, 1.0, 1.0]
        with pytest.raises(RuntimeError, match="already exists"):
            dist.initialize(device="cpu")
    finally:
        dist.shutdown(ctx)
    assert not torch.distributed.is_initialized()


def test_cuda_world_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _set(monkeypatch, PTD_TPU_COORDINATOR="127.0.0.1:1", PTD_TPU_NUM_PROCESSES=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.initialize(device="cuda")


def test_batch_not_divisible_by_processes_raises_the_jax_error():
    cfg = parse_config(SMOKE_ARGS)
    with pytest.raises(ValueError, match="global batch 16 not divisible by 3 processes"):
        Trainer(cfg, DistContext(0, 3, None))


RECIPES = {
    "dataparallel": (dataparallel, dict(precision="fp32", csv="dataparallel.csv")),
    "distributed": (distributed, dict(precision="fp32", csv=None)),
    "multiprocessing_distributed": (multiprocessing_distributed,
                                    dict(precision="fp32", csv=None)),
    "apex_distributed": (apex_distributed, dict(precision="bf16", csv=None)),
    "horovod_distributed": (horovod_distributed,
                            dict(precision="fp32", csv=None, explicit=True, wire="bf16")),
    "distributed_slurm_main": (distributed_slurm_main,
                               dict(precision="fp32", csv="distributed.csv")),
    "tpu_native": (tpu_native, dict(precision="bf16", csv="tpu_native.csv")),
}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_trains_one_epoch_on_cpu(name, tmp_path, monkeypatch):
    mod, want = RECIPES[name]
    monkeypatch.chdir(tmp_path)
    trainer = mod.run(SMOKE_ARGS + ["--checkpoint-dir", str(tmp_path / "ckpt")])
    try:
        assert trainer.cfg.precision == want["precision"]
        assert trainer.cfg.epoch_csv == want["csv"]
        assert trainer.explicit_collectives == want.get("explicit", False)
        assert trainer.cfg.grad_compress == want.get("wire")
        assert len(trainer.losses) == 2 and len(trainer.eval_history) == 1
        assert all(torch.isfinite(torch.as_tensor(float(x))) for x in trainer.losses)
        assert (tmp_path / "ckpt" / "checkpoint.msgpack").exists()
        if want["csv"]:
            assert (tmp_path / want["csv"]).exists()
    finally:
        assert 0.0 <= finish(trainer) <= 100.0


def test_self_launching_recipe_on_the_cpu_runs_in_this_process(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    acc = multiprocessing_distributed.main(SMOKE_ARGS + ["--checkpoint-dir", str(tmp_path)])
    assert 0.0 <= acc <= 100.0 and "PTD_TPU_COORDINATOR" not in os.environ


def test_dist_file_is_accepted_and_unused(tmp_path):
    cfg = parse_config(SMOKE_ARGS + ["--dist-file", str(tmp_path / "rdzv")])
    assert cfg.dist_file == str(tmp_path / "rdzv")
    assert not (tmp_path / "rdzv").exists()


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_quantized_grad_compress_trains(wire, tmp_path, monkeypatch):
    """``--grad-compress int8|fp8`` on the explicit step (no launcher: one
    rank's local collectives), with ZeRO and bucketed overlap on top."""
    monkeypatch.chdir(tmp_path)
    for extra in ([], ["--zero", "wus", "--overlap", "bucketed", "--bucket-mb", "0.5"]):
        trainer = horovod_distributed.run(SMOKE_ARGS + ["--grad-compress", wire,
                                                        "--checkpoint-dir", str(tmp_path)]
                                          + extra)
        try:
            comm = trainer.comm
            assert comm.mode == wire and comm.explicit and len(trainer.losses) == 2
            assert comm.wus == bool(extra) and (len(comm.buckets) > 1) == bool(extra)
            assert all(torch.isfinite(x) for x in trainer.losses)
        finally:
            finish(trainer)
