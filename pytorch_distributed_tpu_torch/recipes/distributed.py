"""Recipe 2, multi-process data parallelism with an external launcher, the
port of ``pytorch_distributed_tpu/recipes/distributed.py``.

Reference: distributed.py (``torch.distributed.launch --nproc_per_node=4``
sets the environment and ``--local_rank``; ``dist.init_process_group('nccl')``,
distributed.py:73-76,132; start.sh:2).  The launcher's environment
(``torch.distributed.run``'s ``RANK``/``WORLD_SIZE``/``MASTER_*``/
``LOCAL_RANK``, or ``PTD_TPU_*``) names the world; the step is the JAX
GSPMD step's twin: DDP, global-batch BatchNorm, summed gradients.

``--zero wus`` shards the optimizer state 1/N over the ranks
(``parallel/zero.py``; ZeRO-1, what torch's ZeroRedundancyOptimizer gives
DDP users): a reduce-scatter replaces DDP's all-reduce, the SGD runs on
this rank's chunk, the new weights are all-gathered.

    python -m torch.distributed.run --nproc_per_node=1 \\
        -m pytorch_distributed_tpu_torch.recipes.distributed -a resnet50 \\
        --synthetic --fused-convbn -b 256 --epochs 1
"""

from pytorch_distributed_tpu_torch.recipes._common import finish, run_recipe


def run(argv=None):
    """Train as the recipe does; returns the trainer (its group still up)."""
    return run_recipe(
        "ImageNet Training on CUDA (multi-process DP, external launcher)",
        argv,
    )


def main(argv=None):
    """Train as ``run`` does; returns the best top-1."""
    return finish(run(argv))


if __name__ == "__main__":
    main()
