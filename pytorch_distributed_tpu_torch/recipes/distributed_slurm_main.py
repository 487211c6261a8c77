"""Recipe 6, multi-node training under SLURM, the port of
``pytorch_distributed_tpu/recipes/distributed_slurm_main.py``.

Reference: distributed_slurm_main.py (``srun -N2 --gres gpu:4``; rank from
``SLURM_PROCID``; ``file://<dist_file>.<SLURM_JOBID>`` rendezvous;
start.sh:5).  ``parallel/dist.py`` reads ``SLURM_PROCID``/``SLURM_NTASKS``
and the nodelist's first host (port ``PTD_TPU_PORT``, default 12355),
counting processes, not nodes; ``--dist-file`` is accepted for launch-line
parity and unused.  Only rank 0 prints and checkpoints, metrics are global.
Per-epoch CSV on by default (``distributed.csv``, the reference's name).

At many ranks ``--zero wus`` (``parallel/zero.py``) matters most: the
optimizer state shards 1/N over every rank while checkpoints keep the
replicated param-shaped layout, so a run at one world restores a
checkpoint of another.

    SLURM_PROCID=0 SLURM_NTASKS=1 \\
        python -m pytorch_distributed_tpu_torch.recipes.distributed_slurm_main \\
        -a resnet50 --synthetic --fused-convbn -b 256 --epochs 1
"""

from pytorch_distributed_tpu_torch.recipes._common import finish, run_recipe


def run(argv=None):
    """Train as the recipe does; returns the trainer (its group still up)."""
    return run_recipe(
        "ImageNet Training on CUDA (multi-node SLURM)",
        argv,
        epoch_csv_default="distributed.csv",
    )


def main(argv=None):
    """Train as ``run`` does; returns the best top-1."""
    return finish(run(argv))


if __name__ == "__main__":
    main()
