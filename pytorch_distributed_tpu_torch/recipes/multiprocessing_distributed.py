"""Recipe 3, self-contained multi-process data parallelism (no external
launcher), the port of ``pytorch_distributed_tpu/recipes/multiprocessing_distributed.py``.

Reference: multiprocessing_distributed.py (``mp.spawn(main_worker, nprocs)``
inside the script, explicit ``tcp://127.0.0.1:23456`` rendezvous,
multiprocessing_distributed.py:114,132-135; start.sh:1).  Plain
``python -m``: one worker per visible card on 127.0.0.1:23456
(``launch_per_card``); with ``PTD_TPU_NUM_PROCESSES`` set, this process is
one worker of a world launched outside (the coordinator still defaults to
127.0.0.1:23456), which lets several ranks share one card over gloo.

Accepts ``--zero wus`` like every recipe (``parallel/zero.py``
weight-update sharding; the Trainer threads it from the shared Config).

    python -m pytorch_distributed_tpu_torch.recipes.multiprocessing_distributed \\
        -a resnet50 --synthetic --fused-convbn -b 256 --epochs 1
"""

from pytorch_distributed_tpu_torch.recipes._common import finish, launch_per_card, run_recipe


def run(argv=None):
    """Train as the recipe does; returns the trainer (its group still up)."""
    return run_recipe(
        "ImageNet Training on CUDA (self-contained multi-process DP)",
        argv,
    )


def main(argv=None):
    """One worker per visible card (see the module docstring); returns the
    best top-1 of the worker that ran in this process, if any."""
    return launch_per_card(_worker, argv)


def _worker(argv=None) -> float:
    return finish(run(argv))


if __name__ == "__main__":
    main()
