"""Recipe 1, single-process data parallelism, the port of
``pytorch_distributed_tpu/recipes/dataparallel.py``.

Reference: dataparallel.py (``nn.DataParallel(model, device_ids,
output_device)``, dataparallel.py:118-119,138; launched as plain ``python
main.py``, README.md:86).  The JAX recipe drives every local chip from one
process with one program over a ``data`` mesh.  Under PyTorch one process
drives one card, so the port launches itself: one worker per visible card
(``launch_per_card``, the reference's ``mp.spawn`` shape), each in DDP with
global-batch BatchNorm, which keeps the JAX recipe's numbers (one card: one
worker, in this process, over NCCL at world size 1).  The per-epoch CSV
(dataparallel.py:188,205-213) is on by default, same file name.

``--zero wus`` lifts the replicated-optimizer ceiling (``parallel/zero.py``):
this GSPMD-twin step reduce-scatters the gradients in place of DDP's
all-reduce, updates this rank's 1/N of the momentum and all-gathers the
result, with the replicated step's numbers.

    python -m pytorch_distributed_tpu_torch.recipes.dataparallel -a resnet50 \\
        --synthetic --fused-convbn -b 256 --epochs 1
"""

from pytorch_distributed_tpu_torch.recipes._common import finish, launch_per_card, run_recipe


def run(argv=None):
    """Train as the recipe does; returns the trainer (its group still up)."""
    return run_recipe(
        "ImageNet Training on CUDA (single-process data parallel)",
        argv,
        epoch_csv_default="dataparallel.csv",
    )


def main(argv=None):
    """One worker per visible card (see the module docstring); returns the
    best top-1 of the worker that ran in this process, if any."""
    return launch_per_card(_worker, argv)


def _worker(argv=None) -> float:
    return finish(run(argv))


if __name__ == "__main__":
    main()
