"""The canonical image recipe, the port of ``pytorch_distributed_tpu/recipes/tpu_native.py``:
bf16 compute with f32 weights, exact masked evaluation, batches prefetched
to the card, the epoch CSV (default ``tpu_native.csv``); under a launcher
(``torch.distributed.run``, ``PTD_TPU_*`` or SLURM) one process per card
with global-batch BatchNorm.

``--zero wus`` (``parallel/zero.py``) keeps 1/N of the momentum per rank
(all of it without a group, the same numbers); checkpoints stay
interchangeable with every other recipe (gather-on-save).

    python -m pytorch_distributed_tpu_torch.recipes.tpu_native -a resnet50 \\
        --synthetic --fused-convbn -b 256 --epochs 1
    python -m pytorch_distributed_tpu_torch.recipes.tpu_native --device cpu \\
        -a resnet18 --synthetic --image-size 32 -b 8 --synthetic-length 32 --epochs 1
    python -m pytorch_distributed_tpu_torch.recipes.tpu_native --data DIR -a resnet50 \\
        --fused-convbn -b 256 --wire u8 --worker-type process

``--data DIR`` trains on an ImageFolder tree (``DIR/train``, ``DIR/val``)
through ``--wire f32|u8host|u8|native`` (``native`` needs the C++ data
plane built against a libjpeg.so.62: the system's or the Pillow wheel's).

``--fused-convbn`` runs the stride-1 conv -> BN backward through the
hand-written kernels K4 (1x1) and K5 (3x3).
"""

from pytorch_distributed_tpu_torch.recipes._common import finish, run_recipe


def run(argv=None):
    """Train as the recipe does; returns the trainer (its group still up)."""
    return run_recipe("ImageNet Training on CUDA (canonical recipe)", argv,
                      precision_default="bf16", epoch_csv_default="tpu_native.csv")


def main(argv=None) -> float:
    """Train as ``run`` does; returns the best top-1."""
    return finish(run(argv))


if __name__ == "__main__":
    main()
