"""Recipe 5, explicit-collective data parallelism with a compressed gradient
wire, the port of ``pytorch_distributed_tpu/recipes/horovod_distributed.py``.

Reference: horovod_distributed.py (``hvd.init``; ``hvd.DistributedOptimizer``
ring all-reduce with ``Compression.fp16``; ``hvd.broadcast_parameters``;
start.sh:4).  The JAX recipe writes the collectives by hand
(``local_step`` under ``shard_map``), and so does the port's explicit step:
per-rank BatchNorm as in the GPU original, each rank's local weighted
gradient sums cast to bf16 (``--grad-compress bf16``, the default), summed
over the ranks on the wire and divided in f32 by the global weight count,
the BN running statistics averaged after the step.  That is not DDP's
``bf16_compress_hook``, which divides by the world size before the cast.
Launched with ``PTD_TPU_*`` (or any launcher ``distributed`` takes).

``--zero wus`` upgrades this explicit step to weight-update sharding
(``parallel/zero.py``): the gradient all-reduce becomes a hand-written
reduce-scatter, the momentum lives as this rank's 1/N chunks, and the
parameter delta is all-gathered once a step on the recipe's bf16 wire; it
composes with ``--grad-compress int8``, which puts *both* hops on the
quantized path with error feedback (``ops/qcomm.py``).

    PTD_TPU_COORDINATOR=127.0.0.1:29400 PTD_TPU_NUM_PROCESSES=1 PTD_TPU_PROCESS_ID=0 \\
        python -m pytorch_distributed_tpu_torch.recipes.horovod_distributed -a resnet50 \\
        --synthetic --fused-convbn -b 256 --epochs 1
"""

from pytorch_distributed_tpu_torch.recipes._common import finish, run_recipe


def run(argv=None):
    """Train as the recipe does; returns the trainer (its group still up)."""
    return run_recipe(
        "ImageNet Training on CUDA (explicit collectives + compressed wire grads)",
        argv,
        explicit_collectives=True,
        grad_compress_default="bf16",
    )


def main(argv=None):
    """Train as ``run`` does; returns the best top-1."""
    return finish(run(argv))


if __name__ == "__main__":
    main()
