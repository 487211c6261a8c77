"""Recipe 4, mixed-precision data parallelism (the apex/AMP slot), the port
of ``pytorch_distributed_tpu/recipes/apex_distributed.py``.

Reference: apex_distributed.py (``amp.initialize`` O1 cast-patching,
dynamic loss scaling, apex DDP, the CUDA-stream ``data_prefetcher``;
start.sh:3).  The JAX recipe reduces AMP to the bf16 compute policy with no
loss scaling, since bf16 keeps f32's exponent range, and so does the port:
f32 master weights, bf16 convs, f32 BatchNorm statistics and loss, no
``GradScaler``; ``DeviceFeeder`` is the prefetcher.  Launched like
``distributed``.

``--zero wus`` additionally shards the f32 optimizer state 1/N over the
ranks (``parallel/zero.py``): under bf16 compute the f32 momentum masters
are exactly the bytes worth sharding first.

    python -m torch.distributed.run --nproc_per_node=1 \\
        -m pytorch_distributed_tpu_torch.recipes.apex_distributed -a resnet50 \\
        --synthetic --fused-convbn -b 256 --epochs 1
"""

from pytorch_distributed_tpu_torch.recipes._common import finish, run_recipe


def run(argv=None):
    """Train as the recipe does; returns the trainer (its group still up)."""
    return run_recipe(
        "ImageNet Training on CUDA (bf16 mixed precision DP)",
        argv,
        precision_default="bf16",
    )


def main(argv=None):
    """Train as ``run`` does; returns the best top-1."""
    return finish(run(argv))


if __name__ == "__main__":
    main()
