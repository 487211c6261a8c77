"""PyTorch and CUDA port of ``pytorch_distributed_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; each module here mirrors
the file of the same path there, and each Pallas kernel on a ported path is
a hand-written Hopper kernel under ``csrc/``.  This package imports torch and
never JAX, flax or the JAX package.

Ported so far:

- KV-cached LM serving (``recipes/lm_generate.py`` → ``models/generate.py``
  → ``models/transformer.py``) with the flash-attention forward kernel for
  prompt prefill;
- single-device LM pretraining (``recipes/lm_pretrain.py`` →
  ``train/lm.py`` → ``models/transformer.py``) with the flash-attention
  forward and backward kernels behind one autograd Function;
- single-device ResNet training (``recipes/tpu_native.py`` →
  ``train/trainer.py`` → ``train/steps.py`` → ``models/resnet.py``) on
  synthetic data or an ImageFolder tree (``data/``: decoding without PIL,
  the transforms, the uint8 wire modes, the C++ data plane and worker
  processes); under ``--fused-convbn`` the stride-1 conv → BatchNorm
  backward runs through the fused kernels K4 (1x1) and K5 (3x3) of
  ``ops/fused_conv_bn.py``.
"""
