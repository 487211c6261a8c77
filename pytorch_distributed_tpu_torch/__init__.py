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
  forward and backward kernels behind one autograd Function.
"""
