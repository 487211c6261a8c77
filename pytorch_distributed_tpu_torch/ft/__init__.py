"""Fault tolerance of the PyTorch port (mirrors pytorch_distributed_tpu/ft).

Ported: ``integrity.py`` (the checkpoint sidecars, atomic writes and I/O
retries of ``train/checkpoint.py``) and ``chaos.py`` (the deterministic
fault injectors and their ``chaos=`` hooks in both trainers, with
``utils/preempt.py``'s SIGTERM guard).  The divergence rollback policy,
elastic membership, ``scripts/chaoskit.py`` and the serving engine's
``chaos`` hook wait for ROADMAP.md item A11.
"""
