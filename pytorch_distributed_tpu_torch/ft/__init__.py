"""Fault tolerance of the PyTorch port (mirrors pytorch_distributed_tpu/ft).

Ported: ``integrity.py`` (the checkpoint sidecars, atomic writes and I/O
retries of ``train/checkpoint.py``), ``chaos.py`` (the deterministic fault
injectors and their ``chaos=`` hooks in both trainers and the serving
engine, with ``utils/preempt.py``'s SIGTERM guard) and ``elastic.py``
(membership epochs, the file-based coordinator the fleet arbiter drives,
the rescale rules and the exact re-grids).  The divergence rollback policy,
the trainers' ``--elastic`` re-mesh and the rest of ``scripts/chaoskit.py``
wait for ROADMAP.md item A11.

This ``__init__`` imports nothing, so ``elastic.py`` and ``chaos.py`` load
without torch.
"""
