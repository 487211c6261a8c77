"""Fault tolerance of the PyTorch port (mirrors pytorch_distributed_tpu/ft).

Only ``integrity.py`` is ported so far (the checkpoint sidecars, atomic
writes and I/O retries of ``train/checkpoint.py``); the divergence policy,
chaos injectors and elastic membership wait for ROADMAP.md item A11.
"""
