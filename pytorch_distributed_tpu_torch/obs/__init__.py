"""Observability of the PyTorch port (mirrors pytorch_distributed_tpu/obs).

Only ``metrics.py`` is ported so far; the rest waits for ROADMAP.md item
A12.
"""
