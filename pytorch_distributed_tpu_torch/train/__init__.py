"""train of the PyTorch port (mirrors pytorch_distributed_tpu/train)."""
