"""Native (C++) host data plane of the port: see ptd_data.cpp / binding.py."""

from pytorch_distributed_tpu_torch.data.native.binding import (
    decode_crop_resize_batch,
    decode_jpeg,
    jpeg_native_available,
    native_available,
    normalize_batch,
    png_unfilter,
    resize_bilinear,
)

__all__ = [
    "decode_crop_resize_batch",
    "decode_jpeg",
    "jpeg_native_available",
    "native_available",
    "normalize_batch",
    "png_unfilter",
    "resize_bilinear",
]
