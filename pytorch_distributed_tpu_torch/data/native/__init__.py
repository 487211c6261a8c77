"""Native (C++) host data plane of the port: see ptd_data.cpp / binding.py."""

from pytorch_distributed_tpu_torch.data.native.binding import (
    decode_crop_resize_batch,
    decode_jpeg,
    decode_webp_rgba,
    gif_lzw,
    jpeg_native_available,
    native_available,
    normalize_batch,
    png_unfilter,
    resize_bilinear,
    resolve_libraries,
    webp_info,
)

__all__ = [
    "decode_crop_resize_batch",
    "decode_jpeg",
    "decode_webp_rgba",
    "gif_lzw",
    "jpeg_native_available",
    "native_available",
    "normalize_batch",
    "png_unfilter",
    "resize_bilinear",
    "resolve_libraries",
    "webp_info",
]
