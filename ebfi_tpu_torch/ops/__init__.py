"""Ops of the port: image ops, the plain FAC, and the kernel router.

Port of ``ebfi_tpu/ops``.  :func:`kernel_conv2d_auto` is the FAC with the
framework's tap-major bank: kernel B1 for a CUDA tensor, the plain version
for a CPU tensor.
"""
from .image_ops import (
    dark_channel,
    laplacian_response,
    pad_amounts_to_multiple,
    pixel_shuffle,
)
from .kernel_conv2d import kernel_conv2d, kernel_conv2d_raw
from .cuda.fac import kernel_conv2d_cuda as kernel_conv2d_auto

__all__ = [
    "dark_channel",
    "laplacian_response",
    "pad_amounts_to_multiple",
    "pixel_shuffle",
    "kernel_conv2d",
    "kernel_conv2d_raw",
    "kernel_conv2d_auto",
]
