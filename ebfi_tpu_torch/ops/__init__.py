"""Ops of the port: image ops, the plain FAC and its kernel router, the
flow losses' warping, and the device event encoders.

Port of ``ebfi_tpu/ops``.  :func:`kernel_conv2d_auto` is the FAC with the
framework's tap-major bank: kernel B1 for a CUDA tensor, the plain version
for a CPU tensor.
"""
from .event_encoding import (
    events_polarity_mask,
    events_to_channels,
    events_to_mask,
    events_to_stack,
    events_to_voxel,
    get_hot_event_mask,
)
from .image_ops import (
    dark_channel,
    laplacian_response,
    pad_amounts_to_multiple,
    pixel_shuffle,
)
from .kernel_conv2d import kernel_conv2d, kernel_conv2d_raw
from .cuda.fac import kernel_conv2d_cuda as kernel_conv2d_auto
from .warp import grid_sample, sobel_gradients

__all__ = [
    "dark_channel",
    "laplacian_response",
    "pad_amounts_to_multiple",
    "pixel_shuffle",
    "kernel_conv2d",
    "kernel_conv2d_raw",
    "kernel_conv2d_auto",
    "grid_sample",
    "sobel_gradients",
    "events_to_stack",
    "events_to_channels",
    "events_to_mask",
    "events_polarity_mask",
    "get_hot_event_mask",
    "events_to_voxel",
]
