"""Shared building blocks: activations and the NHWC conv layer.

Port of ``ebfi_tpu/models/layers.py``.  Modules take and return NHWC
tensors (the JAX package's layout); inside, a conv runs on the NCHW view
of the same memory (channels-last strides), which cuDNN takes as is.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def activation_fn(name: Optional[str]) -> Optional[Callable]:
    """Activations by their reference names."""
    if name is None:
        return None
    table = {
        "ReLU": F.relu,
        "LeakyReLU": lambda x: F.leaky_relu(x, 0.01),
        "Sigmoid": torch.sigmoid,
        "Tanh": torch.tanh,
    }
    if name not in table:
        raise ValueError(f"Unknown activation {name!r}")
    return table[name]


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d_nhwc(x, weight, bias=None, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """2D conv of an NHWC tensor with an OIHW weight, NHWC out."""
    return nhwc(F.conv2d(nchw(x), weight, bias, stride=stride, padding=padding))


class ConvLayer(nn.Module):
    """Conv2d + activation on NHWC (the reference's ConvLayer with
    norm=None, the only norm the shipped model uses)."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 0,
        activation: Optional[str] = "ReLU",
        norm: Optional[str] = None,
    ):
        super().__init__()
        if norm is not None:
            raise NotImplementedError("the port's ConvLayer supports norm=None")
        self.stride, self.padding = stride, padding
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride, padding)
        self.act = activation_fn(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_nhwc(x, self.conv.weight, self.conv.bias, self.stride, self.padding)
        return self.act(y) if self.act is not None else y


class SEGating(nn.Module):
    """Squeeze-excite gate of the 3D detail branch on (B, C, T, H, W):
    mean over (T, H, W) -> 1x1x1 conv -> sigmoid -> scale."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv3d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = x.mean(dim=(2, 3, 4), keepdim=True)
        return x * torch.sigmoid(self.conv(pooled))
