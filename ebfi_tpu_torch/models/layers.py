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


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of an NHWC tensor: ``train`` normalises with the batch's statistics and
    moves the running ones by 0.1 toward them (torch's momentum 0.1), with
    the biased batch variance as flax does (``F.batch_norm`` would move
    them toward the unbiased one); otherwise the running statistics."""

    EPS, MOMENTUM = 1e-5, 0.1

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            dims = tuple(range(x.ndim - 1))
            var, mean = torch.var_mean(x, dim=dims, correction=0)
            with torch.no_grad():
                self.running_mean.lerp_(mean.float(), self.MOMENTUM)
                self.running_var.lerp_(var.float(), self.MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.EPS) * self.weight + self.bias


class ConvLayer(nn.Module):
    """Conv2d + optional norm + activation on NHWC (the reference's
    ConvLayer, submodules.py:159-201).  ``norm``: None, "BN" (the conv has
    no bias; :class:`BatchNorm`) or "IN" (flax ``GroupNorm(group_size=1)``,
    a learnable scale and bias per channel: ``nn.GroupNorm(C, C)``)."""

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
        if norm not in (None, "BN", "IN"):
            raise ValueError(f"norm must be None, 'BN' or 'IN', got {norm!r}")
        self.stride, self.padding = stride, padding
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride, padding, bias=norm != "BN")
        if norm == "BN":
            self.norm = BatchNorm(out_ch)
        elif norm == "IN":
            self.norm = nn.GroupNorm(out_ch, out_ch, eps=1e-5)
        self.norm_kind = norm
        self.act = activation_fn(activation)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = conv2d_nhwc(x, self.conv.weight, self.conv.bias, self.stride, self.padding)
        if self.norm_kind == "BN":
            y = self.norm(y, train)
        elif self.norm_kind == "IN":
            y = nhwc(self.norm(nchw(y)))
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
