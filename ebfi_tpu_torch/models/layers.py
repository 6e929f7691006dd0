"""Shared building blocks: activations and the NHWC conv layer.

Port of ``ebfi_tpu/models/layers.py``.  Modules take and return NHWC
tensors (the JAX package's layout); inside, a conv runs on the NCHW view
of the same memory (channels-last strides), which cuDNN takes as is.

Under spatial parallelism (inside :func:`~ebfi_tpu_torch.parallel.band_scope`)
the row-coupled ops here run on the band of rows: the convs take their
halo rows from the neighbouring bands and pad H only at the image's own
edges, a stride-2 conv relies on every band starting on an even row (the
bands are aligned to 8 rows), and instance norm, GroupNorm and the
squeeze-excite mean take their statistics over the whole image.  BN uses
its running statistics, as the JAX module does, and stays local.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import band_mean, current_band, halo_rows, model_sum


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
    """2D conv of an NHWC tensor with an OIHW weight, NHWC out; on a band,
    with its halo rows."""
    if current_band() is None:
        return nhwc(F.conv2d(nchw(x), weight, bias, stride=stride, padding=padding))
    x = halo_rows(x, 1, padding, weight.shape[2] - 1 - padding)
    return nhwc(F.conv2d(nchw(x), weight, bias, stride=stride, padding=(0, padding)))


def conv3d(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` on (B, C, T, H, W); on a band, with its halo rows."""
    if current_band() is None:
        return conv(x)
    pt, ph, pw = conv.padding
    x = halo_rows(x, 3, ph, conv.kernel_size[1] - 1 - ph)
    return F.conv3d(x, conv.weight, conv.bias, conv.stride, (pt, 0, pw))


def conv_transpose3d(conv: nn.ConvTranspose3d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` on (B, C, T, H, W); on a band, from the input band with
    one halo row each side, cropped to the band's output rows (an output
    row draws on the input rows within (kh - 1) / s of its own: 1 here)."""
    if current_band() is None:
        return conv(x)
    (pt, ph, pw), kh, s = conv.padding, conv.kernel_size[1], conv.stride[1]
    halo = -(-(kh - 1 - ph) // s)  # ceil: the input rows the band's outputs reach past its own
    y = F.conv_transpose3d(halo_rows(x, 3, halo, halo), conv.weight, conv.bias, conv.stride,
                           (pt, 0, pw))
    return y.narrow(3, s * halo + ph, s * x.shape[3])


def reflect_conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on (B, C, H, W) reflect-padded by half its kernel (torch's
    "reflect", REFLECT_101); on a band, the rows come from the neighbours
    and reflect only at the image's own edges."""
    p = conv.kernel_size[0] // 2
    if current_band() is None:
        return conv(F.pad(x, (p, p, p, p), mode="reflect"))
    return conv(F.pad(halo_rows(x, 2, p, p, "reflect"), (p, p, 0, 0), mode="reflect"))


def group_norm_nhwc(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm`` on an NHWC tensor; on a band, with the mean and then the
    variance of each group over the whole image (sums in f32 over the
    model group)."""
    if current_band() is None:
        return nhwc(norm(nchw(x)))
    B, H, W, C = x.shape
    G = norm.num_groups
    xg = x.float().reshape(B, H, W, G, C // G)
    count = H * W * (C // G) * current_band().model
    mean = model_sum(xg.sum(dim=(1, 2, 4), keepdim=True)) / count
    d = xg - mean
    var = model_sum((d * d).sum(dim=(1, 2, 4), keepdim=True)) / count
    y = (d * torch.rsqrt(var + norm.eps)).reshape(B, H, W, C)
    return (y * norm.weight.float() + norm.bias.float()).to(x.dtype)


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
            y = group_norm_nhwc(self.norm, y)
        return self.act(y) if self.act is not None else y


class SEGating(nn.Module):
    """Squeeze-excite gate of the 3D detail branch on (B, C, T, H, W):
    mean over (T, H, W) -> 1x1x1 conv -> sigmoid -> scale (the mean over
    the whole image on a band)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv3d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = band_mean(x, (2, 3, 4), keepdim=True)
        return x * torch.sigmoid(self.conv(pooled))
