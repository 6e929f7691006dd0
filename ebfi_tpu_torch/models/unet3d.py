"""UNet3d18: the detail-restoration branch, standard path (port of
``ebfi_tpu/models/unet3d.py`` with fast_tail=False).

An R3D-18 encoder without batch norm and a transposed-conv decoder with
squeeze-excite gates over the frame pair (T = 2).  The JAX package packs
the two time steps into channels for the TPU; here they are the depth axis
of native Conv3d/ConvTranspose3d on (B, C, T, H, W), the same math.
Under spatial parallelism (inside a band scope) every conv takes its halo
rows (the stem 3, the 3x3x3 convs 1, the transposed convs 1 input row
each side, then a crop), the squeeze-excite means are the whole image's,
and the output conv's reflect padding takes 3 halo rows, reflecting only
at the image's own edges.  Band heights are multiples of 8, so that the
three stride-2 levels keep every band on an even row.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import SEGating, conv3d, conv_transpose3d, nhwc, reflect_conv2d


class _BasicBlock3D(nn.Module):
    """R3D BasicBlock with SE gating, no batch norm."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        st = (1, stride, stride)
        self.conv1 = nn.Conv3d(in_ch, planes, 3, st, 1, bias=False)
        self.conv2 = nn.Conv3d(planes, planes, 3, 1, 1, bias=False)
        self.fg = SEGating(planes)
        self.downsample = nn.Conv3d(in_ch, planes, 1, st, 0, bias=False) if downsample else None

    def forward(self, x):
        out = self.fg(conv3d(self.conv2, F.relu(conv3d(self.conv1, x))))
        res = conv3d(self.downsample, x) if self.downsample is not None else x
        return F.relu(out + res)


class _Encoder3D(nn.Module):
    """r3d_18 stem + 4 layers of 2 BasicBlocks."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        c0, c1, c2, c3 = channels
        self.stem = nn.Conv3d(3, c0, (3, 7, 7), (1, 2, 2), (1, 3, 3), bias=False)
        self.layer1_0 = _BasicBlock3D(c0, c0)
        self.layer1_1 = _BasicBlock3D(c0, c0)
        self.layer2_0 = _BasicBlock3D(c0, c1, 2, downsample=True)
        self.layer2_1 = _BasicBlock3D(c1, c1)
        self.layer3_0 = _BasicBlock3D(c1, c2, 2, downsample=True)
        self.layer3_1 = _BasicBlock3D(c2, c2)
        self.layer4_0 = _BasicBlock3D(c2, c3, 1, downsample=True)
        self.layer4_1 = _BasicBlock3D(c3, c3)

    def forward(self, x):
        x0 = F.relu(conv3d(self.stem, x))
        x1 = self.layer1_1(self.layer1_0(x0))
        x2 = self.layer2_1(self.layer2_0(x1))
        x3 = self.layer3_1(self.layer3_0(x2))
        x4 = self.layer4_1(self.layer4_0(x3))
        return x0, x1, x2, x3, x4


class _ConvSE(nn.Module):
    """3x3x3 conv + SE gate."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv3d(in_ch, out_ch, 3, 1, 1)
        self.fg = SEGating(out_ch)

    def forward(self, x):
        return self.fg(conv3d(self.conv, x))


class _UpConvSE(nn.Module):
    """(3, 4, 4) transposed conv, spatial stride 2, + SE gate."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.upconv = nn.ConvTranspose3d(in_ch, out_ch, (3, 4, 4), (1, 2, 2), (1, 1, 1))
        self.fg = SEGating(out_ch)

    def forward(self, x):
        return self.fg(conv_transpose3d(self.upconv, x))


class UNet3d18(nn.Module):
    def __init__(self, channels: Sequence[int] = (32, 64, 96, 128)):
        super().__init__()
        c0, c1, c2, c3 = channels
        self.encoder = _Encoder3D(channels)
        self.dec0 = _ConvSE(c3, c2)
        self.dec1 = _UpConvSE(2 * c2, c1)
        self.dec2 = _UpConvSE(2 * c1, c0)
        self.dec3 = _ConvSE(2 * c0, c0)
        self.dec4 = _UpConvSE(2 * c0, c0)
        self.feature_fuse = nn.Conv2d(2 * c0, c0, 1, bias=False)
        self.outconv = nn.Conv2d(c0, 3, 7)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """img0, img1 (B, H, W, 3) with H, W divisible by 8 -> (B, H, W, 3)."""
        lrelu = lambda v: F.leaky_relu(v, 0.2)
        # (B, T, H, W, 3) memory viewed as (B, 3, T, H, W): channels-last 3D
        x = torch.stack([img0, img1], dim=1).permute(0, 4, 1, 2, 3)
        x0, x1, x2, x3, x4 = self.encoder(x)
        d = torch.cat([lrelu(self.dec0(x4)), x3], dim=1)
        d = torch.cat([lrelu(self.dec1(d)), x2], dim=1)
        d = torch.cat([lrelu(self.dec2(d)), x1], dim=1)
        d = torch.cat([lrelu(self.dec3(d)), x0], dim=1)
        dout = lrelu(self.dec4(d))
        # [t0 channels | t1 channels], the reference's unbind-then-concat
        fused = lrelu(self.feature_fuse(torch.cat(torch.unbind(dout, dim=2), dim=1)))
        return nhwc(reflect_conv2d(self.outconv, fused))
