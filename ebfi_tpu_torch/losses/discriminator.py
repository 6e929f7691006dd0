"""Discriminators of the adversarial loss (port of
``ebfi_tpu/losses/discriminator.py``).

The shared ladder: a 3x3 conv block, then ``depth`` blocks that halve the
resolution on even layers (stride 2) and double the channels on odd ones,
each conv bias-free, batch-normalised and leaky-ReLU'd (0.2); a classifier
head of two linear layers.  Variants:

- ``Discriminator``: one frame (``bn`` off for WGAN_GP);
- ``TemporalDiscriminator``: a pair of (2, 3, 3) 3D convs over (prev, x,
  next), T 3 -> 1, then a ladder without BN;
- ``FIDiscriminator``: a frame pair concatenated on channels;
- ``FICondDiscriminator``: the 3D pair with 8 channels, a ladder of base 8;
- ``STDiscriminator``: a spatial ladder on the frame and a temporal one on
  (x - prev, x - next), both base 8, flattened and concatenated.

Batch norm uses the batch's statistics (mean and biased variance over
B, H, W), with no running statistics, as the JAX package's.  With
``sync`` the statistics are those of the global batch of a data-parallel
group (``group``: the world for None; under spatial parallelism the data
axis): each rank's sums pass through an all-reduce that autograd
differentiates (:func:`~ebfi_tpu_torch.parallel.all_reduce_sum`), which
is what the JAX step computes on its batch sharded over ``data``.

Tensors are NHWC, convs run on their channels-last NCHW view, and the
ladder's output is flattened in NHWC order, as flax flattens it, so the
first linear layer's weight is the flax kernel transposed.  The linear
layer's in-features follow from the input's H and W, which
:func:`build_discriminator` takes (flax reads them at ``init``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import conv2d_nhwc
from ..parallel import all_reduce_sum

LADDER_DEPTH = 7
BN_EPS = 1e-5


def batch_stat_norm(x: torch.Tensor, sync: bool = False, eps: float = BN_EPS,
                    group=None) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) per channel over (B, H, W) of an NHWC
    tensor; with ``sync`` over the batch of every rank of ``group`` (the
    world for None), each holding as many items."""
    n = x.shape[0] * x.shape[1] * x.shape[2]
    if sync and torch.distributed.is_initialized():
        n *= torch.distributed.get_world_size(group)
        mean = all_reduce_sum(x.sum(dim=(0, 1, 2), keepdim=True), group) / n
        centered = x - mean
        var = all_reduce_sum((centered * centered).sum(dim=(0, 1, 2), keepdim=True), group) / n
    else:
        mean = x.sum(dim=(0, 1, 2), keepdim=True) / n
        centered = x - mean
        var = (centered * centered).sum(dim=(0, 1, 2), keepdim=True) / n
    return centered / torch.sqrt(var + eps)


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, bn: bool = True,
                 sync: bool = False, group=None):
        super().__init__()
        self.stride, self.bn, self.sync, self.group = stride, bn, sync, group
        self.conv = nn.Conv2d(in_ch, out_ch, 3, stride, 1, bias=False)
        if bn:
            self.scale = nn.Parameter(torch.ones(out_ch))
            self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x):
        y = conv2d_nhwc(x, self.conv.weight, None, self.stride, 1)
        if self.bn:
            y = batch_stat_norm(y, self.sync, group=self.group) * self.scale + self.bias
        return F.leaky_relu(y, 0.2)


class ConvLadder(nn.Module):
    def __init__(self, in_ch: int, base: int = 64, depth: int = LADDER_DEPTH, bn: bool = True,
                 sync: bool = False, group=None):
        super().__init__()
        out_ch = base
        blocks = [BasicBlock(in_ch, out_ch, bn=bn, sync=sync, group=group)]
        for i in range(depth):
            cin = out_ch
            if i % 2 == 1:
                stride, out_ch = 1, out_ch * 2
            else:
                stride = 2
            blocks.append(BasicBlock(cin, out_ch, stride, bn=bn, sync=sync, group=group))
        for i, b in enumerate(blocks):
            self.add_module(f"block{i}", b)
        self.out_ch = out_ch
        self.strides = sum(1 for i in range(depth) if i % 2 == 0)

    def forward(self, x):
        for b in self.children():
            x = b(x)
        return x

    def out_features(self, hw: Tuple[int, int]) -> int:
        """Flattened size of the output for an (H, W) input: each stride-2
        layer (padding 1) takes ceil(H / 2)."""
        h, w = hw
        for _ in range(self.strides):
            h, w = (h + 1) // 2, (w + 1) // 2
        return h * w * self.out_ch


class Classifier(nn.Module):
    def __init__(self, in_features: int):
        super().__init__()
        self.dense0 = nn.Linear(in_features, 1024)
        self.dense1 = nn.Linear(1024, 1)

    def forward(self, flat):
        return self.dense1(F.leaky_relu(self.dense0(flat), 0.2))


def _flat(f: torch.Tensor) -> torch.Tensor:
    return f.reshape(f.shape[0], -1)


class Conv3DPair(nn.Module):
    """Two (2, 3, 3) convs, padding (0, 1, 1), collapsing T = 3 -> 1."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.c0 = nn.Conv3d(in_ch, features, (2, 3, 3), padding=(0, 1, 1))
        self.c1 = nn.Conv3d(features, features, (2, 3, 3), padding=(0, 1, 1))

    def forward(self, x):  # (B, T=3, H, W, C) -> (B, H, W, C)
        y = self.c1(self.c0(x.permute(0, 4, 1, 2, 3)))
        return y[:, :, 0].permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    def __init__(self, hw: Tuple[int, int], gan_type: str = "GAN", sync: bool = False,
                 group=None):
        super().__init__()
        self.features = ConvLadder(3, bn=gan_type != "WGAN_GP", sync=sync, group=group)
        self.classifier = Classifier(self.features.out_features(hw))

    def forward(self, x):
        return self.classifier(_flat(self.features(x)))


class TemporalDiscriminator(nn.Module):
    def __init__(self, hw: Tuple[int, int], sync: bool = False, group=None):
        super().__init__()
        self.feature_3d = Conv3DPair(3, 64)
        self.features = ConvLadder(64, bn=False, sync=sync, group=group)
        self.classifier = Classifier(self.features.out_features(hw))

    def forward(self, f0, f1, f2):
        x = self.feature_3d(torch.stack([f0, f1, f2], dim=1))
        return self.classifier(_flat(self.features(x)))


class FIDiscriminator(nn.Module):
    def __init__(self, hw: Tuple[int, int], sync: bool = False, group=None):
        super().__init__()
        self.features = ConvLadder(6, sync=sync, group=group)
        self.classifier = Classifier(self.features.out_features(hw))

    def forward(self, f0, f1):
        return self.classifier(_flat(self.features(torch.cat([f0, f1], dim=-1))))


class FICondDiscriminator(nn.Module):
    def __init__(self, hw: Tuple[int, int], sync: bool = False, group=None):
        super().__init__()
        self.feature_3d = Conv3DPair(3, 8)
        self.features = ConvLadder(8, base=8, sync=sync, group=group)
        self.classifier = Classifier(self.features.out_features(hw))

    def forward(self, f0, f1, f2):
        x = self.feature_3d(torch.stack([f0, f1, f2], dim=1))
        return self.classifier(_flat(self.features(x)))


class STDiscriminator(nn.Module):
    def __init__(self, hw: Tuple[int, int], sync: bool = False, group=None):
        super().__init__()
        self.s_features = ConvLadder(3, base=8, sync=sync, group=group)
        self.t_features = ConvLadder(6, base=8, sync=sync, group=group)
        self.classifier = Classifier(2 * self.s_features.out_features(hw))

    def forward(self, f0, f1, f2):
        fs = self.s_features(f1)
        ft = self.t_features(torch.cat([f1 - f0, f1 - f2], dim=-1))
        return self.classifier(torch.cat([_flat(fs), _flat(ft)], dim=-1))


def build_discriminator(gan_type: str, hw: Tuple[int, int], sync: bool = False,
                        group=None) -> nn.Module:
    """The discriminator of ``gan_type`` for (H, W) inputs; with ``sync``
    its BN statistics run over the ranks of ``group`` (the world for
    None).  The module keeps both as ``sync`` and ``group``."""
    hw = (int(hw[0]), int(hw[1]))
    if gan_type == "T_WGAN_GP":
        disc = TemporalDiscriminator(hw, sync, group)
    elif gan_type == "FI_GAN":
        disc = FIDiscriminator(hw, sync, group)
    elif gan_type == "FI_Cond_GAN":
        disc = FICondDiscriminator(hw, sync, group)
    elif gan_type == "STGAN":
        disc = STDiscriminator(hw, sync, group)
    elif gan_type in ("GAN", "WGAN", "WGAN_GP"):
        disc = Discriminator(hw, gan_type, sync, group)
    else:
        raise ValueError(f"Unknown gan_type {gan_type!r}")
    disc.sync, disc.group = sync, group
    return disc


@torch.no_grad()
def init_discriminator(disc: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initial distributions, in place: every conv and
    linear weight and bias U(+-1/sqrt(fan_in)) (fan-in over the input
    channels and the window), BN scales 1 and shifts 0."""
    for m in disc.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            bound = 1.0 / math.sqrt(math.prod(m.weight.shape[1:]))
            for p in (m.weight, m.bias):
                if p is not None:
                    p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
        elif isinstance(m, BasicBlock) and m.bn:
            m.scale.fill_(1.0)
            m.bias.zero_()
    return disc
