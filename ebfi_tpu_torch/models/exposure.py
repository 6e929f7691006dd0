"""ExposureDecision: exposure-duty regressor (port of
``ebfi_tpu/models/exposure.py``).

Feature-extract the event stack and the blurriness map, GroupNorm both
with ONE shared GroupNorm (as the reference does), correlate, channel
attention from the pooled correlation, then a two-conv head pooled to one
sigmoid scalar per sample.  On a band (spatial parallelism) the
GroupNorm's statistics and the two means are the whole image's, so every
rank of a model group computes the same ``ex``, bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import band_mean
from .layers import ConvLayer, group_norm_nhwc


class ExposureDecision(nn.Module):
    def __init__(
        self,
        event_in: int = 32,
        bl_in: int = 1,
        inter_ch: int = 64,
        groups: int = 4,
        norm: Optional[str] = None,
        activation: str = "LeakyReLU",
    ):
        super().__init__()
        self.event_feat = ConvLayer(event_in, inter_ch, 3, 1, 1, activation, norm)
        self.bl_feat = ConvLayer(bl_in, inter_ch, 3, 1, 1, activation, norm)
        self.group_norm = nn.GroupNorm(groups, inter_ch, eps=1e-5)
        self.head1 = ConvLayer(2 * inter_ch, inter_ch, 3, 1, 1, activation, norm)
        self.head2 = ConvLayer(inter_ch, 1, 3, 1, 1, None, norm)

    def forward(self, event: torch.Tensor, blurry_level: torch.Tensor) -> torch.Tensor:
        """event (B, H, W, 2*TB), blurry_level (B, H, W, bl_in) -> (B, 1)."""
        event_feat = self.event_feat(event)
        bl_feat = self.bl_feat(blurry_level)
        gn = lambda x: group_norm_nhwc(self.group_norm, x)
        corre = gn(event_feat) * gn(bl_feat)
        atten = torch.sigmoid(band_mean(corre, (1, 2), keepdim=True))  # (B, 1, 1, C)
        h = self.head1(torch.cat([event_feat * atten, bl_feat], dim=-1))
        h = self.head2(h)
        return torch.sigmoid(band_mean(h, (1, 2)).reshape(-1, 1))
