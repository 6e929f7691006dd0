"""DCN modules and deformable PSROI pooling (port of
``ebfi_tpu/ops/dcn_modules.py``).

- :class:`DCNv2Module` / :class:`DCN` / :class:`DCNSep`: modules around
  :func:`dcn_v2_conv` as the reference's torch modules are
  (models/DCNv2/dcn_v2.py:98-227): a dense weight (Cout, Cin, Kh, Kw)
  drawn U(+-1/sqrt(Cin*K*K)), a zero bias, and a zero-initialised
  offset/mask conv.  ``DCNSep`` predicts the offsets from a second feature
  map (the alignment module, model_singleframe.py:16).
- :func:`dcn_v2_psroi_pooling`: deformable position-sensitive ROI pooling
  (dcn_v2_psroi_pooling_cuda.cu:59-146), differentiable through autograd.

The reference's wiring quirk stays for checkpoint parity: the offset
conv's output is split in thirds (o1, o2, mask) and ``cat(o1, o2)`` feeds
the raw op's interleaved (h, w) layout as it is (dcn_v2.py:181-186).
Modules take and return NHWC tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .dcn_v2 import dcn_v2_conv


class DCNv2Module(nn.Module):
    """Modulated deformable conv taking precomputed offsets and mask."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, dilation: int = 1, deformable_groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.deformable_groups = deformable_groups
        stdv = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel_size, kernel_size).uniform_(-stdv, stdv))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x, offset, mask):
        return dcn_v2_conv(x, offset, mask, self.weight, self.bias, self.stride, self.padding,
                           self.dilation, self.deformable_groups)


class _OffsetMaskConv(nn.Module):
    """Zero-initialised conv predicting (o1, o2, mask) (dcn_v2.py:163-174)."""

    def __init__(self, in_ch: int, kernel_size: int, stride: int, padding: int,
                 deformable_groups: int):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.conv = nn.Conv2d(in_ch, deformable_groups * 3 * kernel_size * kernel_size,
                              kernel_size, stride, padding)
        nn.init.zeros_(self.conv.weight)
        nn.init.zeros_(self.conv.bias)

    def forward(self, fea):
        out = F.conv2d(fea.permute(0, 3, 1, 2), self.conv.weight, self.conv.bias, self.stride,
                       self.padding).permute(0, 2, 3, 1)
        o1, o2, mask = torch.chunk(out, 3, dim=-1)
        return torch.cat([o1, o2], dim=-1), torch.sigmoid(mask)


class DCN(nn.Module):
    """Self-offset DCN (dcn_v2.py:149-196)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, dilation: int = 1, deformable_groups: int = 1):
        super().__init__()
        self.conv_offset_mask = _OffsetMaskConv(in_ch, kernel_size, stride, padding,
                                                deformable_groups)
        self.dcn = DCNv2Module(in_ch, out_ch, kernel_size, stride, padding, dilation,
                               deformable_groups)

    def forward(self, x):
        offset, mask = self.conv_offset_mask(x)
        return self.dcn(x, offset, mask)


class DCNSep(nn.Module):
    """Offsets from a second feature map of ``fea_ch`` channels
    (dcn_v2.py:197-227): the feature-alignment module."""

    def __init__(self, in_ch: int, fea_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1,
                 deformable_groups: int = 1):
        super().__init__()
        self.conv_offset_mask = _OffsetMaskConv(fea_ch, kernel_size, stride, padding,
                                                deformable_groups)
        self.dcn = DCNv2Module(in_ch, out_ch, kernel_size, stride, padding, dilation,
                               deformable_groups)

    def forward(self, x, fea):
        offset, mask = self.conv_offset_mask(fea)
        return self.dcn(x, offset, mask)


def dcn_v2_psroi_pooling(x: torch.Tensor, rois: torch.Tensor, trans: Optional[torch.Tensor],
                         spatial_scale: float, pooled_size: int, output_dim: int,
                         group_size: int = 1, part_size: Optional[int] = None,
                         sample_per_part: int = 4, trans_std: float = 0.0) -> torch.Tensor:
    """Deformable PSROI pooling (dcn_v2_psroi_pooling_cuda.cu:59-146).

    x: (B, H, W, C) with C == output_dim * group_size**2; rois: (N, 5) =
    (batch index, x1, y1, x2, y2); trans: (N, num_classes*2, part, part)
    offsets or None.  Returns (N, pooled, pooled, output_dim)."""
    B, H, W, C = x.shape
    dev = x.device
    P = pooled_size
    part_size = part_size or P
    num_classes = 1 if trans is None else trans.shape[1] // 2
    ch_each = output_dim // num_classes
    N = rois.shape[0]

    bidx = rois[:, 0].to(torch.int64)
    x0 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y0 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x1 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y1 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    rw = torch.clamp(x1 - x0, min=0.1)
    rh = torch.clamp(y1 - y0, min=0.1)
    bin_w, bin_h = rw / P, rh / P

    pp = torch.arange(P, device=dev)
    part = torch.floor(pp / P * part_size).to(torch.int64)
    g = torch.clamp((pp * group_size) // P, 0, group_size - 1)
    ct = torch.arange(output_dim, device=dev)
    class_id = ct // ch_each

    if trans is None:
        tx = torch.zeros((N, output_dim, P, P), dtype=x.dtype, device=dev)
        ty = torch.zeros_like(tx)
    else:
        tr = trans.reshape(N, num_classes, 2, part_size, part_size)
        tx = tr[:, class_id, 0][:, :, part][:, :, :, part] * trans_std  # (N, D, P, P)
        ty = tr[:, class_id, 1][:, :, part][:, :, :, part] * trans_std

    e4 = lambda v: v[:, None, None, None]
    wstart = pp[None, None, None, :] * e4(bin_w) + e4(x0) + tx * e4(rw)
    hstart = pp[None, None, :, None] * e4(bin_h) + e4(y0) + ty * e4(rh)
    sub_w = (bin_w / sample_per_part)[:, None, None, None, None, None]
    sub_h = (bin_h / sample_per_part)[:, None, None, None, None, None]
    iw = torch.arange(sample_per_part, device=dev)
    sw = wstart[..., None, None] + iw[None, None, None, None, None, :] * sub_w
    sh = hstart[..., None, None] + iw[None, None, None, None, :, None] * sub_h

    valid = (sw >= -0.5) & (sw <= W - 0.5) & (sh >= -0.5) & (sh <= H - 0.5)
    swc = torch.clamp(sw, 0.0, W - 1.0)
    shc = torch.clamp(sh, 0.0, H - 1.0)
    # position-sensitive channel: c = (ct*G + gh)*G + gw, (D, P, P)
    chan = (ct[:, None, None] * group_size + g[None, :, None]) * group_size + g[None, None, :]

    h0, w0 = torch.floor(shc), torch.floor(swc)
    lh, lw = shc - h0, swc - w0
    xb = x[bidx].reshape(N, H * W * C)
    cexp = chan[None, :, :, :, None, None]
    val = 0.0
    for dy, dx, wt in ((0, 0, (1 - lh) * (1 - lw)), (0, 1, (1 - lh) * lw),
                       (1, 0, lh * (1 - lw)), (1, 1, lh * lw)):
        hi = torch.clamp(h0.to(torch.int64) + dy, 0, H - 1)
        wi = torch.clamp(w0.to(torch.int64) + dx, 0, W - 1)
        idx = (hi * W + wi) * C + cexp  # (N, D, P, P, s, s)
        gathered = torch.gather(xb, 1, idx.reshape(N, -1)).reshape(idx.shape)
        val = val + wt * gathered
    val = torch.where(valid, val, 0.0)
    cnt = valid.sum(dim=(-1, -2))
    pooled = torch.where(cnt > 0, val.sum(dim=(-1, -2)) / torch.clamp(cnt, min=1), 0.0)
    return pooled.permute(0, 2, 3, 1)
