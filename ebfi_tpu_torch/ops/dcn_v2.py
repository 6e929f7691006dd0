"""Modulated deformable convolution v2 (DCNv2), port of
``ebfi_tpu/ops/dcn_v2.py``.

A bilinear-sampled im2col with learned per-tap offsets and a modulation
mask, then a contraction with the dense weight (the reference's CUDA
im2col, models/DCNv2/src/cuda/dcn_v2_im2col_cuda.cu:125-196, and GEMM,
dcn_v2_cuda.cu:60-94).  One loop over the K*K taps; each tap gathers the
four bilinear corners over the flattened spatial axis, out-of-bounds
corners masked as ``dmcn_im2col_bilinear_cuda`` does (a tap contributes
iff ``-1 < h < H`` and ``-1 < w < W``, each corner iff it lies inside the
image).  Autograd through the gathers gives the backward (the reference's
col2im and col2im_coord kernels), as autodiff does in the JAX package.

Layouts (NHWC):
  x:      (B, H, W, Cin)
  offset: (B, Ho, Wo, DG*2*Kh*Kw)  channel = dg*(2*Kh*Kw) + 2*(i*Kw+j) + {0:h, 1:w}
  mask:   (B, Ho, Wo, DG*Kh*Kw)    channel = dg*(Kh*Kw) + i*Kw + j
  weight: (Cout, Cin, Kh, Kw)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def dcn_v2_im2col(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor, kernel_size,
                  stride=1, padding=0, dilation=1, deformable_groups: int = 1) -> torch.Tensor:
    """Deformable bilinear im2col: columns (B, Ho, Wo, Cin, Kh*Kw), the last
    axis ordered ``i*Kw + j``, i.e. the CUDA column layout
    ``c*Kh*Kw + i*Kw + j`` (dcn_v2_im2col_cuda.cu:149-151)."""
    Kh, Kw = _pair(kernel_size)
    Sh, Sw = _pair(stride)
    Ph, Pw = _pair(padding)
    Dh, Dw = _pair(dilation)
    DG = deformable_groups
    B, H, W, C = x.shape
    Ho = (H + 2 * Ph - (Dh * (Kh - 1) + 1)) // Sh + 1
    Wo = (W + 2 * Pw - (Dw * (Kw - 1) + 1)) // Sw + 1
    if C % DG != 0:
        raise ValueError(f"Cin={C} not divisible by deformable_groups={DG}")
    Cg = C // DG

    # sampling positions in at least f32: their fractional parts vanish at
    # bf16 resolution; only the gathered values stay in the input dtype
    coord_dtype = torch.promote_types(offset.dtype, torch.float32)
    off = offset.to(coord_dtype).reshape(B, Ho, Wo, DG, Kh * Kw, 2)
    msk = mask.reshape(B, Ho, Wo, DG, Kh * Kw)
    xf = x.reshape(B, H * W, DG, Cg)
    hs = torch.arange(Ho, dtype=coord_dtype, device=x.device) * Sh - Ph
    ws = torch.arange(Wo, dtype=coord_dtype, device=x.device) * Sw - Pw

    cols = []
    for i in range(Kh):
        for j in range(Kw):
            tap = i * Kw + j
            h_im = hs[None, :, None, None] + i * Dh + off[..., tap, 0]  # (B, Ho, Wo, DG)
            w_im = ws[None, None, :, None] + j * Dw + off[..., tap, 1]
            tap_valid = (h_im > -1) & (h_im < H) & (w_im > -1) & (w_im < W)
            h_low, w_low = torch.floor(h_im), torch.floor(w_im)
            lh, lw = h_im - h_low, w_im - w_low
            hh, hw = 1.0 - lh, 1.0 - lw
            hl, wl = h_low.to(torch.int64), w_low.to(torch.int64)
            val = None
            for dy, dx, wt in ((0, 0, hh * hw), (0, 1, hh * lw), (1, 0, lh * hw), (1, 1, lh * lw)):
                hc, wc = hl + dy, wl + dx
                corner_valid = (hc >= 0) & (hc <= H - 1) & (wc >= 0) & (wc <= W - 1)
                flat = (hc.clamp(0, H - 1) * W + wc.clamp(0, W - 1)).reshape(B, Ho * Wo, DG, 1)
                v = torch.gather(xf, 1, flat.expand(-1, -1, -1, Cg)).reshape(B, Ho, Wo, DG, Cg)
                w_eff = torch.where(corner_valid, wt, 0.0).to(x.dtype)[..., None]
                val = v * w_eff if val is None else val + v * w_eff
            val = torch.where(tap_valid[..., None], val, 0.0)
            val = val * msk[..., tap][..., None]
            cols.append(val.reshape(B, Ho, Wo, C))
    return torch.stack(cols, dim=-1)


def dcn_v2_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], stride=1, padding=0, dilation=1,
                deformable_groups: int = 1) -> torch.Tensor:
    """Full DCNv2: deformable im2col, a contraction with the weight
    accumulated in at least f32 (the JAX einsum's ``Precision.HIGHEST``;
    on a card, with TF32 off), and the bias.  Mirrors ``dcn_v2_conv``
    (models/DCNv2/dcn_v2.py:17-95).  Returns (B, Ho, Wo, Cout)."""
    Cout, Cin, Kh, Kw = weight.shape
    cols = dcn_v2_im2col(x, offset, mask, (Kh, Kw), stride, padding, dilation, deformable_groups)
    acc = torch.promote_types(x.dtype, torch.float32)
    wmat = weight.reshape(Cout, Cin * Kh * Kw).to(acc)
    B, Ho, Wo = cols.shape[:3]
    out = (cols.reshape(B * Ho * Wo, Cin * Kh * Kw).to(acc) @ wmat.T).to(x.dtype)
    out = out.reshape(B, Ho, Wo, Cout)
    return out + bias if bias is not None else out
