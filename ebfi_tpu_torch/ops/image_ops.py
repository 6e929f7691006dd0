"""Image ops of the blurriness maps and layout helpers (NHWC).

Port of ``ebfi_tpu/ops/image_ops.py``: the dark channel is a min-pool, the
Laplacian reproduces cv2's fixed-point grayscale and 3x3 stencil in integer
arithmetic, and pixel shuffle keeps torch's channel ordering.
"""
from __future__ import annotations

from math import ceil, floor

import torch
import torch.nn.functional as F


def dark_channel(frame: torch.Tensor, size: int = 35) -> torch.Tensor:
    """Channel-min then a ``size`` x ``size`` SAME min-pool that ignores
    out-of-image taps.  frame (B, H, W, 3) -> (B, H, W, 1)."""
    dc = frame.amin(dim=-1)[:, None]  # (B, 1, H, W)
    lo = (size - 1) // 2
    hi = size - 1 - lo
    padded = F.pad(-dc, (lo, hi, lo, hi), value=float("-inf"))
    return (-F.max_pool2d(padded, size, stride=1)).permute(0, 2, 3, 1)


def laplacian_response(frame: torch.Tensor) -> torch.Tensor:
    """cv2-parity Laplacian blurriness map of an RGB frame in [0, 1].

    Quantise by truncation to uint8, cv2's fixed-point BGR2GRAY applied to
    RGB data (so the R/B weights are swapped), then the 3x3 Laplacian with
    REFLECT_101 borders.  frame (B, H, W, 3) -> (B, H, W, 1) float32.
    """
    u8 = torch.clamp(torch.floor(frame * 255.0), 0, 255).to(torch.int32)
    r, g, b = u8[..., 0], u8[..., 1], u8[..., 2]
    gray = (r * 3735 + g * 19235 + b * 9798 + (1 << 14)) >> 15  # (B, H, W)
    # reflect-pad an integer map without a float round trip
    gpad = torch.cat([gray[:, 1:2], gray, gray[:, -2:-1]], dim=1)
    gpad = torch.cat([gpad[:, :, 1:2], gpad, gpad[:, :, -2:-1]], dim=2)
    lap = (
        gpad[:, :-2, 1:-1]
        + gpad[:, 2:, 1:-1]
        + gpad[:, 1:-1, :-2]
        + gpad[:, 1:-1, 2:]
        - 4 * gray
    )
    return lap.to(torch.float32)[..., None]


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth-to-space with ``nn.PixelShuffle`` channel order on NHWC:
    (B, H, W, C*r*r) -> (B, H*r, W*r, C)."""
    B, H, W, Crr = x.shape
    r = factor
    C = Crr // (r * r)
    x = x.reshape(B, H, W, C, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * r, W * r, C)


def pad_amounts_to_multiple(h: int, w: int, factor_h: int, factor_w: int):
    """(top, bottom, left, right): ceil-half on top/left, floor-half on
    bottom/right."""
    hc = factor_h * ceil(h / factor_h)
    wc = factor_w * ceil(w / factor_w)
    return (
        ceil(0.5 * (hc - h)),
        floor(0.5 * (hc - h)),
        ceil(0.5 * (wc - w)),
        floor(0.5 * (wc - w)),
    )
