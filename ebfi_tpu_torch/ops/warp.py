"""Warping and image-gradient utilities of the flow losses (port of
``ebfi_tpu/ops/warp.py``).

- :func:`grid_sample`: bilinear sampling at normalised grid positions,
  ``align_corners=True``, zeros outside: the four corners of each sample
  gathered and weighted in the JAX op order, each corner counted only
  where it lies inside the image.  It computes what
  ``F.grid_sample(..., align_corners=True, padding_mode="zeros")`` does,
  and its gradient takes the same conventions as the JAX loop's (the
  derivative of ``|x|`` is 0 at 0, the floor's is 0).
- :func:`sobel_gradients`: replication-padded 3x3 Sobel / 8.

Images are NHWC.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """img: (B, H, W, C); grid: (B, H', W', 2) with (x, y) in [-1, 1].
    Returns (B, H', W', C), zeros outside."""
    B, H, W, C = img.shape
    gx = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    gy = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    out = torch.zeros(grid.shape[:-1] + (C,), dtype=img.dtype, device=img.device)
    imgf = img.reshape(B, H * W, C)
    for dy in (0, 1):
        for dx in (0, 1):
            xc, yc = x0 + dx, y0 + dy
            w = (1 - (gx - xc).abs()) * (1 - (gy - yc).abs())
            valid = (xc >= 0) & (xc <= W - 1) & (yc >= 0) & (yc <= H - 1)
            xi = xc.to(torch.int64).clamp(0, W - 1)
            yi = yc.to(torch.int64).clamp(0, H - 1)
            flat = (yi * W + xi).reshape(B, -1, 1).expand(-1, -1, C)
            v = torch.gather(imgf, 1, flat).reshape(out.shape)
            out = out + torch.where(valid[..., None], w[..., None] * v, 0.0)
    return out


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def sobel_gradients(x: torch.Tensor):
    """x: (B, H, W, 1) -> (gradx, grady), each (B, H, W, 1)."""
    B, H, W, _ = x.shape
    xp = F.pad(x[..., 0][:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    win = [xp[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]
    gradx = sum(w * (_SOBEL_X[i // 3][i % 3] / 8.0) for i, w in enumerate(win))
    grady = sum(w * (_SOBEL_Y[i // 3][i % 3] / 8.0) for i, w in enumerate(win))
    return gradx[..., None], grady[..., None]
