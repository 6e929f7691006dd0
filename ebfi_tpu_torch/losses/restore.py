"""Restoration losses (port of ``ebfi_tpu/losses/restore.py``).

- :func:`laplacian_loss`: 5-level Laplacian-pyramid L1 with level weights
  2^i; reflect-padded depthwise 5x5 Gaussian, 2x2 average pool,
  zero-stuffed expand.
- :func:`census_loss`: 7x7 census-transform (ternary) distance, target
  branch detached, interior-masked mean.
- :func:`charbonnier_loss`: sum sqrt(d^2 + eps), eps = 1e-3.
- :func:`mse_loss`, :func:`l1_loss`: means.

Image tensors are NHWC in [0, 1].  PSNR and SSIM are in
``ebfi_tpu_torch/utils/metrics.py``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_GAUSS_1D = np.array([1.0, 4.0, 6.0, 4.0, 1.0])
_GAUSS_2D = np.outer(_GAUSS_1D, _GAUSS_1D) / 256.0  # (5, 5)


def _gauss_blur(x: torch.Tensor, factor: float = 1.0) -> torch.Tensor:
    """Depthwise 5x5 Gaussian with reflect padding, NHWC."""
    C = x.shape[-1]
    kern = torch.as_tensor(_GAUSS_2D * factor, dtype=x.dtype, device=x.device)
    kern = kern.expand(C, 1, 5, 5)
    xp = F.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2), mode="reflect")
    return F.conv2d(xp, kern, groups=C).permute(0, 2, 3, 1)


def _reduce(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, NHWC."""
    B, H, W, C = x.shape
    x = x[:, : H // 2 * 2, : W // 2 * 2]
    return x.reshape(B, H // 2, 2, W // 2, 2, C).sum(dim=(2, 4)) / 4.0


def _expand(x: torch.Tensor) -> torch.Tensor:
    """Zero-stuff odd rows and columns, then blur with 4x the Gaussian."""
    B, H, W, C = x.shape
    up = x.new_zeros((B, H * 2, W * 2, C))
    up[:, ::2, ::2, :] = x
    return _gauss_blur(up, factor=4.0)


def laplacian_pyramid(x: torch.Tensor, max_level: int = 5):
    pyramid = []
    current = x
    for _ in range(max_level - 1):
        reduced = _reduce(_gauss_blur(current))
        pyramid.append(current - _expand(reduced))
        current = reduced
    pyramid.append(current)
    return pyramid


def laplacian_loss(pred: torch.Tensor, target: torch.Tensor, max_level: int = 5) -> torch.Tensor:
    """sum_i 2^i * sum |Lap_i(pred) - Lap_i(target)|."""
    px = laplacian_pyramid(pred, max_level)
    py = laplacian_pyramid(target, max_level)
    return sum((2.0**i) * (a - b).abs().sum() for i, (a, b) in enumerate(zip(px, py)))


def _census_transform(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Normalised local differences over the patch_size^2 neighbourhood of
    the grey image (zero-padded)."""
    gray = x.mean(dim=-1, keepdim=True)  # (B, H, W, 1)
    p = patch_size // 2
    gp = F.pad(gray, (0, 0, p, p, p, p))
    B, H, W, _ = x.shape
    patches = torch.stack(
        [gp[:, dy : dy + H, dx : dx + W, 0] for dy in range(patch_size) for dx in range(patch_size)],
        dim=-1,
    )  # (B, H, W, P^2)
    loc_diff = patches - gray
    return loc_diff / torch.sqrt(0.81 + loc_diff**2)


def census_loss(pred: torch.Tensor, target: torch.Tensor, patch_size: int = 7) -> torch.Tensor:
    """Soft Hamming distance of census descriptors, the target's detached,
    averaged with a mask that keeps the interior (p = patch_size // 2 rows
    and columns off each border)."""
    dx = _census_transform(pred, patch_size)
    dy = _census_transform(target, patch_size).detach()
    diff = dx - dy
    dist = (diff**2 / (0.1 + diff**2)).mean(dim=-1, keepdim=True)
    p = patch_size // 2
    B, H, W, _ = pred.shape
    mask = pred.new_zeros((1, H, W, 1))
    mask[:, p : H - p, p : W - p, :] = 1.0
    return (dist * mask).mean()


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    d = pred - target
    return torch.sqrt(d * d + eps).sum()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()
