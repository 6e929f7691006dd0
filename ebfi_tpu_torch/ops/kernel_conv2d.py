"""Filter-adaptive convolution (FAC), plain PyTorch.

Every output pixel is convolved with its own K x K kernel taken from a
per-pixel bank; the input is replication-padded by (K-1)/2.  Port of
``ebfi_tpu/ops/kernel_conv2d.py`` and the plain version of kernel B1
(``ops/cuda/fac.py``).  Layout NHWC; the bank is (B, H, W, C*K*K) with
channel ``c*K*K + ky*K + kx`` ('c_major', the reference op's order) or
``(ky*K + kx)*C + c`` ('tap_major', the framework's order).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def kernel_conv2d_raw(
    x_pad: torch.Tensor, kernel: torch.Tensor, kernel_size: int, layout: str = "c_major"
) -> torch.Tensor:
    """Per-pixel kernels on an already padded input: x_pad
    (B, H+K-1, W+K-1, C), kernel (B, H, W, C*K*K) -> (B, H, W, C)."""
    K = kernel_size
    B, Hp, Wp, C = x_pad.shape
    H, W = Hp - (K - 1), Wp - (K - 1)
    if tuple(kernel.shape) != (B, H, W, C * K * K):
        raise ValueError(
            f"kernel shape {tuple(kernel.shape)} incompatible with input "
            f"{tuple(x_pad.shape)} and K={K}"
        )
    if layout == "c_major":
        kern = kernel.reshape(B, H, W, C, K, K)
        taps = lambda ky, kx: kern[..., ky, kx]
    elif layout == "tap_major":
        taps = lambda ky, kx: kernel[..., (ky * K + kx) * C : (ky * K + kx + 1) * C]
    else:
        raise ValueError(f"unknown layout {layout!r}")
    out = torch.zeros(
        (B, H, W, C), dtype=torch.promote_types(x_pad.dtype, kernel.dtype),
        device=x_pad.device,
    )
    for ky in range(K):
        for kx in range(K):
            out = out + x_pad[:, ky : ky + H, kx : kx + W, :] * taps(ky, kx)
    return out


def kernel_conv2d(
    x: torch.Tensor, kernel: torch.Tensor, kernel_size: int, layout: str = "c_major"
) -> torch.Tensor:
    """FAC with replication padding: x (B, H, W, C), kernel
    (B, H, W, C*K*K) in either layout, odd K -> (B, H, W, C)."""
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    p = (kernel_size - 1) // 2
    x_pad = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="replicate")
    return kernel_conv2d_raw(x_pad.permute(0, 2, 3, 1), kernel, kernel_size, layout)
