"""Kernel B1: FAC apply with a given tap-major bank.

Replaces the TPU kernel ``ebfi_tpu/ops/pallas/fac.py::_fac_kernel``
(public ``kernel_conv2d_pallas``).  CUDA source: ``csrc/fac.cu``.

Bound on the H100: memory.  The (B, H, W, K*K*C) bank is read once and
dominates every other byte; the kernel does 2*K*K flops per output.  The
design gives one thread to each output (b, y, x, c) with neighbouring
threads on neighbouring channels, so the bank streams once in fully
coalesced reads and the padded input is never materialised (clamped
indices replace the replication pad).
"""
from __future__ import annotations

import torch

from ..kernel_conv2d import kernel_conv2d
from ._common import DTYPE_CODES, check_inputs, stream_handle
from .build import check, load_library


def fac_plain(x: torch.Tensor, kernel: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: tap-major FAC."""
    return kernel_conv2d(x, kernel, kernel_size, layout="tap_major")


def kernel_conv2d_cuda(x: torch.Tensor, kernel: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """FAC with replication padding.  x (B, H, W, C), kernel
    (B, H, W, K*K*C) tap-major -> (B, H, W, C) in x's dtype, f32
    accumulation.  CUDA tensors launch the kernel; CPU tensors run
    :func:`fac_plain`."""
    if x.device.type == "cpu":
        return fac_plain(x, kernel, kernel_size)
    K = kernel_size
    B, H, W, C = x.shape
    if K % 2 != 1:
        raise ValueError("kernel_size must be odd")
    if tuple(kernel.shape) != (B, H, W, K * K * C):
        raise ValueError(f"bank shape {tuple(kernel.shape)} does not match x {tuple(x.shape)}, K={K}")
    check_inputs("kernel_conv2d_cuda", {"x": x, "kernel": kernel}, x.dtype)
    out = torch.empty_like(x)
    lib = load_library()
    err = lib.ebfi_fac_forward(
        x.data_ptr(), kernel.data_ptr(), out.data_ptr(), B, H, W, C, K,
        DTYPE_CODES[x.dtype], stream_handle(x.device),
    )
    check(lib, err, "ebfi_fac_forward")
    kernel_conv2d_cuda.launches += 1
    return out


kernel_conv2d_cuda.launches = 0
