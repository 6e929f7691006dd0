"""Kernel B1: FAC apply with a given tap-major bank.

Replaces the TPU kernel ``ebfi_tpu/ops/pallas/fac.py::_fac_kernel``
(public ``kernel_conv2d_pallas``).  CUDA source: ``csrc/fac.cu``.

Bound on the H100: memory.  The (B, H, W, K*K*C) bank is read once and
dominates every other byte; the kernel does 2*K*K flops per output.  The
design gives one thread to each output (b, y, x, c) with neighbouring
threads on neighbouring channels, so the bank streams once in fully
coalesced reads and the padded input is never materialised (clamped
indices replace the replication pad).

Training: the TPU kernel has no backward kernel; its ``custom_vjp``
recomputes through the XLA twin.  Here a ``torch.autograd.Function`` does
the same through :func:`fac_plain`.
"""
from __future__ import annotations

import torch

from ..kernel_conv2d import kernel_conv2d
from ._common import DTYPE_CODES, check_inputs, needs_grad, plain_vjp, stream_handle
from .build import check, load_library


def fac_plain(x: torch.Tensor, kernel: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: tap-major FAC."""
    return kernel_conv2d(x, kernel, kernel_size, layout="tap_major")


def _launch(x: torch.Tensor, kernel: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """One launch of B1 on CUDA tensors; no autograd."""
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


def _run(x: torch.Tensor, kernel: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """The forward without autograd: B1 for CUDA tensors, the plain version
    for CPU tensors."""
    if x.device.type == "cpu":
        return fac_plain(x, kernel, kernel_size)
    return _launch(x, kernel, kernel_size)


class _FacFunction(torch.autograd.Function):
    """B1 with a backward: the JAX package's ``custom_vjp`` of
    ``kernel_conv2d_pallas`` (``fac.py:99-117``), which recomputes through
    the XLA twin, recomputes here through :func:`fac_plain`."""

    @staticmethod
    def forward(ctx, x, kernel, kernel_size):
        ctx.kernel_size = kernel_size
        ctx.save_for_backward(x, kernel)
        return _run(x, kernel, kernel_size)

    @staticmethod
    def backward(ctx, grad_out):
        K = ctx.kernel_size
        gx, gk = plain_vjp(lambda a, b: fac_plain(a, b, K), ctx.saved_tensors,
                           ctx.needs_input_grad[:2], grad_out, "ebfi::fac_backward_plain")
        return gx, gk, None


def kernel_conv2d_cuda(x: torch.Tensor, kernel: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """FAC with replication padding.  x (B, H, W, C), kernel
    (B, H, W, K*K*C) tap-major -> (B, H, W, C) in x's dtype, f32
    accumulation.  CUDA tensors launch the kernel; CPU tensors run
    :func:`fac_plain`.  Where autograd records, the result's gradient
    recomputes through :func:`fac_plain`."""
    if needs_grad(x, kernel):
        return _FacFunction.apply(x, kernel, kernel_size)
    return _run(x, kernel, kernel_size)


kernel_conv2d_cuda.launches = 0
