"""Kernel B1: FAC apply with a given tap-major bank.

Replaces the TPU kernel ``ebfi_tpu/ops/pallas/fac.py::_fac_kernel``
(public ``kernel_conv2d_pallas``).  CUDA source: ``csrc/fac.cu``.

Bound on the H100: memory.  The (B, H, W, K*K*C) bank is read once and
dominates every other byte; the kernel does 2*K*K flops per output.  The
design gives one thread to each output (b, y, x, c) with neighbouring
threads on neighbouring channels, so the bank streams once in fully
coalesced reads and the padded input is never materialised (clamped
indices replace the replication pad).

The kernel is the custom op ``ebfi::fac`` (``torch.ops.ebfi.fac``), so
``torch.export`` records it as one node: its implementation is
:func:`_run` (the launch for a CUDA tensor, :func:`fac_plain` for a CPU
one), its fake implementation gives the output's shape (and, traced for
the card, raises where the launch would), and its autograd
formula recomputes through :func:`fac_plain`, as the TPU kernel's
``custom_vjp`` recomputes through the XLA twin (the JAX package has no
backward kernel).
"""
from __future__ import annotations

import torch

from ..kernel_conv2d import kernel_conv2d
from ._common import DTYPE_CODES, check_inputs, define_op, on_device, stream_handle
from .build import check, load_library


def fac_plain(x: torch.Tensor, kernel: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: tap-major FAC."""
    return kernel_conv2d(x, kernel, kernel_size, layout="tap_major")


def _check(x: torch.Tensor, kernel: torch.Tensor, K: int) -> None:
    """Raise for a call B1 does not take."""
    B, H, W, C = x.shape
    if K % 2 != 1:
        raise ValueError("kernel_size must be odd")
    if tuple(kernel.shape) != (B, H, W, K * K * C):
        raise ValueError(f"bank shape {tuple(kernel.shape)} does not match x {tuple(x.shape)}, K={K}")


def _launch(x: torch.Tensor, kernel: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """One launch of B1 on CUDA tensors; no autograd."""
    K = kernel_size
    B, H, W, C = x.shape
    _check(x, kernel, K)
    check_inputs("kernel_conv2d_cuda", {"x": x, "kernel": kernel}, x.dtype)
    out = torch.empty_like(x)
    lib = load_library()
    with on_device(x.device):
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


def _impl(x, kernel, kernel_size):
    return _run(x.contiguous(), kernel.contiguous(), kernel_size)


def _fake(x, kernel, kernel_size):
    if x.device.type != "cpu":  # traced for the card: raise where the launch would
        _check(x, kernel, kernel_size)
    return x.new_empty(x.shape)


# the backward: kernel_conv2d_pallas's custom_vjp's (fac.py:99-117)
_fac_op = define_op("fac(Tensor x, Tensor kernel, int kernel_size) -> Tensor",
                    _impl, _fake, fac_plain, 2, "ebfi::fac_backward_plain")


def kernel_conv2d_cuda(x: torch.Tensor, kernel: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """FAC with replication padding.  x (B, H, W, C), kernel
    (B, H, W, K*K*C) tap-major -> (B, H, W, C) in x's dtype, f32
    accumulation, through ``ebfi::fac``: CUDA tensors launch the kernel;
    CPU tensors run :func:`fac_plain`.  Where autograd records, the
    result's gradient recomputes through :func:`fac_plain`."""
    return _fac_op(x, kernel, kernel_size)


kernel_conv2d_cuda.launches = 0
