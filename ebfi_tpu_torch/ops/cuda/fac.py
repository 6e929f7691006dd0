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

Band mode (spatial parallelism, ``ebfi::fac_band``, :func:`fac_band_cuda`):
the same kernel on a band of rows whose (K-1)/2 halo rows above and below
come in place with x, so only W is clamped; its plain version is
:func:`fac_band_plain`, and its launches count in
``fac_band_cuda.launches``, apart from the whole-image launches.
"""
from __future__ import annotations

import torch

from ..kernel_conv2d import kernel_conv2d, kernel_conv2d_band
from ._common import DTYPE_CODES, check_inputs, define_op, on_device, stream_handle
from .build import check, load_library


def fac_plain(x: torch.Tensor, kernel: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: tap-major FAC."""
    return kernel_conv2d(x, kernel, kernel_size, layout="tap_major")


def fac_band_plain(x_rows: torch.Tensor, kernel: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Plain PyTorch version of the band mode: tap-major FAC on rows that
    carry their halo, padded in W alone."""
    return kernel_conv2d_band(x_rows, kernel, kernel_size, layout="tap_major")


def _check(x: torch.Tensor, kernel: torch.Tensor, K: int, band: bool = False) -> None:
    """Raise for a call B1 does not take (in band mode x has K-1 more rows
    than the bank)."""
    B, H, W, C = x.shape
    if K % 2 != 1:
        raise ValueError("kernel_size must be odd")
    if tuple(kernel.shape) != (B, H - (K - 1 if band else 0), W, K * K * C):
        raise ValueError(f"bank shape {tuple(kernel.shape)} does not match x {tuple(x.shape)}, "
                         f"K={K}{' (band mode)' if band else ''}")


def _launch(x: torch.Tensor, kernel: torch.Tensor, kernel_size: int,
            band: bool = False) -> torch.Tensor:
    """One launch of B1 (or of its band mode) on CUDA tensors; no autograd."""
    K = kernel_size
    _check(x, kernel, K, band)
    what, entry = (("fac_band_cuda", "ebfi_fac_band_forward") if band
                   else ("kernel_conv2d_cuda", "ebfi_fac_forward"))
    check_inputs(what, {"x": x, "kernel": kernel}, x.dtype)
    B, H, W, _ = kernel.shape
    C = x.shape[-1]
    out = x.new_empty((B, H, W, C))
    lib = load_library()
    with on_device(x.device):
        err = getattr(lib, entry)(
            x.data_ptr(), kernel.data_ptr(), out.data_ptr(), B, H, W, C, K,
            DTYPE_CODES[x.dtype], stream_handle(x.device),
        )
    check(lib, err, entry)
    (fac_band_cuda if band else kernel_conv2d_cuda).launches += 1
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


def _run_band(x_rows: torch.Tensor, kernel: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """The band mode's forward without autograd: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x_rows.device.type == "cpu":
        return fac_band_plain(x_rows, kernel, kernel_size)
    return _launch(x_rows, kernel, kernel_size, band=True)


def _impl_band(x_rows, kernel, kernel_size):
    return _run_band(x_rows.contiguous(), kernel.contiguous(), kernel_size)


def _fake_band(x_rows, kernel, kernel_size):
    if x_rows.device.type != "cpu":
        _check(x_rows, kernel, kernel_size, band=True)
    return x_rows.new_empty((*kernel.shape[:3], x_rows.shape[-1]))


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

_fac_band_op = define_op("fac_band(Tensor x, Tensor kernel, int kernel_size) -> Tensor",
                         _impl_band, _fake_band, fac_band_plain, 2,
                         "ebfi::fac_band_backward_plain")


def fac_band_cuda(x_rows: torch.Tensor, kernel: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """B1's band mode: x_rows (B, H+K-1, W, C) with its halo rows in place,
    kernel (B, H, W, K*K*C) tap-major -> (B, H, W, C), through
    ``ebfi::fac_band``: CUDA tensors launch the kernel, CPU tensors run
    :func:`fac_band_plain`; the gradient recomputes through
    :func:`fac_band_plain` (the halo rows' part returns to their owners
    through the halo exchange's backward)."""
    return _fac_band_op(x_rows, kernel, kernel_size)


fac_band_cuda.launches = 0
