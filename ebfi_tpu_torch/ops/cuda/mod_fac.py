"""Kernels B3 and B2: kernel-bank prediction fused with the FAC apply.

B3 replaces ``ebfi_tpu/ops/pallas/mod_fac.py::_kernel`` (public
``modification_fac_fused``); B2 replaces ``::_kernel_shared`` (public
``modification_fac_fused_shared``, unpacked output).  CUDA source:
``csrc/mod_fac.cu``.

Bound on the H100: operations.  The 3x3 bank conv (depth 9*2C = 1152 into
K*K*C = 1600 channels) is hundreds of flops per byte.  The kernels keep
the TPU kernels' one idea, that the bank never reaches device memory: a
block computes each tap's C bank channels for a 2x32-pixel tile from a
shared-memory copy of the tile's neighbourhood and folds them into the FAC
sum in registers.  B2 computes the frame-feature half of the bank conv plus
bias once per frame into a scratch in the input dtype (the TPU kernel's
band scratch rounds it the same way) rather than once per timestamp, which
halves its work at N = 16 for 1/16 of a bank of extra traffic per
timestamp.  The products run on the CUDA cores in f32; tensor-core tiles
are later work.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernel_conv2d import kernel_conv2d
from ._common import DTYPE_CODES, check_inputs, stream_handle
from .build import check, load_library

KERNEL_CHANNELS = 64  # the CUDA kernels' channel tile: C must equal it


def _conv3x3(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1).to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1)


def mod_fac_plain(ev, ff, wk, bk, kernel_size: int = 5) -> torch.Tensor:
    """Plain version of B3 (port of ``mod_fac.py::_xla_twin``): 3x3 bank
    conv of concat(ev, ff) with HWIO weight wk (3, 3, 2C, K*K*C), plus
    bias, leaky ReLU, then tap-major FAC of ev."""
    bank = _conv3x3(torch.cat([ev, ff], dim=-1), wk)
    bank = F.leaky_relu(bank + bk.to(bank.dtype), 0.01).to(ev.dtype)
    return kernel_conv2d(ev, bank, kernel_size, layout="tap_major")


def mod_fac_shared_plain(ev, ff, wk, bk, kernel_size: int = 5) -> torch.Tensor:
    """Plain version of B2 (port of ``mod_fac.py::_xla_twin_shared``): the
    bank conv split by input halves, the ff half at batch B repeated over
    each frame's N timestamps (ev at batch B*N)."""
    BN, B, C = ev.shape[0], ff.shape[0], ff.shape[-1]
    bank_ff = _conv3x3(ff, wk[:, :, C:, :]).repeat_interleave(BN // B, dim=0)
    bank = _conv3x3(ev, wk[:, :, :C, :]) + bank_ff
    bank = F.leaky_relu(bank + bk.to(bank.dtype), 0.01).to(ev.dtype)
    return kernel_conv2d(ev, bank, kernel_size, layout="tap_major")


def _check_weights(what, C, K, wk, bk):
    if C != KERNEL_CHANNELS:
        raise ValueError(f"{what}: the CUDA kernel takes C={KERNEL_CHANNELS} channels, got {C}")
    if K % 2 != 1:
        raise ValueError(f"{what}: kernel_size must be odd")
    if tuple(wk.shape) != (3, 3, 2 * C, K * K * C) or tuple(bk.shape) != (K * K * C,):
        raise ValueError(
            f"{what}: weight {tuple(wk.shape)} / bias {tuple(bk.shape)} do not match C={C}, K={K}"
        )


def modification_fac_fused(ev, ff, wk, bk, kernel_size: int = 5) -> torch.Tensor:
    """lrelu(conv3x3(concat(ev, ff)) + bk) bank, FAC-applied to ev, with the
    bank kept on chip.  ev, ff (B, H, W, C); wk (3, 3, 2C, K*K*C) HWIO with
    tap-major output channels; bk (K*K*C,).  CUDA tensors launch B3; CPU
    tensors run :func:`mod_fac_plain`."""
    if ev.device.type == "cpu":
        return mod_fac_plain(ev, ff, wk, bk, kernel_size)
    K = kernel_size
    B, H, W, C = ev.shape
    _check_weights("modification_fac_fused", C, K, wk, bk)
    if tuple(ff.shape) != tuple(ev.shape):
        raise ValueError(f"ff shape {tuple(ff.shape)} != ev shape {tuple(ev.shape)}")
    w2 = wk.to(ev.dtype).reshape(9 * 2 * C, K * K * C).contiguous()
    b32 = bk.float().contiguous()
    check_inputs("modification_fac_fused", {"ev": ev, "ff": ff, "wk": w2}, ev.dtype)
    check_inputs("modification_fac_fused", {"bk": b32}, torch.float32)
    out = torch.empty_like(ev)
    lib = load_library()
    err = lib.ebfi_mod_fac_fused(
        ev.data_ptr(), ff.data_ptr(), w2.data_ptr(), b32.data_ptr(), out.data_ptr(),
        B, H, W, C, K, DTYPE_CODES[ev.dtype], stream_handle(ev.device),
    )
    check(lib, err, "ebfi_mod_fac_fused")
    modification_fac_fused.launches += 1
    return out


def modification_fac_fused_shared(ev, ff, wk, bk, kernel_size: int = 5) -> torch.Tensor:
    """The fused bank + FAC for N timestamps sharing one frame: ev
    (B*N, H, W, C) b-major, ff (B, H, W, C).  The ff half of the bank conv
    plus bias is computed once per frame and rounded to the input dtype.
    CUDA tensors launch B2; CPU tensors run :func:`mod_fac_shared_plain`."""
    if ev.device.type == "cpu":
        return mod_fac_shared_plain(ev, ff, wk, bk, kernel_size)
    K = kernel_size
    BN, H, W, C = ev.shape
    B = ff.shape[0]
    _check_weights("modification_fac_fused_shared", C, K, wk, bk)
    if tuple(ff.shape[1:]) != (H, W, C) or B == 0 or BN % B:
        raise ValueError(f"ff shape {tuple(ff.shape)} does not divide ev shape {tuple(ev.shape)}")
    N = BN // B
    wke = wk[:, :, :C, :].to(ev.dtype).reshape(9 * C, K * K * C).contiguous()
    wkf = wk[:, :, C:, :].to(ev.dtype).reshape(9 * C, K * K * C).contiguous()
    b32 = bk.float().contiguous()
    check_inputs(
        "modification_fac_fused_shared", {"ev": ev, "ff": ff, "wke": wke, "wkf": wkf}, ev.dtype
    )
    check_inputs("modification_fac_fused_shared", {"bk": b32}, torch.float32)
    scratch = torch.empty((B, H, W, K * K * C), dtype=ev.dtype, device=ev.device)
    out = torch.empty_like(ev)
    lib = load_library()
    err = lib.ebfi_mod_fac_shared(
        ev.data_ptr(), ff.data_ptr(), wke.data_ptr(), wkf.data_ptr(), b32.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), B, N, H, W, C, K,
        DTYPE_CODES[ev.dtype], stream_handle(ev.device),
    )
    check(lib, err, "ebfi_mod_fac_shared")
    modification_fac_fused_shared.launches += 1
    return out


modification_fac_fused.launches = 0
modification_fac_fused_shared.launches = 0
