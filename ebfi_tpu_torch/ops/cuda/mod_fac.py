"""Kernels B3 and B2: kernel-bank prediction fused with the FAC apply.

B3 replaces ``ebfi_tpu/ops/pallas/mod_fac.py::_kernel`` (public
``modification_fac_fused``); B2 replaces ``::_kernel_shared`` (public
``modification_fac_fused_shared``, and with ``packed_rows2`` the rows2-packed
store of ``modification_fac_fused_shared_packed``, B2p).

Bound on the H100: operations.  The 3x3 bank conv (depth 9*2C = 1152 into
K*K*C = 1600 channels) is hundreds of flops per byte.  Both kernels keep
the TPU kernels' one idea, that the bank never reaches device memory, and
route by dtype:

- bf16 (serving): ``csrc/mod_fac_wgmma.cu``, the bank conv as an implicit
  GEMM on the tensor cores (wgmma), weights packed here by
  :func:`pack_bank_weight` into swizzled 64x64 tiles and streamed through a
  shared-memory ring, epilogue (bias or ff half, leaky ReLU, FAC) in
  registers.  B2 computes the ff half plus bias once per frame into a
  tap-major bf16 scratch (the TPU kernel's band scratch rounds it the same
  way), then two timestamps per block share every weight tile.
- f32: ``csrc/mod_fac.cu``, the same fusion on the CUDA cores in f32 (the
  card-versus-CPU f32 checks need f32 products; TF32 would not keep them).

A bf16 CUDA call the tensor-core kernel cannot take (C != 64, K > 5,
data not 16-byte aligned) raises; nothing falls back to another route.

Training: the TPU kernels have no backward kernels; their ``custom_vjp``s
recompute through the XLA twins.  Here ``torch.autograd.Function``s do the
same through the plain versions, on CUDA and CPU tensors alike; calls that
record no autograd go straight to the forward and save nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernel_conv2d import kernel_conv2d
from ._common import check_inputs, needs_grad, plain_vjp, stream_handle
from .build import check, load_library

KERNEL_CHANNELS = 64  # the CUDA kernels' channel tile: C must equal it
WGMMA_MAX_K = 5  # the bf16 kernel's halo border (2) covers a 5x5 FAC at most
TILE = 64  # packed weight tiles are TILE x TILE (output x input channels)


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


def mod_fac_shared_plain(ev, ff, wk, bk, kernel_size: int = 5,
                         packed_rows2: bool = False) -> torch.Tensor:
    """Plain version of B2 (port of ``mod_fac.py::_xla_twin_shared``): the
    bank conv split by input halves, the ff half at batch B repeated over
    each frame's N timestamps (ev at batch B*N).  packed_rows2 returns the
    result rows2-packed (see :func:`modification_fac_fused_shared`)."""
    _check_rows2(ev.shape[1], packed_rows2)
    BN, B, C = ev.shape[0], ff.shape[0], ff.shape[-1]
    bank_ff = _conv3x3(ff, wk[:, :, C:, :]).repeat_interleave(BN // B, dim=0)
    bank = _conv3x3(ev, wk[:, :, :C, :]) + bank_ff
    bank = F.leaky_relu(bank + bk.to(bank.dtype), 0.01).to(ev.dtype)
    out = kernel_conv2d(ev, bank, kernel_size, layout="tap_major")
    if not packed_rows2:
        return out
    H, W = out.shape[1:3]
    return out.view(BN, H // 2, 2, W, C).permute(0, 1, 3, 2, 4).reshape(BN, H // 2, W, 2 * C)


def _check_rows2(H: int, packed_rows2: bool) -> None:
    if packed_rows2 and H % 2:
        raise ValueError(f"packed_rows2 requires an even H, got H={H}")


def pack_bank_weight(wk: torch.Tensor) -> torch.Tensor:
    """Pack an HWIO bank-conv weight (3, 3, Cin, K*K*64), Cin a multiple of
    64, into the bf16 kernel's tiles: (K*K, 9*Cin/64, 64, 64), tap t of the
    bank major, then chunk kc = half*9 + (dy*3 + dx) for input channels
    [64*half, 64*half + 64) at 3x3 offset (dy, dx).  Tile element (n, k)
    (bank channel n of the tap, input channel k of the chunk) sits at flat
    offset n*64 + ((k // 8) ^ (n % 8))*8 + k % 8: rows of 64 inputs (128
    bytes in bf16) whose 16-byte chunks are XOR-swizzled by the row, the
    128-byte swizzle wgmma reads for a K-major B operand."""
    cin, kkc = wk.shape[2], wk.shape[3]
    nh, kk = cin // TILE, kkc // TILE
    w = wk.reshape(9, nh, TILE, kk, TILE)  # (tap9, half, k, t, n)
    w = w.permute(3, 1, 0, 4, 2).reshape(kk, nh * 9, TILE, TILE // 8, 8)  # (t, kc, n, k/8, k%8)
    return _swizzle(w).reshape(kk, nh * 9, TILE, TILE)


def unpack_bank_weight(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bank_weight`: back to HWIO (3, 3, Cin, K*K*64)."""
    kk, nkc = packed.shape[:2]
    nh = nkc // 9
    w = _swizzle(packed.reshape(kk, nkc, TILE, TILE // 8, 8)).reshape(kk, nh, 9, TILE, TILE)
    return w.permute(2, 1, 4, 0, 3).reshape(3, 3, nh * TILE, kk * TILE)


def _swizzle(w):
    """Chunk s of row n takes chunk s ^ (n % 8): its own inverse."""
    n = torch.arange(TILE, device=w.device)[:, None]
    idx = (torch.arange(TILE // 8, device=w.device)[None, :] ^ (n % 8))[:, :, None]
    return torch.gather(w, -2, idx.expand(*w.shape[:-3], TILE, TILE // 8, 8))


def cuda_kernel_takes(C: int, K: int, dtype: torch.dtype, device) -> bool:
    """Whether B2/B3 take a call with C channels, kernel_size K and tensors
    of this dtype on this device.  The plain versions (CPU tensors) take
    every C and K; the CUDA kernels take C = 64, odd K, f32 or bf16, and
    in bf16 K <= 5.  Callers that must not raise gate on this."""
    if torch.device(device).type != "cuda":
        return True
    if C != KERNEL_CHANNELS or K % 2 != 1:
        return False
    if dtype == torch.bfloat16:
        return K <= WGMMA_MAX_K
    return dtype == torch.float32


def _check_weights(what, C, K, wk, bk):
    if C != KERNEL_CHANNELS:
        raise ValueError(f"{what}: the CUDA kernel takes C={KERNEL_CHANNELS} channels, got {C}")
    if K % 2 != 1:
        raise ValueError(f"{what}: kernel_size must be odd")
    if tuple(wk.shape) != (3, 3, 2 * C, K * K * C) or tuple(bk.shape) != (K * K * C,):
        raise ValueError(
            f"{what}: weight {tuple(wk.shape)} / bias {tuple(bk.shape)} do not match C={C}, K={K}"
        )


def _route(what, dtype, K) -> str:
    """The kernel route of a CUDA call whose weights passed
    :func:`_check_weights`: the tensor-core kernel for bf16, the CUDA-core
    kernel for f32.  Raises for what neither takes."""
    if dtype == torch.bfloat16:
        if K > WGMMA_MAX_K:
            raise ValueError(
                f"{what}: the bf16 kernel takes kernel_size <= {WGMMA_MAX_K}, got {K}"
            )
        return "wgmma_bf16"
    if dtype == torch.float32:
        return "simt_f32"
    raise TypeError(f"{what}: dtype {dtype} not supported (float32 or bfloat16)")


def _count(fn, route, packed=False):
    fn.launches += 1
    fn.launches_by_route[route] += 1
    fn.launches_packed += packed


def _launch_fused(ev, ff, wk, bk, kernel_size: int) -> torch.Tensor:
    """One launch of B3 on CUDA tensors; no autograd."""
    what = "modification_fac_fused"
    K = kernel_size
    B, H, W, C = ev.shape
    _check_weights(what, C, K, wk, bk)
    route = _route(what, ev.dtype, K)
    if tuple(ff.shape) != tuple(ev.shape):
        raise ValueError(f"ff shape {tuple(ff.shape)} != ev shape {tuple(ev.shape)}")
    b32 = bk.float().contiguous()
    out = torch.empty_like(ev)
    lib = load_library()
    if route == "wgmma_bf16":
        wp = pack_bank_weight(wk.to(ev.dtype))
        check_inputs(what, {"ev": ev, "ff": ff, "wk": wp}, ev.dtype)
        check_inputs(what, {"bk": b32}, torch.float32)
        err = lib.ebfi_mod_fac_fused_wgmma(
            ev.data_ptr(), ff.data_ptr(), wp.data_ptr(), b32.data_ptr(), out.data_ptr(),
            B, H, W, C, K, stream_handle(ev.device),
        )
        check(lib, err, "ebfi_mod_fac_fused_wgmma")
    else:
        w2 = wk.to(ev.dtype).reshape(9 * 2 * C, K * K * C).contiguous()
        check_inputs(what, {"ev": ev, "ff": ff, "wk": w2}, ev.dtype)
        check_inputs(what, {"bk": b32}, torch.float32)
        err = lib.ebfi_mod_fac_fused(
            ev.data_ptr(), ff.data_ptr(), w2.data_ptr(), b32.data_ptr(), out.data_ptr(),
            B, H, W, C, K, stream_handle(ev.device),
        )
        check(lib, err, "ebfi_mod_fac_fused")
    _count(modification_fac_fused, route)
    return out


def _run_fused(ev, ff, wk, bk, kernel_size: int) -> torch.Tensor:
    """B3's forward without autograd: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if ev.device.type == "cpu":
        return mod_fac_plain(ev, ff, wk, bk, kernel_size)
    return _launch_fused(ev, ff, wk, bk, kernel_size)


class _ModFacFunction(torch.autograd.Function):
    """B3 with a backward through :func:`mod_fac_plain`, as the JAX
    ``custom_vjp`` of ``modification_fac_fused`` recomputes through its
    XLA twin (``mod_fac.py:447-461``)."""

    @staticmethod
    def forward(ctx, ev, ff, wk, bk, kernel_size):
        ctx.kernel_size = kernel_size
        ctx.save_for_backward(ev, ff, wk, bk)
        return _run_fused(ev, ff, wk, bk, kernel_size)

    @staticmethod
    def backward(ctx, grad_out):
        K = ctx.kernel_size
        grads = plain_vjp(lambda *a: mod_fac_plain(*a, K), ctx.saved_tensors,
                          ctx.needs_input_grad[:4], grad_out, "ebfi::mod_fac_backward_plain")
        return (*grads, None)


def modification_fac_fused(ev, ff, wk, bk, kernel_size: int = 5) -> torch.Tensor:
    """lrelu(conv3x3(concat(ev, ff)) + bk) bank, FAC-applied to ev, with the
    bank kept on chip.  ev, ff (B, H, W, C); wk (3, 3, 2C, K*K*C) HWIO with
    tap-major output channels; bk (K*K*C,).  CUDA tensors launch B3 (the
    tensor-core kernel in bf16, the CUDA-core kernel in f32); CPU tensors
    run :func:`mod_fac_plain`.  Where autograd records, the gradients of
    all four inputs recompute through :func:`mod_fac_plain`."""
    if needs_grad(ev, ff, wk, bk):
        return _ModFacFunction.apply(ev, ff, wk, bk, kernel_size)
    return _run_fused(ev, ff, wk, bk, kernel_size)


def _launch_shared(ev, ff, wk, bk, kernel_size: int, packed_rows2: bool) -> torch.Tensor:
    """One launch of B2 (B2p with packed_rows2) on CUDA tensors; no autograd."""
    what = "modification_fac_fused_shared"
    K = kernel_size
    BN, H, W, C = ev.shape
    B = ff.shape[0]
    _check_weights(what, C, K, wk, bk)
    route = _route(what, ev.dtype, K)
    _check_rows2(H, packed_rows2)
    if tuple(ff.shape[1:]) != (H, W, C) or B == 0 or BN % B:
        raise ValueError(f"ff shape {tuple(ff.shape)} does not divide ev shape {tuple(ev.shape)}")
    N = BN // B
    b32 = bk.float().contiguous()
    shape = (BN, H // 2, W, 2 * C) if packed_rows2 else (BN, H, W, C)
    out = torch.empty(shape, dtype=ev.dtype, device=ev.device)
    lib = load_library()
    if route == "wgmma_bf16":
        wpe = pack_bank_weight(wk[:, :, :C, :].to(ev.dtype))
        wpf = pack_bank_weight(wk[:, :, C:, :].to(ev.dtype))
        # the ff half plus bias, tap-major so a tap's slice of a row is contiguous
        scratch = torch.empty((B, K * K, H, W, C), dtype=ev.dtype, device=ev.device)
        tensors = {"ev": ev, "ff": ff, "wke": wpe, "wkf": wpf}
        check_inputs(what, tensors, ev.dtype)
        check_inputs(what, {"bk": b32}, torch.float32)
        err = lib.ebfi_mod_fac_shared_wgmma(
            ev.data_ptr(), ff.data_ptr(), wpe.data_ptr(), wpf.data_ptr(), b32.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), B, N, H, W, C, K, int(packed_rows2),
            stream_handle(ev.device),
        )
        check(lib, err, "ebfi_mod_fac_shared_wgmma")
    else:
        wke = wk[:, :, :C, :].to(ev.dtype).reshape(9 * C, K * K * C).contiguous()
        wkf = wk[:, :, C:, :].to(ev.dtype).reshape(9 * C, K * K * C).contiguous()
        check_inputs(what, {"ev": ev, "ff": ff, "wke": wke, "wkf": wkf}, ev.dtype)
        check_inputs(what, {"bk": b32}, torch.float32)
        scratch = torch.empty((B, H, W, K * K * C), dtype=ev.dtype, device=ev.device)
        err = lib.ebfi_mod_fac_shared(
            ev.data_ptr(), ff.data_ptr(), wke.data_ptr(), wkf.data_ptr(), b32.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), B, N, H, W, C, K, int(packed_rows2),
            stream_handle(ev.device),
        )
        check(lib, err, "ebfi_mod_fac_shared")
    _count(modification_fac_fused_shared, route, packed_rows2)
    return out


def _run_shared(ev, ff, wk, bk, kernel_size: int, packed_rows2: bool) -> torch.Tensor:
    """B2's forward without autograd: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if ev.device.type == "cpu":
        return mod_fac_shared_plain(ev, ff, wk, bk, kernel_size, packed_rows2)
    return _launch_shared(ev, ff, wk, bk, kernel_size, packed_rows2)


class _ModFacSharedFunction(torch.autograd.Function):
    """B2 and B2p with a backward through :func:`mod_fac_shared_plain`, as
    the JAX ``custom_vjp``s of ``modification_fac_fused_shared`` and
    ``_shared_packed`` recompute through the split XLA twin, with the rows2
    pack for B2p (``mod_fac.py:384-389``, ``:419-425``).  Like the JAX
    backward, it ignores the forward's rounding of the ff half plus bias
    to the input dtype."""

    @staticmethod
    def forward(ctx, ev, ff, wk, bk, kernel_size, packed_rows2):
        ctx.kernel_size, ctx.packed_rows2 = kernel_size, packed_rows2
        ctx.save_for_backward(ev, ff, wk, bk)
        return _run_shared(ev, ff, wk, bk, kernel_size, packed_rows2)

    @staticmethod
    def backward(ctx, grad_out):
        K, packed = ctx.kernel_size, ctx.packed_rows2
        grads = plain_vjp(lambda *a: mod_fac_shared_plain(*a, K, packed), ctx.saved_tensors,
                          ctx.needs_input_grad[:4], grad_out,
                          "ebfi::mod_fac_shared_backward_plain")
        return (*grads, None, None)


def modification_fac_fused_shared(ev, ff, wk, bk, kernel_size: int = 5,
                                  packed_rows2: bool = False) -> torch.Tensor:
    """The fused bank + FAC for N timestamps sharing one frame: ev
    (B*N, H, W, C) b-major, ff (B, H, W, C).  The ff half of the bank conv
    plus bias is computed once per frame and rounded to the input dtype.
    packed_rows2 (H even) stores the same values rows2-packed, (B*N, H/2,
    W, 2C): image row 2r in channels [0, C) of packed row r, row 2r + 1 in
    [C, 2C) (``modification_fac_fused_shared_packed`` of the JAX package).
    CUDA tensors launch B2 (tensor cores in bf16, CUDA cores in f32); CPU
    tensors run :func:`mod_fac_shared_plain`.  Where autograd records, the
    gradients recompute through :func:`mod_fac_shared_plain`."""
    if needs_grad(ev, ff, wk, bk):
        return _ModFacSharedFunction.apply(ev, ff, wk, bk, kernel_size, packed_rows2)
    return _run_shared(ev, ff, wk, bk, kernel_size, packed_rows2)


for _fn in (modification_fac_fused, modification_fac_fused_shared):
    _fn.launches = 0
    _fn.launches_by_route = {"wgmma_bf16": 0, "simt_f32": 0}
    _fn.launches_packed = 0  # of those, with the rows2-packed store (B2p)
