"""Kernels B3 and B2: kernel-bank prediction fused with the FAC apply.

B3 replaces ``ebfi_tpu/ops/pallas/mod_fac.py::_kernel`` (public
``modification_fac_fused``); B2 replaces ``::_kernel_shared`` (public
``modification_fac_fused_shared``, and with ``packed_rows2`` the rows2-packed
store of ``modification_fac_fused_shared_packed``, B2p).

Bound on the H100: operations.  The 3x3 bank conv (depth 9*2C = 1152 into
K*K*C = 1600 channels) is hundreds of flops per byte, so both kernels run
it as an implicit GEMM on the tensor cores, keep the TPU kernels' one idea
(the bank never reaches device memory), and route by dtype:

- bf16 (serving): ``csrc/mod_fac_wgmma.cu``, wgmma with both operands in
  shared memory, weights packed here by :func:`pack_bank_weight` into
  swizzled 64x64 tiles and streamed through a shared-memory ring,
  epilogue (bias or ff half, leaky ReLU, FAC) in registers.  B2 computes
  the ff half plus bias once per frame into a tap-major bf16 scratch (the
  TPU kernel's band scratch rounds it the same way), then two timestamps
  per block share every weight tile.
- f32: ``csrc/mod_fac.cu``, the same design on TF32 wgmma as 3xTF32: every
  product a*b is taken as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with x_hi =
  tf32(x), x_lo = tf32(x - x_hi) (``cvt.rna.tf32.f32``), which keeps
  f32-grade products (TF32 alone keeps about three decimal digits) at a
  third of the TF32 rate, 165 TFLOP/s.  The tensor cores' f32 sums
  truncate, so each 64-deep chunk is summed on them alone and its partial
  sum is added, rounded to nearest, into an accumulator in registers.  The
  weights are packed here in f32 by :func:`pack_bank_weight_tf32` (two
  taps per 128-wide tile) and split on chip; the activations are split in
  registers (A of the register-A wgmma).  The B2 scratch stays f32, the
  input dtype.

Both routes take C = 64 and odd K <= 5 (the halo's border of 2 covers a
5x5 FAC).  A CUDA call either takes its route or raises: nothing falls
back to another route.

The kernels are the custom ops ``ebfi::mod_fac`` (B3) and
``ebfi::mod_fac_shared`` (B2, B2p), so ``torch.export`` records each as
one node with the raw weights as its inputs (the packing runs inside the
op): their implementations launch the kernel for CUDA tensors and run the
plain version for CPU tensors, their fake implementations give the output
shapes (B2p's rows2-packed one included) and, traced for the card, raise
where the launch would, and their autograd formulas
recompute through the plain versions, as the TPU kernels' ``custom_vjp``s
recompute through the XLA twins (the JAX package has no backward
kernels).  A call that records no autograd saves nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernel_conv2d import kernel_conv2d
from ._common import check_inputs, define_op, on_device, stream_handle
from .build import check, load_library

KERNEL_CHANNELS = 64  # the CUDA kernels' channel tile: C must equal it
MAX_K = 5  # both kernels' halo border (2) covers a 5x5 FAC at most
TILE = 64  # packed weight tiles are TILE x TILE (output x input channels)
STEP = 8  # depth of one TF32 wgmma step (32 bytes, as bf16's k16)


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


def _tf32_order(cin: int) -> torch.Tensor:
    """Input channel of each logical depth index of the f32 kernel: within
    a k8 step, logical k takes channel 2*(k%4) + k//4, so that the two
    values of a register-A fragment row (k = l%4 and l%4 + 4) are adjacent
    channels, one 8-byte load."""
    k = torch.arange(cin)
    return (k // STEP) * STEP + 2 * (k % 4) + (k % STEP) // 4


def pack_bank_weight_tf32(wk: torch.Tensor) -> torch.Tensor:
    """Pack an HWIO bank-conv weight (3, 3, Cin, K*K*64), Cin a multiple of
    64, into the f32 kernel's step tiles: (ceil(K*K/2), 9*Cin/64, 8, 1024)
    f32.  Tap pair p (taps 2p and 2p+1, the last one zero for an odd K*K)
    is major, then chunk kc = half*9 + (dy*3 + dx) for input channels
    [64*half, 64*half + 64) at 3x3 offset (dy, dx), then the k8 step s
    (channels 8s .. 8s+7 of the chunk).  Element (n, cc) of a step (n < 64:
    bank channel n of tap 2p, else n - 64 of tap 2p+1; cc: channel of the
    step's 8) sits at offset ((n // 8)*2 + cc % 2)*32 + (n % 8)*4 + cc // 2:
    8x4 core matrices of 128 contiguous bytes, two along the depth (LBO
    128 bytes) and sixteen along n (SBO 256 bytes), the no-swizzle K-major
    layout wgmma reads for B, in the logical depth order of
    :func:`_tf32_order`.  The values stay f32: the kernel splits them into
    TF32 hi and lo on chip."""
    cin, kkc = wk.shape[2], wk.shape[3]
    nh, pairs = cin // TILE, (kkc // TILE + 1) // 2
    w = F.pad(wk.float(), (0, 2 * pairs * TILE - kkc))
    # (tap9, half, s, cc//2, cc%2, pair, n//8, n%8)
    w = w.reshape(9, nh, TILE // STEP, 4, 2, pairs, 2 * TILE // STEP, STEP)
    w = w.permute(5, 1, 0, 2, 6, 4, 7, 3)  # (pair, half, tap9, s, n//8, cc%2, n%8, cc//2)
    return w.reshape(pairs, nh * 9, TILE // STEP, 2 * TILE * STEP).contiguous()


def unpack_bank_weight_tf32(packed: torch.Tensor, taps: int) -> torch.Tensor:
    """Inverse of :func:`pack_bank_weight_tf32` for a bank of ``taps``
    taps: back to HWIO (3, 3, Cin, taps*64)."""
    pairs, nkc = packed.shape[:2]
    nh = nkc // 9
    w = packed.reshape(pairs, nh, 9, TILE // STEP, 2 * TILE // STEP, 2, STEP, 4)
    w = w.permute(2, 1, 3, 7, 5, 0, 4, 6)  # (tap9, half, s, cc//2, cc%2, pair, n//8, n%8)
    return w.reshape(3, 3, nh * TILE, 2 * pairs * TILE)[..., :taps * TILE]


def cuda_kernel_takes(C: int, K: int, dtype: torch.dtype, device) -> bool:
    """Whether B2/B3 take a call with C channels, kernel_size K and tensors
    of this dtype on this device.  The plain versions (CPU tensors) take
    every C and K; the CUDA kernels take C = 64, odd K <= 5, f32 or bf16.
    Callers that must not raise gate on this."""
    if torch.device(device).type != "cuda":
        return True
    if C != KERNEL_CHANNELS or K % 2 != 1 or K > MAX_K:
        return False
    return dtype in (torch.bfloat16, torch.float32)


def _check_weights(what, C, K, wk, bk):
    if C != KERNEL_CHANNELS:
        raise ValueError(f"{what}: the CUDA kernel takes C={KERNEL_CHANNELS} channels, got {C}")
    if K % 2 != 1:
        raise ValueError(f"{what}: kernel_size must be odd")
    if tuple(wk.shape) != (3, 3, 2 * C, K * K * C) or tuple(bk.shape) != (K * K * C,):
        raise ValueError(
            f"{what}: weight {tuple(wk.shape)} / bias {tuple(bk.shape)} do not match C={C}, K={K}"
        )


# dtype -> route; route -> (C entry point of B3, of B2)
ROUTES = {torch.bfloat16: "wgmma_bf16", torch.float32: "wgmma_3xtf32"}
_ENTRIES = {
    "wgmma_bf16": ("ebfi_mod_fac_fused_wgmma", "ebfi_mod_fac_shared_wgmma"),
    "wgmma_3xtf32": ("ebfi_mod_fac_fused", "ebfi_mod_fac_shared"),
}


def _pack(route, wk):
    """The route's weight tiles (its packer looked up when called)."""
    return pack_bank_weight(wk) if route == "wgmma_bf16" else pack_bank_weight_tf32(wk)


def _route(what, dtype, K) -> str:
    """The kernel route of a CUDA call whose weights passed
    :func:`_check_weights`: the bf16 tensor-core kernel, or the 3xTF32
    tensor-core kernel for f32.  Raises for what neither takes."""
    if dtype not in ROUTES:
        raise TypeError(f"{what}: dtype {dtype} not supported (float32 or bfloat16)")
    if K > MAX_K:
        raise ValueError(f"{what}: the CUDA kernels take kernel_size <= {MAX_K}, got {K}")
    return ROUTES[dtype]


def _count(fn, route, packed=False):
    fn.launches += 1
    fn.launches_by_route[route] += 1
    fn.launches_packed += packed


def _check_fused(ev, ff, wk, bk, K) -> str:
    """B3's route for these arguments; raises for a call it does not take."""
    what = "modification_fac_fused"
    _check_weights(what, ev.shape[-1], K, wk, bk)
    route = _route(what, ev.dtype, K)
    if tuple(ff.shape) != tuple(ev.shape):
        raise ValueError(f"ff shape {tuple(ff.shape)} != ev shape {tuple(ev.shape)}")
    return route


def _launch_fused(ev, ff, wk, bk, kernel_size: int) -> torch.Tensor:
    """One launch of B3 on CUDA tensors; no autograd."""
    what = "modification_fac_fused"
    K = kernel_size
    B, H, W, C = ev.shape
    route = _check_fused(ev, ff, wk, bk, K)
    b32 = bk.float().contiguous()
    out = torch.empty_like(ev)
    entry = _ENTRIES[route][0]
    lib = load_library()
    with on_device(ev.device):  # the weight pack and the launch
        wp = _pack(route, wk.to(ev.dtype))
        check_inputs(what, {"ev": ev, "ff": ff, "wk": wp}, ev.dtype)
        check_inputs(what, {"bk": b32}, torch.float32)
        err = getattr(lib, entry)(
            ev.data_ptr(), ff.data_ptr(), wp.data_ptr(), b32.data_ptr(), out.data_ptr(),
            B, H, W, C, K, stream_handle(ev.device),
        )
        check(lib, err, entry)
    _count(modification_fac_fused, route)
    return out


def _run_fused(ev, ff, wk, bk, kernel_size: int) -> torch.Tensor:
    """B3's forward without autograd: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if ev.device.type == "cpu":
        return mod_fac_plain(ev, ff, wk, bk, kernel_size)
    return _launch_fused(ev, ff, wk, bk, kernel_size)


def _fused_impl(ev, ff, wk, bk, kernel_size):
    return _run_fused(ev.contiguous(), ff.contiguous(), wk, bk, kernel_size)


def _fused_fake(ev, ff, wk, bk, kernel_size):
    if ev.device.type != "cpu":  # traced for the card: raise where the launch would
        _check_fused(ev, ff, wk, bk, kernel_size)
    return ev.new_empty(ev.shape)


# the backward: modification_fac_fused's custom_vjp's (mod_fac.py:447-461)
_mod_fac_op = define_op(
    "mod_fac(Tensor ev, Tensor ff, Tensor wk, Tensor bk, int kernel_size) -> Tensor",
    _fused_impl, _fused_fake, mod_fac_plain, 4, "ebfi::mod_fac_backward_plain")


def modification_fac_fused(ev, ff, wk, bk, kernel_size: int = 5) -> torch.Tensor:
    """lrelu(conv3x3(concat(ev, ff)) + bk) bank, FAC-applied to ev, with the
    bank kept on chip.  ev, ff (B, H, W, C); wk (3, 3, 2C, K*K*C) HWIO with
    tap-major output channels; bk (K*K*C,).  Through ``ebfi::mod_fac``:
    CUDA tensors launch B3 (on the tensor cores: bf16, or f32 as 3xTF32);
    CPU tensors run :func:`mod_fac_plain`.  Where autograd records, the
    gradients of all four inputs recompute through :func:`mod_fac_plain`."""
    return _mod_fac_op(ev, ff, wk, bk, kernel_size)


def _check_shared(ev, ff, wk, bk, K, packed_rows2) -> str:
    """B2's route for these arguments; raises for a call it does not take."""
    what = "modification_fac_fused_shared"
    BN, H, W, C = ev.shape
    B = ff.shape[0]
    _check_weights(what, C, K, wk, bk)
    route = _route(what, ev.dtype, K)
    _check_rows2(H, packed_rows2)
    if tuple(ff.shape[1:]) != (H, W, C) or B == 0 or BN % B:
        raise ValueError(f"ff shape {tuple(ff.shape)} does not divide ev shape {tuple(ev.shape)}")
    return route


def _launch_shared(ev, ff, wk, bk, kernel_size: int, packed_rows2: bool) -> torch.Tensor:
    """One launch of B2 (B2p with packed_rows2) on CUDA tensors; no autograd."""
    what = "modification_fac_fused_shared"
    K = kernel_size
    BN, H, W, C = ev.shape
    B = ff.shape[0]
    route = _check_shared(ev, ff, wk, bk, K, packed_rows2)
    N = BN // B
    b32 = bk.float().contiguous()
    shape = (BN, H // 2, W, 2 * C) if packed_rows2 else (BN, H, W, C)
    out = torch.empty(shape, dtype=ev.dtype, device=ev.device)
    entry = _ENTRIES[route][1]
    lib = load_library()
    with on_device(ev.device):  # the weight packs and the launch
        wpe = _pack(route, wk[:, :, :C, :].to(ev.dtype))
        wpf = _pack(route, wk[:, :, C:, :].to(ev.dtype))
        # the ff half plus bias, tap-major so a tap's slice of a row is contiguous
        scratch = torch.empty((B, K * K, H, W, C), dtype=ev.dtype, device=ev.device)
        check_inputs(what, {"ev": ev, "ff": ff, "wke": wpe, "wkf": wpf}, ev.dtype)
        check_inputs(what, {"bk": b32}, torch.float32)
        err = getattr(lib, entry)(
            ev.data_ptr(), ff.data_ptr(), wpe.data_ptr(), wpf.data_ptr(), b32.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), B, N, H, W, C, K, int(packed_rows2),
            stream_handle(ev.device),
        )
        check(lib, err, entry)
    _count(modification_fac_fused_shared, route, packed_rows2)
    return out


def _run_shared(ev, ff, wk, bk, kernel_size: int, packed_rows2: bool) -> torch.Tensor:
    """B2's forward without autograd: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if ev.device.type == "cpu":
        return mod_fac_shared_plain(ev, ff, wk, bk, kernel_size, packed_rows2)
    return _launch_shared(ev, ff, wk, bk, kernel_size, packed_rows2)


def _shared_impl(ev, ff, wk, bk, kernel_size, packed_rows2):
    return _run_shared(ev.contiguous(), ff.contiguous(), wk, bk, kernel_size, packed_rows2)


def _shared_fake(ev, ff, wk, bk, kernel_size, packed_rows2):
    if ev.device.type != "cpu":  # traced for the card: raise where the launch would
        _check_shared(ev, ff, wk, bk, kernel_size, packed_rows2)
    BN, H, W, C = ev.shape
    return ev.new_empty((BN, H // 2, W, 2 * C) if packed_rows2 else (BN, H, W, C))


# the backward: the custom_vjps' of modification_fac_fused_shared and
# _shared_packed, through the split XLA twin with the rows2 pack for B2p
# (mod_fac.py:384-389, :419-425); like them, it ignores the forward's
# rounding of the ff half plus bias to the input dtype
_mod_fac_shared_op = define_op(
    "mod_fac_shared(Tensor ev, Tensor ff, Tensor wk, Tensor bk, int kernel_size, "
    "bool packed_rows2) -> Tensor",
    _shared_impl, _shared_fake, mod_fac_shared_plain, 4, "ebfi::mod_fac_shared_backward_plain")


def modification_fac_fused_shared(ev, ff, wk, bk, kernel_size: int = 5,
                                  packed_rows2: bool = False) -> torch.Tensor:
    """The fused bank + FAC for N timestamps sharing one frame: ev
    (B*N, H, W, C) b-major, ff (B, H, W, C).  The ff half of the bank conv
    plus bias is computed once per frame and rounded to the input dtype.
    packed_rows2 (H even) stores the same values rows2-packed, (B*N, H/2,
    W, 2C): image row 2r in channels [0, C) of packed row r, row 2r + 1 in
    [C, 2C) (``modification_fac_fused_shared_packed`` of the JAX package).
    Through ``ebfi::mod_fac_shared``: CUDA tensors launch B2 (tensor cores:
    bf16, or f32 as 3xTF32); CPU tensors run :func:`mod_fac_shared_plain`.
    Where autograd records, the gradients recompute through
    :func:`mod_fac_shared_plain`."""
    return _mod_fac_shared_op(ev, ff, wk, bk, kernel_size, packed_rows2)


for _fn in (modification_fac_fused, modification_fac_fused_shared):
    _fn.launches = 0
    _fn.launches_by_route = {route: 0 for route in _ENTRIES}
    _fn.launches_packed = 0  # of those, with the rows2-packed store (B2p)
