"""The bf16 tensor-core route of kernels B2 and B3 (``csrc/mod_fac_wgmma.cu``)
on the CPU: its weight tile layout, its loop order, and its routing.

The CUDA kernel runs only on the card.  What it computes is fixed here by
an emulation in PyTorch that follows its loop order -- per bank tap, 9 (or
18) 64-deep chunks, each a shifted view of the zero-padded halo times one
packed weight tile read back through the documented swizzle formula; the
ff half plus bias rounded to the input dtype (B2); leaky ReLU; FAC
accumulate from the replication-padded neighbour; timestamps two at a time
-- held against the plain versions and the JAX package's XLA twins.

Tolerance f32: rtol=1e-4, atol=1e-4 -- the emulation sums the 1152-deep
bank conv chunk by chunk and the references as one convolution, which
moves outputs of magnitude up to ~40 by a few f32 ulps (3e-5 seen).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ebfi_tpu.ops.pallas import mod_fac as jmod_fac
from ebfi_tpu_torch.ops import cuda as kern
from ebfi_tpu_torch.ops.cuda import mod_fac
from ebfi_tpu_torch.ops.cuda.mod_fac import TILE, pack_bank_weight, unpack_bank_weight

import jax.numpy as jnp

C = 64
RTOL, ATOL = 1e-4, 1e-4
GROUP = 2  # timestamps per block in the kernel's B2 mode


def swizzled_offset(n, k):
    """Flat offset of tile element (bank channel n, input channel k): the
    formula the CUDA kernel's B descriptor (128-byte swizzle) assumes."""
    return n * TILE + ((k // 8) ^ (n % 8)) * 8 + k % 8


def tile_matrix(packed, t, kc):
    """Tile (t, kc) read back as the (64 inputs, 64 bank channels) matrix."""
    k = torch.arange(TILE)[:, None]
    n = torch.arange(TILE)[None, :]
    return packed[t, kc].reshape(-1)[swizzled_offset(n, k)]


def emulate(ev, ff, wk, bk, K, shared):
    """The kernel's arithmetic in its loop order, in the inputs' dtype
    rounding where the kernel rounds (the ff half of B2)."""
    p = (K - 1) // 2
    B = ff.shape[0]
    N = ev.shape[0] // B
    H, W = ev.shape[1:3]
    f32 = lambda x: x.float()
    zpad = lambda x: F.pad(f32(x), (0, 0, 1, 1, 1, 1))  # conv halo, zero outside
    rpad = F.pad(f32(ev).permute(0, 3, 1, 2), (p, p, p, p), mode="replicate").permute(0, 2, 3, 1)
    bias = bk.float().reshape(K * K, C)
    if shared:
        halves = [zpad(ev)]
        packed = pack_bank_weight(wk[:, :, :C, :])
        packed_ff = pack_bank_weight(wk[:, :, C:, :])
        ffz = zpad(ff)
        ffbank = []
        for t in range(K * K):  # kFFHalf mode: once per frame, rounded to the dtype
            d = sum(ffz[:, dy:dy + H, dx:dx + W] @ tile_matrix(packed_ff, t, dy * 3 + dx).float()
                    for dy in range(3) for dx in range(3))
            ffbank.append((d + bias[t]).to(ev.dtype).float())
    else:
        halves = [zpad(ev), zpad(ff)]
        packed = pack_bank_weight(wk)
    out = torch.zeros(ev.shape)
    for b in range(B):
        for n0 in range(0, N, GROUP):  # one block's timestamps
            rows = slice(b * N + n0, b * N + min(n0 + GROUP, N))
            acc = torch.zeros((rows.stop - rows.start, H, W, C))
            for t in range(K * K):
                d = 0
                for kc in range(9 * len(halves)):
                    half, (dy, dx) = kc // 9, divmod(kc % 9, 3)
                    a = halves[half][rows if shared else slice(b, b + 1), dy:dy + H, dx:dx + W]
                    d = d + a @ tile_matrix(packed, t, kc).float()
                d = d + (ffbank[t][b] if shared else bias[t])
                ky, kx = divmod(t, K)
                acc += rpad[rows, ky:ky + H, kx:kx + W] * F.leaky_relu(d, 0.01)
            out[rows] = acc
    return out.to(ev.dtype)


def inputs(rng, B, N, H, W, K):
    ev = rng.standard_normal((B * N, H, W, C)).astype(np.float32)
    ff = rng.standard_normal((B, H, W, C)).astype(np.float32)
    wk = (0.05 * rng.standard_normal((3, 3, 2 * C, K * K * C))).astype(np.float32)
    bk = (0.1 * rng.standard_normal((K * K * C,))).astype(np.float32)
    return [torch.from_numpy(a) for a in (ev, ff, wk, bk)]


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ weight tiles


@pytest.mark.parametrize("cin", [C, 2 * C])
@pytest.mark.parametrize("K", [3, 5])
def test_pack_unpack_round_trip(cin, K):
    w = torch.randn(3, 3, cin, K * K * C, generator=torch.Generator().manual_seed(cin + K))
    packed = pack_bank_weight(w)
    assert packed.shape == (K * K, 9 * cin // C, TILE, TILE)
    assert torch.equal(unpack_bank_weight(packed), w)


@pytest.mark.parametrize("cin", [C, 2 * C])
def test_elements_land_where_the_swizzle_formula_says(rng, cin):
    K = 5
    w = torch.from_numpy(rng.standard_normal((3, 3, cin, K * K * C)).astype(np.float32))
    packed = pack_bank_weight(w)
    for _ in range(200):
        dy, dx, ci, co = (int(rng.integers(0, m)) for m in (3, 3, cin, K * K * C))
        t, n = divmod(co, C)
        half, k = divmod(ci, C)
        kc = half * 9 + dy * 3 + dx
        assert packed[t, kc].reshape(-1)[swizzled_offset(n, k)] == w[dy, dx, ci, co]


def test_swizzle_keeps_each_row_and_permutes_its_chunks():
    """Row n of a tile holds exactly the 64 inputs of bank channel n, its
    16-byte chunks permuted by n % 8 (the row's 1024-byte-atom phase)."""
    w = torch.arange(9 * C * C, dtype=torch.float32).reshape(3, 3, C, C)
    tile = pack_bank_weight(w)[0, 0]  # tap 0, chunk (dy, dx) = (0, 0)
    for n in range(TILE):
        chunks = tile[n].reshape(8, 8)
        for s in range(8):
            k0 = 8 * (s ^ (n % 8))
            assert torch.equal(chunks[s], w[0, 0, k0:k0 + 8, n])


# ------------------------------------------------------------------ loop order


@pytest.mark.parametrize("B,N,H,W", [(2, 3, 5, 70), (1, 4, 3, 9)])
def test_emulated_b2_matches_plain_and_xla_twin(rng, B, N, H, W):
    K = 5
    ev, ff, wk, bk = inputs(rng, B, N, H, W, K)
    got = emulate(ev, ff, wk, bk, K, shared=True)
    close(got, kern.mod_fac_shared_plain(ev, ff, wk, bk, K))
    j = [jnp.asarray(x.numpy()) for x in (ev, ff, wk, bk)]
    close(got, jmod_fac._xla_twin_shared(*j, K))


@pytest.mark.parametrize("B,H,W", [(2, 5, 70), (1, 6, 9)])
def test_emulated_b3_matches_plain_and_xla_twin(rng, B, H, W):
    K = 5
    ev, ff, wk, bk = inputs(rng, B, 1, H, W, K)
    got = emulate(ev, ff, wk, bk, K, shared=False)
    close(got, kern.mod_fac_plain(ev, ff, wk, bk, K))
    j = [jnp.asarray(x.numpy()) for x in (ev, ff, wk, bk)]
    close(got, jmod_fac._xla_twin(*j, K))


def test_emulated_b2_rounds_the_ff_half_like_the_pallas_kernel(rng):
    """In bf16 the ff half plus bias passes through a bf16 scratch in both
    the kernel and the TPU kernel: the emulation stays at bf16 rounding
    distance from the plain version evaluated in f32."""
    K = 3
    ev, ff, wk, bk = inputs(rng, 1, 3, 4, 11, K)
    got = emulate(ev.bfloat16(), ff.bfloat16(), wk.bfloat16(), bk, K, shared=True)
    ref = kern.mod_fac_shared_plain(*(x.bfloat16().float() for x in (ev, ff, wk)), bk, K)
    assert got.dtype == torch.bfloat16
    assert (got.float() - ref).abs().max().item() < 1e-2 * ref.abs().max().item()


# ------------------------------------------------------------------ routing


def test_bf16_call_with_other_channels_raises_without_a_card():
    """A bf16 tensor that is not on the CPU goes to the tensor-core kernel,
    which takes C = 64 only: the wrapper raises before any launch (meta
    tensors stand in for the card's)."""
    K = 5
    kern.reset_launch_counts()
    for fn in (kern.modification_fac_fused, kern.modification_fac_fused_shared):
        for c, k in ((32, 5), (C, 7)):
            x = torch.empty(1, 4, 4, c, dtype=torch.bfloat16, device="meta")
            wk = torch.empty(3, 3, 2 * c, k * k * c, device="meta")
            bk = torch.empty(k * k * c, device="meta")
            with pytest.raises(ValueError):
                fn(x, x, wk, bk, k)
    assert kern.launch_counts() == {"fac": 0, "mod_fac": 0, "mod_fac_shared": 0}
    mod_fac._check_weights("k", C, K, torch.zeros(3, 3, 2 * C, K * K * C), torch.zeros(K * K * C))


def test_routes_by_dtype():
    assert mod_fac._route("k", torch.bfloat16, 5) == "wgmma_bf16"
    assert mod_fac._route("k", torch.float32, 7) == "simt_f32"
    with pytest.raises(ValueError, match="kernel_size"):
        mod_fac._route("k", torch.bfloat16, 7)
    with pytest.raises(TypeError):
        mod_fac._route("k", torch.float16, 5)


def test_route_counters_reset_with_the_launch_counts():
    kern.modification_fac_fused.launches_by_route["wgmma_bf16"] = 3
    kern.modification_fac_fused_shared.launches_by_route["simt_f32"] = 2
    kern.reset_launch_counts()
    assert kern.route_counts() == {
        "mod_fac": {"wgmma_bf16": 0, "simt_f32": 0},
        "mod_fac_shared": {"wgmma_bf16": 0, "simt_f32": 0},
    }


def test_cpu_tensors_take_the_plain_version_and_count_nothing(rng):
    K = 3
    ev, ff, wk, bk = inputs(rng, 1, 2, 3, 5, K)
    kern.reset_launch_counts()
    got = kern.modification_fac_fused_shared(ev.bfloat16(), ff.bfloat16(), wk, bk, K)
    assert got.dtype == torch.bfloat16
    assert kern.route_counts()["mod_fac_shared"] == {"wgmma_bf16": 0, "simt_f32": 0}
