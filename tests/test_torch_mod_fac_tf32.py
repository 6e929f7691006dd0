"""The f32 route of kernels B2 and B3 (``csrc/mod_fac.cu``) on the CPU:
the bank conv on the tensor cores as 3xTF32.

The CUDA kernel runs only on the card.  What it computes is fixed here:
- its TF32 conversion (``cvt.rna.tf32.f32``), written out on integer views
  of the floats, against the port's ``tf32_round`` on edge values, and the
  hi/lo split it takes of every operand;
- its weight layout (``pack_bank_weight_tf32``: per tap pair, chunk and k8
  step a 128-wide no-swizzle K-major tile in the logical depth order of
  the register-A fragments, an odd last tap beside zeros), read back as
  the wgmma descriptor reads it;
- its arithmetic, by an emulation in PyTorch that follows its loop order
  -- per pair of bank taps, 9 (or 18) 64-deep chunks of 8 k8 steps, each
  step three TF32 products of split operands added to the f32
  accumulator, the two small terms first, each add truncated as the
  tensor cores' are; each chunk's sum added, rounded to nearest, into a
  second accumulator; B2's ff half plus bias into an f32 scratch; leaky
  ReLU; FAC accumulate from the replication-padded neighbour, tap by tap
  -- held against the plain versions and the JAX package's XLA twins;
  without the two small terms (TF32 alone) it lands at least 50x farther
  from the f64 plain version, and without the chunk promotion (one
  truncating accumulator over all 18 chunks, the route's first design) at
  least 5x farther.

Tolerances:
- emulation against the plain versions and the XLA twins in f32:
  rtol=1e-4, atol=1e-4, as the bf16 route's emulation holds its f32 case
  (``test_torch_mod_fac_tiles.py``): the emulation sums the 1152-deep bank
  conv step by step and the references as one convolution, and 3xTF32
  drops the lo*lo term (2^-22 relative per product);
- against the plain version in f64: the 3xTF32 emulation within 1e-4 and
  within 3x the plain version's own f32 error; TF32 alone at least 50x
  farther (TF32 keeps 2^-11 of each operand); without the promotion at
  least 5x farther (the truncation's bias grows with the number of
  truncated adds: 432 per bank value instead of 24 per chunk).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ebfi_tpu.ops.pallas import mod_fac as jmod_fac
from ebfi_tpu_torch.ops import cuda as kern
from ebfi_tpu_torch.ops.cuda import mod_fac
from ebfi_tpu_torch.ops.cuda.mod_fac import (
    STEP,
    TILE,
    pack_bank_weight_tf32,
    unpack_bank_weight_tf32,
)

import jax.numpy as jnp
import torch_threads  # noqa: F401  (one intra-op thread per test process)

C = 64
RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation is thousands of small ops: one intra-op thread each
    (beside other test processes on the same cores, more only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ TF32 conversion


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 as the f32 kernel converts (``cvt.rna.tf32.f32``), on
    int32 views: keep 10 explicit mantissa bits, round to nearest with ties
    away from zero (add half of the dropped 13 bits' range to the
    magnitude, then clear them; a carry moves into the exponent, and past
    the largest finite value into infinity).  NaN stays NaN."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x.float(), rounded)


def split_tf32(x: torch.Tensor):
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi): the two halves of
    3xTF32 (x - hi is exact in f32; hi + lo gives x back to 2^-21 of it)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def cvt_rna_tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` on uint32 views: split sign and magnitude, drop
    the magnitude's low 13 bits and add one unit of the 14th when the
    dropped part is at least half of it (ties away from zero); NaN stays
    NaN."""
    x = np.asarray(x, np.float32)
    bits = x.view(np.uint32)
    sign, mag = bits & np.uint32(0x80000000), bits & np.uint32(0x7FFFFFFF)
    up = np.where((mag & np.uint32(0x1FFF)) >= 0x1000, np.uint32(0x2000), np.uint32(0))
    out = (sign | ((mag & np.uint32(0xFFFFE000)) + up)).view(np.float32)
    return np.where(np.isnan(x), x, out)


EDGE_BITS = [
    0x00000000, 0x80000000,  # +-0
    0x3F800000,  # 1
    0x3F801000, 0xBF801000,  # 1 + 2^-11, a tie: away from zero, to 1 + 2^-10
    0x3F803000,  # 1 + 3*2^-11, a tie: to 1 + 2^-9 (away, not to even)
    0x3F800FFF, 0x3F801001,  # just below and above the tie
    0x00000001, 0x00000FFF,  # subnormals below half a unit: to 0
    0x00001000, 0x80001000,  # subnormal ties: to +-2^-136
    0x007FF000,  # the largest subnormals round up into the smallest normal
    0x7F7FEFFF, 0x7F7FF000,  # near the largest finite: down, and up into +inf
    0x7F800000, 0xFF800000,  # +-inf
    0x7FC00000, 0x7F800001,  # NaN
]


def test_tf32_round_is_the_kernels_conversion_on_edge_values(rng):
    bits = np.array(EDGE_BITS, np.uint32)
    scaled = rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)
    x = np.concatenate([bits.view(np.float32), scaled.astype(np.float32)])
    got = tf32_round(torch.from_numpy(x)).numpy()
    want = cvt_rna_tf32(x)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))
    # the named cases
    assert got[3] == np.float32(1 + 2**-10) and got[4] == -np.float32(1 + 2**-10)
    assert got[5] == np.float32(1 + 2**-9)
    assert got[12].view(np.uint32) == 0x00800000
    assert got[14] == np.inf and got[15] == np.inf and got[16] == -np.inf


def test_split_halves_have_ten_mantissa_bits_and_give_x_back(rng):
    x = torch.from_numpy((rng.standard_normal(1 << 16) * 10.0 ** rng.integers(-20, 20, 1 << 16))
                         .astype(np.float32))
    hi, lo = split_tf32(x)
    for half in (hi, lo):
        assert int((half.view(torch.int32) & 0x1FFF).abs().max()) == 0  # at most 10 mantissa bits
    assert torch.equal(hi, tf32_round(x)) and torch.equal(lo, tf32_round(x - hi))
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0**-21 * x.double().abs()).all())
    # TF32 alone keeps 2^-11 only
    assert float(((hi.double() - x.double()).abs() / x.double().abs()).max()) > 2.0**-13


# ------------------------------------------------------------------ weight tiles


def step_offset(n, cc):
    """Flat offset, within one k8 step tile, of column n (bank channel n of
    the pair's first tap, n - 64 of its second) and the step's input
    channel cc: the formula the kernel's B descriptor assumes (core
    matrices of 8 n x 4 depth, LBO 128 bytes along the depth, SBO 256
    along n; logical depth k = 4*(cc%2) + cc//2)."""
    return ((n // 8) * 2 + cc % 2) * 32 + (n % 8) * 4 + cc // 2


def b_step(packed, pair, kc, s):
    """The B operand of step s (an index or a tensor of them) of chunk kc,
    tap pair ``pair``, read as the descriptor reads it: (8 logical depth,
    128 bank channels) per step."""
    k = torch.arange(STEP)[:, None]
    n = torch.arange(2 * TILE)[None, :]
    return packed[pair, kc, s][..., (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4]


@pytest.mark.parametrize("cin", [C, 2 * C])
@pytest.mark.parametrize("K", [3, 5])
def test_pack_tf32_unpack_round_trip(cin, K):
    w = torch.randn(3, 3, cin, K * K * C, generator=torch.Generator().manual_seed(cin + K))
    packed = pack_bank_weight_tf32(w)
    pairs = (K * K + 1) // 2
    assert packed.shape == (pairs, 9 * cin // C, TILE // STEP, 2 * TILE * STEP)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert torch.equal(unpack_bank_weight_tf32(packed, K * K), w)
    assert not packed[-1, :, :, :].reshape(-1, 16, 2, 32)[:, 8:].any()  # the odd K*K's empty tap


@pytest.mark.parametrize("cin", [C, 2 * C])
def test_tf32_elements_land_where_the_layout_formula_says(rng, cin):
    K = 5
    w = torch.from_numpy(rng.standard_normal((3, 3, cin, K * K * C)).astype(np.float32))
    packed = pack_bank_weight_tf32(w)
    for _ in range(200):
        dy, dx, ci, co = (int(rng.integers(0, m)) for m in (3, 3, cin, K * K * C))
        pair, n = divmod(co, 2 * C)
        half, k = divmod(ci, C)
        s, cc = divmod(k, STEP)
        assert packed[pair, half * 9 + dy * 3 + dx, s, step_offset(n, cc)] == w[dy, dx, ci, co]


def test_descriptor_view_follows_the_fragment_depth_order():
    """Logical depth k of every step reads input channel 8s + 2*(k%4) +
    k//4 of the chunk -- the channel that register-A fragment column k
    loads from the halo -- for every bank channel."""
    K = 3
    w = torch.randn(3, 3, 2 * C, K * K * C, generator=torch.Generator().manual_seed(1))
    packed = pack_bank_weight_tf32(w)
    order = mod_fac._tf32_order(C).reshape(TILE // STEP, STEP)
    for pair, kc, s in ((0, 0, 0), (2, 13, 5), (4, 17, 7)):
        half, (dy, dx) = kc // 9, divmod(kc % 9, 3)
        want = w[dy, dx, C * half + order[s]][:, 2 * pair * C:(2 * pair + 2) * C]
        if pair == 4:  # the 9th tap beside zeros
            want = torch.cat([want, torch.zeros(STEP, C)], dim=1)
        assert torch.equal(b_step(packed, pair, kc, s), want)


# ------------------------------------------------------------------ 3xTF32 arithmetic


def toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 -> the f32 value rounded toward zero, kept in f64: clear the 29
    mantissa bits f32 lacks (exact for f32's normal range)."""
    return (x.view(torch.int64) & -(1 << 29)).view(torch.float64)


def emulate(ev, ff, wk, bk, K, shared, terms=3, promote=True):
    """The f32 kernel's arithmetic in its loop order: per pair of taps,
    each k8 step adds a_lo @ b_hi, a_hi @ b_lo, a_hi @ b_hi (terms=3) or
    a_hi @ b_hi alone (terms=1), each an exact 8-deep partial, to the f32
    accumulator rounded toward zero (the tensor cores truncate; per add
    this errs a little more than the card measured); the accumulator
    holds one 64-deep chunk and its sum is added, rounded to nearest,
    into a second one (promote=True, the kernel), or it holds them all
    (promote=False)."""
    p = (K - 1) // 2
    B = ff.shape[0]
    N = ev.shape[0] // B
    H, W = ev.shape[1:3]
    zpad = lambda x: F.pad(x, (0, 0, 1, 1, 1, 1))  # conv halo, zero outside
    rpad = F.pad(ev.permute(0, 3, 1, 2), (p, p, p, p), mode="replicate").permute(0, 2, 3, 1)
    bias = bk.reshape(K * K, C)
    order = mod_fac._tf32_order(C)

    steps = torch.arange(TILE // STEP)

    def bank_pair(halves, packed, pair):
        acc = d = torch.zeros((halves[0].shape[0], H, W, 2 * C), dtype=torch.float64)
        for kc in range(9 * len(halves)):
            half, (dy, dx) = kc // 9, divmod(kc % 9, 3)
            a = halves[half][:, dy:dy + H, dx:dx + W][..., order]
            a_hi, a_lo = (x.double() for x in split_tf32(a.reshape(*a.shape[:3], -1, STEP)))
            b_hi, b_lo = (x.double() for x in split_tf32(b_step(packed, pair, kc, steps)))
            products = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))[3 - terms:]
            # each step's exact partials (TF32 products, 8 deep, in f64)
            parts = [torch.einsum("bhwsk,skn->sbhwn", x, y) for x, y in products]
            if promote:
                d = torch.zeros_like(acc)
            for s in steps:
                for part in parts:
                    d = toward_zero(d + part[s])
            if promote:
                acc = (acc + d).float().double()  # f32 add, rounded to nearest
        return (acc if promote else d).float()

    if shared:
        packed = pack_bank_weight_tf32(wk[:, :, :C, :])
        ffz = [zpad(ff)]
        packed_ff = pack_bank_weight_tf32(wk[:, :, C:, :])
        ff_pairs = [bank_pair(ffz, packed_ff, q) for q in range((K * K + 1) // 2)]
        scratch = [ff_pairs[t // 2][..., t % 2 * C:][..., :C] + bias[t]
                   for t in range(K * K)]  # kFFHalf, f32
    else:
        packed = pack_bank_weight_tf32(wk)
    # every block computes the same per image (timestamp n of frame b at
    # batch index b*N + n): all images at once here
    halves = [zpad(ev)] if shared else [zpad(ev), zpad(ff)]
    out = torch.zeros(ev.shape)
    for t in range(K * K):
        if t % 2 == 0:
            pair = bank_pair(halves, packed, t // 2)
        d = pair[..., t % 2 * C:][..., :C]
        d = d + (scratch[t].repeat_interleave(N, dim=0) if shared else bias[t])
        ky, kx = divmod(t, K)
        out += rpad[:, ky:ky + H, kx:kx + W] * F.leaky_relu(d, 0.01)
    return out


def inputs(rng, B, N, H, W, K):
    ev = rng.standard_normal((B * N, H, W, C)).astype(np.float32)
    ff = rng.standard_normal((B, H, W, C)).astype(np.float32)
    wk = (0.05 * rng.standard_normal((3, 3, 2 * C, K * K * C))).astype(np.float32)
    bk = (0.1 * rng.standard_normal((K * K * C,))).astype(np.float32)
    return [torch.from_numpy(a) for a in (ev, ff, wk, bk)]


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def check_terms(emu, plain, args, K):
    """3xTF32 within 1e-4 of the f64 plain version; TF32 alone >= 50x farther."""
    ref = plain(*(a.double() for a in args), K)
    err3 = (emulate(*args, K, **emu, terms=3).double() - ref).abs().max().item()
    err1 = (emulate(*args, K, **emu, terms=1).double() - ref).abs().max().item()
    assert err3 <= 1e-4
    assert err1 >= 50 * err3, (err1, err3)


@pytest.mark.parametrize("B,H,W,K", [(2, 5, 70, 5), (1, 6, 9, 3)])
def test_emulated_3xtf32_b3_matches_plain_and_xla_twin(rng, B, H, W, K):
    ev, ff, wk, bk = inputs(rng, B, 1, H, W, K)
    got = emulate(ev, ff, wk, bk, K, shared=False)
    close(got, kern.mod_fac_plain(ev, ff, wk, bk, K))
    j = [jnp.asarray(x.numpy()) for x in (ev, ff, wk, bk)]
    close(got, jmod_fac._xla_twin(*j, K))


@pytest.mark.parametrize("B,N,H,W,K", [(2, 3, 5, 70, 5), (1, 4, 3, 9, 3)])
def test_emulated_3xtf32_b2_matches_plain_and_xla_twin(rng, B, N, H, W, K):
    ev, ff, wk, bk = inputs(rng, B, N, H, W, K)
    got = emulate(ev, ff, wk, bk, K, shared=True)
    close(got, kern.mod_fac_shared_plain(ev, ff, wk, bk, K))
    j = [jnp.asarray(x.numpy()) for x in (ev, ff, wk, bk)]
    close(got, jmod_fac._xla_twin_shared(*j, K))


@pytest.mark.parametrize("shared", [False, True])
def test_dropping_the_small_terms_lands_farther_from_plain(rng, shared):
    """TF32 alone (a_hi @ b_hi) against 3xTF32: a dropped lo term shows."""
    K = 3
    args = inputs(rng, 1, 2 if shared else 1, 4, 11, K)
    plain = kern.mod_fac_shared_plain if shared else kern.mod_fac_plain
    check_terms({"shared": shared}, plain, args, K)


@pytest.mark.parametrize("shared", [False, True])
def test_truncating_sums_need_the_chunk_promotion(rng, shared):
    """With truncating adds, one accumulator over all chunks lands >= 5x
    farther from the f64 plain version than the kernel's per-chunk
    promotion, which stays within 3x of the f32 plain version's error."""
    K = 3
    args = inputs(rng, 1, 2 if shared else 1, 4, 11, K)
    plain = kern.mod_fac_shared_plain if shared else kern.mod_fac_plain
    ref = plain(*(a.double() for a in args), K)
    err = lambda x: (x.double() - ref).abs().max().item()
    promoted = err(emulate(*args, K, shared=shared))
    one_accumulator = err(emulate(*args, K, shared=shared, promote=False))
    assert promoted <= 3 * err(plain(*args, K))
    assert one_accumulator >= 5 * promoted, (one_accumulator, promoted)


# ------------------------------------------------------------------ routing


def test_f32_routes_to_3xtf32_and_k_is_bounded():
    assert mod_fac._route("k", torch.float32, 5) == "wgmma_3xtf32"
    assert mod_fac._route("k", torch.float32, 1) == "wgmma_3xtf32"
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="kernel_size <= 5"):
            mod_fac._route("k", dt, 7)
        assert not mod_fac.cuda_kernel_takes(C, 7, dt, "cuda")
        assert mod_fac.cuda_kernel_takes(C, 5, dt, "cuda")
    assert mod_fac.cuda_kernel_takes(C, 7, torch.float32, "cpu")  # the plain version


def test_f32_call_with_k7_raises_without_a_card():
    """An f32 tensor that is not on the CPU goes to the 3xTF32 kernel, whose
    halo covers K <= 5: the wrapper raises before any launch (meta tensors
    stand in for the card's), and counts nothing."""
    kern.reset_launch_counts()
    K = 7
    x = torch.empty(1, 4, 4, C, device="meta")
    wk = torch.empty(3, 3, 2 * C, K * K * C, device="meta")
    bk = torch.empty(K * K * C, device="meta")
    for fn in (kern.modification_fac_fused, kern.modification_fac_fused_shared):
        with pytest.raises(ValueError, match="kernel_size"):
            fn(x, x, wk, bk, K)
    assert kern.launch_counts() == {"fac": 0, "mod_fac": 0, "mod_fac_shared": 0}
    assert kern.route_counts()["mod_fac"] == {"wgmma_bf16": 0, "wgmma_3xtf32": 0}
