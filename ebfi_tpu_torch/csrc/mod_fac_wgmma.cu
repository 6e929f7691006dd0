// Kernels B3 and B2 in bf16 on Hopper's tensor cores: Modification's
// kernel-bank conv as an implicit GEMM on wgmma, fused with the FAC apply,
// so the per-pixel K*K*C bank never reaches device memory.
//
// B3 replaces ebfi_tpu/ops/pallas/mod_fac.py::_kernel (mode kFused):
//   bank = lrelu_0.01(conv3x3_zero_pad(concat(ev, ff), wk) + bk)    (2C -> K*K*C)
//   out[b,y,x,c] = sum_t evrep[b, y+ky-p, x+kx-p, c] * bank[b,y,x,t*C + c],  t = ky*K+kx
// B2 replaces ::_kernel_shared: mode kFFHalf computes conv3x3(ff) + bk once
// per frame and rounds it to bf16 into a tap-major scratch (B, K*K, H, W, C),
// as the TPU kernel's band scratch rounds it; mode kShared then computes
// only the ev half per timestamp, adds the scratch, and applies lrelu + FAC.
//
// Bound on the H100: operations (bank conv depth 9*2C = 1152 into K*K*C =
// 1600 channels per pixel; 989 TFLOP/s bf16).  The design:
// - Implicit GEMM, M = pixels, N = one tap's 64 bank channels, depth = 9
//   chunks of 64 input channels per input half (one chunk per 3x3 offset).
//   A block stages the zero-padded halo of its tile in shared memory in a
//   core-matrix layout [channel/8][row][col][8]: the A operand of 3x3
//   offset (dy, dx) is then the same halo seen from another start address
//   (no swizzle: SBO = 128 bytes between 8-pixel groups, LBO = one channel
//   plane), so no im2col is built and nothing is copied per offset.
// - Weights are packed on the host into 64x64 tiles in the 128-byte swizzle
//   that wgmma reads for B, streamed in (tap, chunk) order by one producer
//   thread through a ring of kStages 8 KB stages with 1-D bulk copies and
//   mbarriers; two consumer warpgroups (setmaxnreg moves registers to them)
//   share each tile, each computing 128 rows (two image rows of 64 pixels),
//   so every weight byte read from L2 feeds 256 GEMM rows.  In B2 the two
//   warpgroups are two timestamps of one frame at the same pixels.
// - After a tap's 9 (or 18) chunks the epilogue runs in registers: add the
//   bias (B3) or the bf16 ff scratch (B2), leaky ReLU, multiply by the ev
//   neighbour of the tap read from the halo (replication padding is a
//   clamped index into the same halo), accumulate the FAC sum.  Only the
//   (B, H, W, C) output is written.
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kC = 64;                   // channels == bank channels per tap
constexpr int kTileW = 64;               // pixels of one m64 tile: a row segment
constexpr int kBorder = 2;               // halo border: 3x3 conv and up to 5x5 FAC
constexpr int kMaxK = 2 * kBorder + 1;
constexpr int kHC = kTileW + 2 * kBorder;  // halo columns
constexpr int kStages = 6;               // weight ring
constexpr int kTileElems = kC * kC;      // one 64x64 weight tile
constexpr int kTileBytes = kTileElems * 2;
constexpr int kThreads = 384;            // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumers = 256;

enum Mode { kFused = 0, kFFHalf = 1, kShared = 2 };

template <int MODE>
struct Geo {
  static constexpr int kRows = MODE == kShared ? 2 : 4;  // image rows of one halo slot
  static constexpr int kHR = kRows + 2 * kBorder;
  static constexpr int kPlane = kHR * kHC;               // positions of a channel plane
  static constexpr int kSlots = MODE == kFFHalf ? 1 : 2;
  static constexpr int kChunks = MODE == kFused ? 18 : 9;  // 64-deep K chunks per tap
  static constexpr int kSlotBytes = kPlane * kC * 2;
  static constexpr int kSmem = 1024 + kStages * kTileBytes + kSlots * kSlotBytes + 16 * kStages;
};

struct Params {
  const bf16* src0;     // fused: ev; ffhalf: ff; shared: ev (B*N)
  const bf16* src1;     // fused: ff
  const bf16* wpack;    // (K*K, chunks, 64, 64) swizzled tiles
  const float* bias;    // (K*K*C,) f32: fused, ffhalf
  const bf16* ffbank;   // (B, K*K, H, W, C): shared
  bf16* out;            // fused, shared: (batch, H, W, C); ffhalf: (B, K*K, H, W, C)
  int H, W, K, N, tiles_x, tiles_y, groups;
};

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1) mod_fac_wgmma(const Params p) {
  using G = Geo<MODE>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzled weight tiles need 1024-byte alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint8_t* halo = ring + kStages * kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(halo + G::kSlots * G::kSlotBytes);
  const uint32_t full0 = smem_addr(bars), empty0 = smem_addr(bars + kStages);

  const int KK = p.K * p.K;
  const int nTiles = KK * G::kChunks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer: stream the weight tiles through the ring
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const uint32_t ring0 = smem_addr(ring);
      for (int i = 0; i < nTiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty0 + 8 * s, ((i / kStages) - 1) & 1);
        mbar_arrive_expect_tx(full0 + 8 * s, kTileBytes);
        bulk_copy_g2s(ring0 + s * kTileBytes, p.wpack + (long long)i * kTileElems, kTileBytes,
                      full0 + 8 * s);
      }
    }
    return;
  }

  // ---------------- consumers
  setmaxnreg_inc<232>();
  const int H = p.H, W = p.W, K = p.K, pad = (K - 1) / 2;
  const int ct = threadIdx.x - 128;  // 0..255
  const int wg = ct / 128;           // consumer warpgroup
  const int wt = ct % 128;
  const int warp = wt / 32, lane = wt % 32;

  int bid = blockIdx.x;
  int ng = 0;
  if (MODE == kShared) {
    ng = bid % p.groups;
    bid /= p.groups;
  }
  const int tx = bid % p.tiles_x;
  bid /= p.tiles_x;
  const int ty = bid % p.tiles_y;
  const int b = bid / p.tiles_y;
  const int x0 = tx * kTileW, hx0 = x0 - kBorder;
  const int sy0 = ty * G::kRows, hy0 = sy0 - kBorder;  // first image row of the slots

  // batch index of each halo slot's image
  auto slot_image = [&](int s) -> long long {
    if (MODE == kShared) return (long long)b * p.N + min(2 * ng + s, p.N - 1);
    return b;
  };

  // stage the halo slots: zero outside the image (the conv's padding)
  for (int s = 0; s < G::kSlots; ++s) {
    const bf16* src = (MODE == kFused && s == 1) ? p.src1 : p.src0;
    const long long img = slot_image(s);
    const uint32_t base = smem_addr(halo + s * G::kSlotBytes);
    for (int i = ct; i < G::kPlane * 8; i += kConsumers) {
      const int pos = i % G::kPlane, chunk = i / G::kPlane;
      const int yy = hy0 + pos / kHC, xx = hx0 + pos % kHC;
      const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const bf16* g =
          src + ((img * H + (inside ? yy : 0)) * W + (inside ? xx : 0)) * kC + chunk * 8;
      cp_async16(base + (chunk * G::kPlane + pos) * 16, g, inside ? 16 : 0);
    }
  }
  cp_async_wait_all();
  fence_proxy_async();
  named_barrier(1, kConsumers);

  // this warpgroup's rows: two image rows of 64 pixels at rowoff within the slot
  const int rowoff = MODE == kShared ? 0 : 2 * wg;
  const int evslot = MODE == kShared ? wg : 0;
  const bool wg_valid = MODE != kShared || 2 * ng + wg < p.N;
  const long long out_img = MODE == kShared ? slot_image(wg) : b;
  const uint32_t halo0 = smem_addr(halo);
  const uint32_t ring0 = smem_addr(ring);
  const uint8_t* evhalo = halo + evslot * G::kSlotBytes;

  // accumulator element i of this thread: pixel prow[(i/2)%2], channel 8*(i/4)+2*(lane%4)+i%2
  const int g8 = lane / 4, tig = lane % 4;
  const int prow[2] = {warp * 16 + g8, warp * 16 + g8 + 8};

  float d[2][32], fac[2][32];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[m][i] = fac[m][i] = 0.f;

  int it = 0;
  for (int t = 0; t < KK; ++t) {
    // ---- D_t = sum over chunks of A(shifted halo) * W(tap t, chunk)
    int prev = 0;
    for (int kc = 0; kc < G::kChunks; ++kc, ++it) {
      const int s = it % kStages;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      const int half = kc / 9, tap9 = kc % 9, dy = tap9 / 3, dx = tap9 % 3;
      const int slot = MODE == kShared ? wg : half;
      // A start: pixel 0 of the tile row, shifted by (dy - 1, dx - 1)
      const uint32_t a0 = halo0 + slot * G::kSlotBytes +
                          ((rowoff + kBorder - 1 + dy) * kHC + kBorder - 1 + dx) * 16;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = smem_desc(ring0 + s * kTileBytes + kk * 32, 16, 1024, 1);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const uint64_t da =
              smem_desc(a0 + (2 * kk * G::kPlane + m * kHC) * 16, G::kPlane * 16, 128, 0);
          wgmma_m64n64k16_ss(d[m], da, db, (kc | kk) != 0);
        }
      }
      wgmma_commit();
      if (kc > 0) {
        wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(d[0]);
    fence_regs(d[1]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * prev);

    // ---- epilogue of tap t, in registers
    const int ky = t / K, kx = t % K;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int y = sy0 + rowoff + m;
      const int yc = min(y, H - 1);
      const int hy = min(max(y + ky - pad, 0), H - 1) - hy0;  // replication pad
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int px = x0 + prow[q];
        const int pxc = min(px, W - 1);
        const int hx = min(max(px + kx - pad, 0), W - 1) - hx0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * tig;
          float v0 = d[m][4 * j + 2 * q], v1 = d[m][4 * j + 2 * q + 1];
          if (MODE == kShared) {
            const __nv_bfloat162 f = *reinterpret_cast<const __nv_bfloat162*>(
                p.ffbank + ((((long long)b * KK + t) * H + yc) * W + pxc) * kC + c);
            v0 += __bfloat162float(f.x);
            v1 += __bfloat162float(f.y);
          } else {
            const float2 bb = __ldg(reinterpret_cast<const float2*>(p.bias + t * kC + c));
            v0 += bb.x;
            v1 += bb.y;
          }
          if (MODE == kFFHalf) {
            if (y < H && px < W)
              *reinterpret_cast<__nv_bfloat162*>(
                  p.out + ((((long long)b * KK + t) * H + y) * W + px) * kC + c) =
                  __floats2bfloat162_rn(v0, v1);
          } else {
            v0 = v0 >= 0.f ? v0 : 0.01f * v0;
            v1 = v1 >= 0.f ? v1 : 0.01f * v1;
            const __nv_bfloat162 e = *reinterpret_cast<const __nv_bfloat162*>(
                evhalo + ((j * G::kPlane + hy * kHC + hx) * 8 + 2 * tig) * 2);
            fac[m][4 * j + 2 * q] = fmaf(__bfloat162float(e.x), v0, fac[m][4 * j + 2 * q]);
            fac[m][4 * j + 2 * q + 1] =
                fmaf(__bfloat162float(e.y), v1, fac[m][4 * j + 2 * q + 1]);
          }
        }
      }
    }
  }

  if (MODE == kFFHalf || !wg_valid) return;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int y = sy0 + rowoff + m;
    if (y >= H) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int px = x0 + prow[q];
      if (px >= W) continue;
      bf16* o = p.out + ((out_img * H + y) * W + px) * kC + 2 * tig;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
            __floats2bfloat162_rn(fac[m][4 * j + 2 * q], fac[m][4 * j + 2 * q + 1]);
    }
  }
}

template <int MODE>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = Geo<MODE>::kSmem;
  const long long blocks = (long long)batch * p.tiles_y * p.tiles_x * p.groups;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  auto kern = mod_fac_wgmma<MODE>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MODE>
Params tiling(int H, int W, int K, int N) {
  Params p{};
  p.H = H;
  p.W = W;
  p.K = K;
  p.N = N;
  p.tiles_x = (W + kTileW - 1) / kTileW;
  p.tiles_y = (H + Geo<MODE>::kRows - 1) / Geo<MODE>::kRows;
  p.groups = MODE == kShared ? (N + 1) / 2 : 1;
  return p;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16) return false;
  return true;
}

bool bad_shape(int B, int H, int W, int C, int K) {
  return B <= 0 || H <= 0 || W <= 0 || C != kC || K <= 0 || K % 2 == 0 || K > kMaxK;
}

}  // namespace

// B3 in bf16.  ev, ff, out: (B, H, W, 64) bf16; wpack: (K*K, 18, 64, 64) bf16
// swizzled tiles (chunk = half*9 + 3x3 offset; ops/cuda/mod_fac.py
// pack_bank_weight); bias: (K*K*64,) f32.  Pointers 16-byte aligned.
extern "C" int ebfi_mod_fac_fused_wgmma(const void* ev, const void* ff, const void* wpack,
                                        const void* bias, void* out, int B, int H, int W, int C,
                                        int K, void* stream) {
  if (bad_shape(B, H, W, C, K) || !aligned16({ev, ff, wpack, bias, out}))
    return (int)cudaErrorInvalidValue;
  Params p = tiling<kFused>(H, W, K, 1);
  p.src0 = static_cast<const bf16*>(ev);
  p.src1 = static_cast<const bf16*>(ff);
  p.wpack = static_cast<const bf16*>(wpack);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<bf16*>(out);
  return (int)launch<kFused>(p, B, static_cast<cudaStream_t>(stream));
}

// B2 in bf16.  ev, out: (B*N, H, W, 64); ff: (B, H, W, 64); wpack_e, wpack_f:
// (K*K, 9, 64, 64) swizzled tiles of the ev and ff input halves; bias
// (K*K*64,) f32; scratch: (B, K*K, H, W, 64) bf16, the ff half plus bias.
extern "C" int ebfi_mod_fac_shared_wgmma(const void* ev, const void* ff, const void* wpack_e,
                                         const void* wpack_f, const void* bias, void* scratch,
                                         void* out, int B, int N, int H, int W, int C, int K,
                                         void* stream) {
  if (bad_shape(B, H, W, C, K) || N <= 0 ||
      !aligned16({ev, ff, wpack_e, wpack_f, bias, scratch, out}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params pf = tiling<kFFHalf>(H, W, K, 1);
  pf.src0 = static_cast<const bf16*>(ff);
  pf.wpack = static_cast<const bf16*>(wpack_f);
  pf.bias = static_cast<const float*>(bias);
  pf.out = static_cast<bf16*>(scratch);
  cudaError_t e = launch<kFFHalf>(pf, B, s);
  if (e != cudaSuccess) return (int)e;
  Params ps = tiling<kShared>(H, W, K, N);
  ps.src0 = static_cast<const bf16*>(ev);
  ps.wpack = static_cast<const bf16*>(wpack_e);
  ps.ffbank = static_cast<const bf16*>(scratch);
  ps.out = static_cast<bf16*>(out);
  return (int)launch<kShared>(ps, B, s);
}
