// Kernels B3 and B2 in f32 on Hopper's tensor cores as 3xTF32:
// Modification's kernel-bank conv as an implicit GEMM on TF32 wgmma, fused
// with the FAC apply, so the per-pixel K*K*C bank never reaches device
// memory.  (bf16 runs in mod_fac_wgmma.cu; this is the only f32 route.)
//
// B3 replaces ebfi_tpu/ops/pallas/mod_fac.py::_kernel (mode kFused):
//   bank = lrelu_0.01(conv3x3_zero_pad(concat(ev, ff), wk) + bk)    (2C -> K*K*C)
//   out[b,y,x,c] = sum_t evrep[b, y+ky-p, x+kx-p, c] * bank[b,y,x,t*C + c],  t = ky*K+kx
// B2 replaces ::_kernel_shared: mode kFFHalf computes conv3x3(ff) + bk once
// per frame into an f32 tap-major scratch (B, K*K, H, W, C) (the input
// dtype, as the TPU kernel's band scratch); mode kShared computes only the
// ev half per timestamp, adds the scratch, and applies lrelu + FAC.  With
// `packed` (B2p, H even) kShared stores rows2-packed, (B*N, H/2, W, 2C), as
// ::_kernel_shared does with PACKED=True: only the output address changes.
//
// Bound on the H100: operations.  f32 products through TF32 alone keep
// about three decimal digits, so every product is taken as 3xTF32:
//   a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi,  x_hi = tf32(x), x_lo = tf32(x - x_hi)
// (cvt.rna), three TF32 wgmma into one f32 accumulator, the two small terms
// first: f32-grade products at 495/3 = 165 TFLOP/s.  The tensor cores
// truncate each add into the accumulator (a 1152-deep sum of 144 wgmma
// ends -20 ulp off on average, ebfi_tpu_torch/tools/tf32_wgmma_rate.py),
// which over the 432 wgmma of a bank value cost 5-8x the CUDA-core route's
// error; so the accumulator
// holds one 64-deep chunk (24 wgmma) and its partial sum is added into a
// second accumulator in registers, rounded to nearest.  The design:
// - Implicit GEMM: M = pixels in 64-pixel row segments, N = two taps' 128
//   bank channels (wgmma m64n128k8: on this card register-A TF32 wgmma
//   reaches ~90 % of the TF32 peak at N = 128 and ~68 % at N = 64, measured
//   with no loads), depth = 9 chunks of 64 input channels per input half
//   (one per 3x3 offset), each chunk 8 k8 steps.  An odd K*K leaves a last
//   single tap, run at N = 64.  Block = a producer warpgroup and two
//   consumer warpgroups, two image rows of one image, one m64 tile (one
//   row) per consumer warpgroup: 128 GEMM rows per weight step.  (Two
//   tiles per warpgroup would need 128 accumulators plus 64 FAC sums per
//   thread.)
// - A from registers (wgmma's register-A form): each consumer thread
//   loads its fragment from the halo with two 8-byte loads per k8 step and
//   splits it into hi and lo there, so the halo is staged once, in f32.
//   Within a k8 step logical depth k takes input channel 2*(k%4) + k/4
//   (thread l%4 holds channels 2(l%4), 2(l%4)+1: one 8-byte load); the
//   weight steps are packed in the same order.
// - Halo: staged once per block with cp.async, zero outside the image, as
//   [channel/8][row][col][8] f32 (32 bytes per position and 8-channel
//   group: a warp's fragment load reads 256 contiguous bytes).  An ev
//   image gets a border of 2 (3x3 conv and the 5x5 FAC, whose neighbour is
//   a clamped index into it: replication), ff a border of 1.  Bytes: ev
//   (2+4) x 68 x 256 = 104448, ff (2+2) x 66 x 256 = 67584; ring stages of
//   8 KB; kFused ev + ff + 6 stages = 221184, kShared ev + 8 stages =
//   169984, kFFHalf ff + 8 stages = 133120, of the 232448 a block may have.
// - Weights: packed on the host in f32 (ops/cuda/mod_fac.py
//   pack_bank_weight_tf32: per (tap pair, chunk, k8 step) a 4 KB tile in
//   the no-swizzle K-major core-matrix layout, rows of 4 tf32; LBO 128
//   bytes along K, SBO 256 along N, so a ring stage can be one k8 step).
//   The producer warpgroup reads each step from L2 (32 bytes a thread,
//   kPrefetch steps ahead in registers), splits it into hi and lo, writes
//   both (8 KB) into a ring stage and arrives on the stage's mbarrier; the
//   consumers release a stage when the wgmma reading it has completed.
//   Splitting on chip halves the L2 bytes against streaming hi and lo:
//   4 B per weight per block, 7.7 MB per kFused block (the 13th pair's
//   empty half included) and 3.8 MB per kFFHalf or kShared block: 13.8 GB
//   per B3 call at 360x640 (1800 blocks), 6.9 + 110 GB per B2 call at
//   N = 16 (1800 + 28800 blocks), all from L2 (the packed weights, 7.7 MB,
//   stay resident); under 2 TB/s at the measured times.
// - Promotion: after a chunk's 8 steps each consumer warpgroup waits for
//   its last wgmma group and adds D into acc (64 registers more beside D's
//   64 and the 32 FAC sums); the other warpgroup keeps the tensor cores
//   busy meanwhile.
// - After a tap pair's chunks the epilogue runs in registers, per tap: add
//   the bias (B3) or the f32 ff scratch (B2: each timestamp's block reads
//   its tile; the N blocks of a tile are launched together, so the tile
//   comes from device memory about once), leaky ReLU, multiply by the ev
//   neighbour of the tap read from the halo, accumulate the FAC sum.  Only
//   the output is written (common.cuh::out_pixel).
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kC = 64;         // channels == bank channels per tap
constexpr int kTileW = 64;     // pixels of one m64 tile: a row segment
constexpr int kRows = 2;       // image rows per block: one per consumer warpgroup
constexpr int kMaxK = 5;       // the ev halo's border (2) covers a 5x5 FAC
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kStepFloats = 2 * kC * 8;      // one k8 weight step: 128 bank channels x 8 inputs
constexpr int kStepBytes = kStepFloats * 4;  // 4 KB: f32 in device memory, one TF32 half in smem
constexpr int kStageBytes = 2 * kStepBytes;  // hi + lo
constexpr int kPrefetch = 2;                 // weight steps in flight per producer thread

enum Mode { kFused = 0, kFFHalf = 1, kShared = 2 };

// halo slot s of a mode: border 2 for an ev image (3x3 conv and the 5x5
// FAC), 1 for ff (B3's slot 1, B2's kFFHalf)
template <int MODE>
__host__ __device__ constexpr int halo_border(int s) {
  return MODE == kFFHalf || s == 1 ? 1 : 2;
}
template <int MODE>
__host__ __device__ constexpr int halo_cols(int s) {
  return kTileW + 2 * halo_border<MODE>(s);
}
template <int MODE>
__host__ __device__ constexpr int halo_plane(int s) {  // positions of one 8-channel group
  return (kRows + 2 * halo_border<MODE>(s)) * halo_cols<MODE>(s);
}

template <int MODE>
struct Geo {
  static constexpr int kSlots = MODE == kFused ? 2 : 1;
  static constexpr int kChunks = MODE == kFused ? 18 : 9;  // 64-deep chunks per tap pair
  static constexpr int kStages = MODE == kFused ? 6 : 8;   // ring stages of one k8 step
  static constexpr int kSlot0 = halo_plane<MODE>(0) * kC;  // floats of slot 0 (slot 1 follows)
  static constexpr int kHaloBytes = 4 * (kSlot0 + (kSlots == 2 ? halo_plane<MODE>(1) * kC : 0));
  static constexpr int kSmem = kStages * kStageBytes + kHaloBytes + 16 * kStages;
};

struct Params {
  const float* src0;    // fused: ev; ffhalf: ff; shared: ev (B*N)
  const float* src1;    // fused: ff
  const float* wpack;   // (ceil(K*K/2), chunks, 8, 1024) f32 step tiles
  const float* bias;    // (K*K*C,): fused, ffhalf
  const float* ffbank;  // (B, K*K, H, W, C): shared
  float* out;           // fused, shared: (batch, H, W, C); ffhalf: (B, K*K, H, W, C)
  int H, W, K, N, tiles_x, tiles_y;
  int packed;           // shared: store the output rows2-packed
};

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1) mod_fac_3xtf32(const Params p) {
  using G = Geo<MODE>;
  constexpr int S = G::kStages;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;
  float* halo = reinterpret_cast<float*>(smem + S * kStageBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S * kStageBytes + G::kHaloBytes);
  const uint32_t full0 = smem_addr(bars), empty0 = smem_addr(bars + S);

  const int KK = p.K * p.K;
  const int pairs = (KK + 1) / 2;
  const int nSteps = pairs * G::kChunks * 8;  // a multiple of kPrefetch
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 128);               // every producer thread arrives
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer: f32 weight steps from L2, split into TF32 hi and lo
    // 128 x 40 + 256 x 232 = 64512 = 384 x 168, the block's registers at launch
    setmaxnreg_dec<40>();
    const float4* src = reinterpret_cast<const float4*>(p.wpack) + threadIdx.x;
    float4 buf[kPrefetch][2];
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) buf[j][h] = __ldg(src + j * (kStepFloats / 4) + 128 * h);
    for (int i0 = 0; i0 < nSteps; i0 += kPrefetch) {
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) {
        const int i = i0 + j;
        const int s = i % S;
        if (i >= S) mbar_wait(empty0 + 8 * s, ((i / S) - 1) & 1);
        uint8_t* dst = ring + s * kStageBytes + 16 * threadIdx.x;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = buf[j][h];
          if (i + kPrefetch < nSteps)
            buf[j][h] = __ldg(src + (long long)(i + kPrefetch) * (kStepFloats / 4) + 128 * h);
          uint4 hi, lo;
          split_tf32(v.x, hi.x, lo.x);
          split_tf32(v.y, hi.y, lo.y);
          split_tf32(v.z, hi.z, lo.z);
          split_tf32(v.w, hi.w, lo.w);
          *reinterpret_cast<uint4*>(dst + 2048 * h) = hi;
          *reinterpret_cast<uint4*>(dst + 2048 * h + kStepBytes) = lo;
        }
        fence_proxy_async();  // the generic-proxy writes, seen by wgmma
        mbar_arrive(full0 + 8 * s);
      }
    }
    return;
  }

  // ---------------- consumers
  setmaxnreg_inc<232>();
  const int H = p.H, W = p.W, K = p.K, pad = (K - 1) / 2;
  const int ct = threadIdx.x - 128;  // 0..255
  const int wg = ct / 128;           // consumer warpgroup: image row sy0 + wg
  const int wt = ct % 128;
  const int warp = wt / 32, lane = wt % 32;
  const int g8 = lane / 4, tig = lane % 4;

  // kShared: the timestamp varies fastest, so a frame's N blocks at one
  // tile run together and read that tile of the ff scratch through L2
  int bid = blockIdx.x;
  const int n = MODE == kShared ? bid % p.N : 0;
  if (MODE == kShared) bid /= p.N;
  const int tx = bid % p.tiles_x;
  bid /= p.tiles_x;
  const int ty = bid % p.tiles_y;
  const long long frame = bid / p.tiles_y;  // b
  const long long img = frame * p.N + n;    // the image of ev, ff (N = 1) and out
  const int x0 = tx * kTileW, sy0 = ty * kRows;

  // stage the halo slots: zero outside the image (the conv's padding)
#pragma unroll
  for (int s = 0; s < G::kSlots; ++s) {
    const float* src = s == 1 ? p.src1 : p.src0;
    const int bd = halo_border<MODE>(s), hc = halo_cols<MODE>(s), pl = halo_plane<MODE>(s);
    const uint32_t base = smem_addr(halo + s * G::kSlot0);
    for (int i = ct; i < pl * 16; i += kConsumers) {
      const int pos = i % pl, q = i / pl;  // q: 16-byte quarter-group of the 64 channels
      const int yy = sy0 - bd + pos / hc, xx = x0 - bd + pos % hc;
      const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const float* g =
          src + ((img * H + (inside ? yy : 0)) * W + (inside ? xx : 0)) * kC + 4 * q;
      cp_async16(base + ((q / 2) * pl + pos) * 32 + (q % 2) * 16, g, inside ? 16 : 0);
    }
  }
  cp_async_wait_all();
  named_barrier(1, kConsumers);

  const int y = sy0 + wg;  // this warpgroup's image row
  const int yc = min(y, H - 1);
  constexpr int kEvCols = kTileW + 4, kEvPlane = (kRows + 4) * kEvCols;  // ev slot geometry
  const uint32_t ring0 = smem_addr(ring);
  // accumulator element i of this thread: pixel prow + 8*((i/2)%2), bank
  // channel 8*((i%32)/4) + 2*tig + i%2 of the pair's tap 2*pr + i/32
  const int prow = warp * 16 + g8;

  // d: one chunk's sum on the tensor cores; acc: the chunks' partial sums,
  // added in registers (round to nearest: the tensor cores truncate)
  float d[64], acc[64], fac[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) fac[i] = 0.f;
  float(&d0)[32] = *reinterpret_cast<float(*)[32]>(d);  // the pair's first tap alone

  int it = 0;  // weight step, in the producer's order
  for (int pr = 0; pr < pairs; ++pr) {
    const bool two = 2 * pr + 1 < KK;  // else the last, single tap: N = 64
    // ---- acc = sum over chunks of (D = sum over the chunk's k8 steps of
    //      3xTF32 A(shifted halo) * W(taps 2pr, 2pr+1))
    for (int kc = 0; kc < G::kChunks; ++kc) {
      const int half = kc / 9, tap9 = kc % 9, dy = tap9 / 3, dx = tap9 % 3;
      const int bd = halo_border<MODE>(half), hc = halo_cols<MODE>(half);
      const int pl = halo_plane<MODE>(half);
      const float* abase = halo + half * G::kSlot0 +
                           ((wg + bd - 1 + dy) * hc + bd - 1 + dx + prow) * 8 + 2 * tig;
      int prev = 0;
#pragma unroll
      for (int s = 0; s < 8; ++s, ++it) {
        const float* a = abase + s * pl * 8;
        const float2 r0 = *reinterpret_cast<const float2*>(a);       // pixel row g8
        const float2 r8 = *reinterpret_cast<const float2*>(a + 64);  // pixel row g8 + 8
        uint32_t ahi[4], alo[4];
        split_tf32(r0.x, ahi[0], alo[0]);  // k = tig:     channel 8s + 2tig
        split_tf32(r8.x, ahi[1], alo[1]);
        split_tf32(r0.y, ahi[2], alo[2]);  // k = tig + 4: channel 8s + 2tig + 1
        split_tf32(r8.y, ahi[3], alo[3]);
        const int st = it % S;
        mbar_wait(full0 + 8 * st, (it / S) & 1);
        const uint32_t bhi = ring0 + st * kStageBytes;
        const uint64_t dhi = smem_desc(bhi, 128, 256, 0);
        const uint64_t dlo = smem_desc(bhi + kStepBytes, 128, 256, 0);
        wgmma_fence();
        if (two) {
          wgmma_m64n128k8_tf32_rs(d, alo, dhi, s != 0);
          wgmma_m64n128k8_tf32_rs(d, ahi, dlo, 1);
          wgmma_m64n128k8_tf32_rs(d, ahi, dhi, 1);
        } else {
          wgmma_m64n64k8_tf32_rs(d0, alo, dhi, s != 0);
          wgmma_m64n64k8_tf32_rs(d0, ahi, dlo, 1);
          wgmma_m64n64k8_tf32_rs(d0, ahi, dhi, 1);
        }
        wgmma_commit();
        if (s) {
          wgmma_wait<1>();  // the previous step's group: its stage and A registers are free
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        }
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(d);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (two || i < 32) acc[i] = kc ? acc[i] + d[i] : d[i];
    }

    // ---- epilogue of the pair's taps, in registers
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = 2 * pr + h;
      if (t >= KK) break;
      const int ky = t / K, kx = t % K;
      const int hy = min(max(y + ky - pad, 0), H - 1) - (sy0 - 2);  // replication pad
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int px = x0 + prow + 8 * q;
        const int pxc = min(px, W - 1);
        const int hx = min(max(px + kx - pad, 0), W - 1) - (x0 - 2);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * tig;
          float v0 = acc[32 * h + 4 * j + 2 * q], v1 = acc[32 * h + 4 * j + 2 * q + 1];
          if (MODE == kShared) {
            const float2 f = __ldg(reinterpret_cast<const float2*>(
                p.ffbank + (((frame * KK + t) * H + yc) * W + pxc) * kC + c));
            v0 += f.x;
            v1 += f.y;
          } else {
            const float2 bb = __ldg(reinterpret_cast<const float2*>(p.bias + t * kC + c));
            v0 += bb.x;
            v1 += bb.y;
          }
          if (MODE == kFFHalf) {
            if (y < H && px < W)
              *reinterpret_cast<float2*>(p.out + (((img * KK + t) * H + y) * W + px) * kC + c) =
                  make_float2(v0, v1);
          } else {
            v0 = v0 >= 0.f ? v0 : 0.01f * v0;
            v1 = v1 >= 0.f ? v1 : 0.01f * v1;
            const float2 e = *reinterpret_cast<const float2*>(
                halo + (j * kEvPlane + hy * kEvCols + hx) * 8 + 2 * tig);
            fac[4 * j + 2 * q] = fmaf(e.x, v0, fac[4 * j + 2 * q]);
            fac[4 * j + 2 * q + 1] = fmaf(e.y, v1, fac[4 * j + 2 * q + 1]);
          }
        }
      }
    }
  }

  if (MODE == kFFHalf || y >= H) return;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int px = x0 + prow + 8 * q;
    if (px >= W) continue;
    float* o = p.out + ebfi::out_pixel(img, y, px, H, W, p.packed) * kC + 2 * tig;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(o + 8 * j) =
          make_float2(fac[4 * j + 2 * q], fac[4 * j + 2 * q + 1]);
  }
}

template <int MODE>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = Geo<MODE>::kSmem;
  static_assert(smem <= 232448, "shared memory budget of one block");
  const long long blocks = (long long)batch * p.tiles_y * p.tiles_x;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  auto kern = mod_fac_3xtf32<MODE>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

Params tiling(int H, int W, int K, int N) {
  Params p{};
  p.H = H;
  p.W = W;
  p.K = K;
  p.N = N;
  p.tiles_x = (W + kTileW - 1) / kTileW;
  p.tiles_y = (H + kRows - 1) / kRows;
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

// B3 in f32.  ev, ff, out: (B, H, W, 64) f32; wpack: (ceil(K*K/2), 18, 8,
// 1024) f32 step tiles (chunk = half*9 + 3x3 offset; ops/cuda/mod_fac.py
// pack_bank_weight_tf32); bias: (K*K*64,) f32.  Pointers 16-byte aligned.
extern "C" int ebfi_mod_fac_fused(const void* ev, const void* ff, const void* wpack,
                                  const void* bias, void* out, int B, int H, int W, int C,
                                  int K, void* stream) {
  if (bad_shape(B, H, W, C, K) || !aligned16({ev, ff, wpack, bias, out}))
    return (int)cudaErrorInvalidValue;
  Params p = tiling(H, W, K, 1);
  p.src0 = static_cast<const float*>(ev);
  p.src1 = static_cast<const float*>(ff);
  p.wpack = static_cast<const float*>(wpack);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  return (int)launch<kFused>(p, B, static_cast<cudaStream_t>(stream));
}

// B2 in f32.  ev: (B*N, H, W, 64); ff: (B, H, W, 64); wpack_e, wpack_f:
// (ceil(K*K/2), 9, 8, 1024) step tiles of the ev and ff input halves; bias
// (K*K*64,); scratch: (B, K*K, H, W, 64) f32, the ff half plus bias; out:
// (B*N, H, W, 64), or (B*N, H/2, W, 128) when packed (H even).
extern "C" int ebfi_mod_fac_shared(const void* ev, const void* ff, const void* wpack_e,
                                   const void* wpack_f, const void* bias, void* scratch,
                                   void* out, int B, int N, int H, int W, int C, int K,
                                   int packed, void* stream) {
  if (bad_shape(B, H, W, C, K) || N <= 0 || (packed && H % 2) ||
      !aligned16({ev, ff, wpack_e, wpack_f, bias, scratch, out}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params pf = tiling(H, W, K, 1);
  pf.src0 = static_cast<const float*>(ff);
  pf.wpack = static_cast<const float*>(wpack_f);
  pf.bias = static_cast<const float*>(bias);
  pf.out = static_cast<float*>(scratch);
  cudaError_t e = launch<kFFHalf>(pf, B, s);
  if (e != cudaSuccess) return (int)e;
  Params ps = tiling(H, W, K, N);
  ps.src0 = static_cast<const float*>(ev);
  ps.wpack = static_cast<const float*>(wpack_e);
  ps.ffbank = static_cast<const float*>(scratch);
  ps.out = static_cast<float*>(out);
  ps.packed = packed != 0;
  return (int)launch<kShared>(ps, B * N, s);
}
