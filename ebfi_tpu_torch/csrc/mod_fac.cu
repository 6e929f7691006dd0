// Kernels B3 and B2 in f32: Modification's kernel-bank prediction fused
// with the FAC apply, so the per-pixel K*K*C bank never reaches device
// memory.  (bf16, the serving dtype, runs on the tensor cores in
// mod_fac_wgmma.cu; this f32 route keeps full f32 products, which the
// card-versus-CPU f32 checks need.)
//
// B3 replaces ebfi_tpu/ops/pallas/mod_fac.py::_kernel:
//   bank = lrelu_0.01(conv3x3_zero_pad(concat(ev, ff), wk) + bk)    (2C -> K*K*C)
//   out[b,y,x,c] = sum_t evrep[b, y+ky-p, x+kx-p, c] * bank[b,y,x,t*C + c],  t = ky*K+kx
// B2 replaces ebfi_tpu/ops/pallas/mod_fac.py::_kernel_shared: the same for
// N timestamps of one frame (ev at batch B*N, ff at batch B), with the ff
// half of the bank conv plus bias computed once per frame into a scratch,
// then per timestamp only the ev half is computed and added.
//
// Bound on the H100: operations.  The bank conv is an implicit GEMM of
// M = pixels, N = K*K*C = 1600, depth 9*Cin (1152 for B3, 576 per
// timestamp for B2), hundreds of flops per byte moved; in f32 it runs on
// the CUDA cores (67 TFLOP/s): a block owns a tile of 2x32 pixels, stages
// their 3x3 neighbourhood of the conv input once in shared memory (f32,
// zero outside the image), then for each of the K*K taps computes that
// tap's C = 64 bank channels for the 64 pixels (4 pixels x 4 channels per
// thread, weights streamed through shared memory 32 rows at a time),
// applies bias (or the ff scratch) and leaky ReLU in registers and
// multiply-accumulates the FAC product at once.
// Only the (B, H, W, C) output is written.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTH = 2;                // tile rows
constexpr int kTW = 32;               // tile columns
constexpr int kTC = 64;               // bank channels per tap == C
constexpr int kKC = 32;               // weight rows per shared-memory chunk
constexpr int kThreads = 256;         // 16 channel groups x 16 pixel groups
constexpr int kHaloPos = (kTH + 2) * (kTW + 2);

enum Mode { kFused = 0, kFFHalf = 1, kShared = 2 };

__host__ __device__ constexpr int halo_stride(int cin) { return cin + 1; }  // no bank conflicts

__host__ __device__ constexpr int halo_floats(int cin) {
  return ((kHaloPos * halo_stride(cin)) + 3) / 4 * 4;  // 16-byte aligned weight tile after it
}

__host__ constexpr size_t smem_bytes(int cin) {
  return sizeof(float) * (size_t)(halo_floats(cin) + kKC * kTC);
}

// CIN: channels of the bank-conv input (2C for B3, C for B2's halves).
// src_a holds input channels [0, C), src_b channels [C, 2C) when CIN == 2C.
// MODE kFused: out = FAC(ev, lrelu(conv + bias))              (B3)
// MODE kFFHalf: out = conv + bias, the full bank               (B2, once per frame)
// MODE kShared: out = FAC(ev, lrelu(conv + ffbank[b / N]))    (B2, per timestamp)
template <int CIN, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
    mod_fac_kernel(const float* __restrict__ src_a, const float* __restrict__ src_b,
                   const float* __restrict__ ev, const float* __restrict__ wk,
                   const float* __restrict__ bias, const float* __restrict__ ffbank,
                   float* __restrict__ out, int H, int W, int K, int N) {
  extern __shared__ __align__(16) float smem[];
  constexpr int HS = halo_stride(CIN);
  float* halo = smem;
  float* ws = smem + halo_floats(CIN);
  const int KK = K * K;
  const int NB = KK * kTC;  // bank channels
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channel group: channels tx*4 .. tx*4+3
  const int ty = tid / 16;  // pixel group: pixels ty + 16*i
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;
  const long long b = blockIdx.z;

  // stage the zero-padded 3x3 neighbourhood of the tile's pixels
  for (int i = tid; i < kHaloPos * CIN; i += kThreads) {
    const int ci = i % CIN;
    const int pos = i / CIN;
    const int yy = y0 + pos / (kTW + 2) - 1;
    const int xx = x0 + pos % (kTW + 2) - 1;
    float v = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const float* s = ci < kTC ? src_a : src_b;
      v = s[((b * H + yy) * W + xx) * kTC + (ci % kTC)];
    }
    halo[pos * HS + ci] = v;
  }

  int hbase[4];
  int py[4], px[4];
  bool valid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
    py[i] = y0 + p / kTW;
    px[i] = x0 + p % kTW;
    hbase[i] = ((p / kTW) * (kTW + 2) + (p % kTW)) * HS;
    valid[i] = py[i] < H && px[i] < W;
  }
  const int pad = (K - 1) / 2;
  const int c0 = tx * 4;

  float oacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[i][j] = 0.f;

  for (int t = 0; t < KK; ++t) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < 9 * CIN; k0 += kKC) {
      __syncthreads();  // halo staged / previous chunk consumed
      for (int i = tid; i < kKC * kTC; i += kThreads) {
        const int r = i / kTC, col = i % kTC;
        ws[i] = wk[(long long)(k0 + r) * NB + t * kTC + col];
      }
      __syncthreads();
      const int tap9 = k0 / CIN;  // kKC divides CIN: a chunk stays in one 3x3 tap
      const int off = ((tap9 / 3) * (kTW + 2) + (tap9 % 3)) * HS + (k0 % CIN);
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const float4 wv = *reinterpret_cast<const float4*>(&ws[kk * kTC + c0]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = halo[hbase[i] + off + kk];
          acc[i][0] = fmaf(a, wv.x, acc[i][0]);
          acc[i][1] = fmaf(a, wv.y, acc[i][1]);
          acc[i][2] = fmaf(a, wv.z, acc[i][2]);
          acc[i][3] = fmaf(a, wv.w, acc[i][3]);
        }
      }
    }

    const int ky = t / K, kx = t % K;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!valid[i]) continue;
      const long long pix = (b * H + py[i]) * W + px[i];
      if (MODE == kFFHalf) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          out[pix * NB + t * kTC + c0 + j] = acc[i][j] + bias[t * kTC + c0 + j];
      } else {
        const int yy = min(max(py[i] + ky - pad, 0), H - 1);
        const int xx = min(max(px[i] + kx - pad, 0), W - 1);
        const float* e = ev + ((b * H + yy) * W + xx) * kTC + c0;
        const long long fpix = ((b / N) * H + py[i]) * W + px[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float pre;
          if (MODE == kFused)
            pre = acc[i][j] + bias[t * kTC + c0 + j];
          else
            pre = acc[i][j] + ffbank[fpix * NB + t * kTC + c0 + j];
          const float kern = pre >= 0.f ? pre : 0.01f * pre;
          oacc[i][j] = fmaf(e[j], kern, oacc[i][j]);
        }
      }
    }
  }

  if (MODE != kFFHalf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!valid[i]) continue;
      const long long pix = (b * H + py[i]) * W + px[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) out[pix * kTC + c0 + j] = oacc[i][j];
    }
  }
}

template <int CIN, int MODE>
cudaError_t launch(int nbatch, int H, int W, int K, int N, const void* src_a, const void* src_b,
                   const void* ev, const void* wk, const void* bias, const void* ffbank,
                   void* out, cudaStream_t stream) {
  if (nbatch > 65535) return cudaErrorInvalidConfiguration;
  auto kern = mod_fac_kernel<CIN, MODE>;
  const size_t smem = smem_bytes(CIN);
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, nbatch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(src_a), static_cast<const float*>(src_b),
      static_cast<const float*>(ev), static_cast<const float*>(wk),
      static_cast<const float*>(bias), static_cast<const float*>(ffbank),
      static_cast<float*>(out), H, W, K, N);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int W, int C, int K) {
  return B <= 0 || H <= 0 || W <= 0 || C != kTC || K <= 0 || K % 2 == 0;
}

cudaError_t fused(const void* ev, const void* ff, const void* wk, const void* bias, void* out,
                  int B, int H, int W, int K, cudaStream_t s) {
  return launch<2 * kTC, kFused>(B, H, W, K, 1, ev, ff, ev, wk, bias, nullptr, out, s);
}

cudaError_t shared(const void* ev, const void* ff, const void* wke, const void* wkf,
                   const void* bias, void* scratch, void* out, int B, int N, int H, int W,
                   int K, cudaStream_t s) {
  cudaError_t e =
      launch<kTC, kFFHalf>(B, H, W, K, 1, ff, ff, nullptr, wkf, bias, nullptr, scratch, s);
  if (e != cudaSuccess) return e;
  return launch<kTC, kShared>(B * N, H, W, K, N, ev, ev, ev, wke, nullptr, scratch, out, s);
}

}  // namespace

// B3 in f32.  ev, ff, out: (B, H, W, C); wk: (9*2C, K*K*C) rows (dy, dx, cin) of the
// HWIO weight; bias: (K*K*C,) f32.
extern "C" int ebfi_mod_fac_fused(const void* ev, const void* ff, const void* wk,
                                  const void* bias, void* out, int B, int H, int W, int C,
                                  int K, void* stream) {
  if (bad_shape(B, H, W, C, K)) return (int)cudaErrorInvalidValue;
  return (int)fused(ev, ff, wk, bias, out, B, H, W, K, static_cast<cudaStream_t>(stream));
}

// B2 in f32.  ev, out: (B*N, H, W, C); ff: (B, H, W, C); wke, wkf: (9*C, K*K*C) the
// ev and ff input halves of the HWIO weight; bias: (K*K*C,) f32; scratch:
// (B, H, W, K*K*C) f32.
extern "C" int ebfi_mod_fac_shared(const void* ev, const void* ff, const void* wke,
                                   const void* wkf, const void* bias, void* scratch, void* out,
                                   int B, int N, int H, int W, int C, int K, void* stream) {
  if (bad_shape(B, H, W, C, K) || N <= 0) return (int)cudaErrorInvalidValue;
  return (int)shared(ev, ff, wke, wkf, bias, scratch, out, B, N, H, W, K,
                     static_cast<cudaStream_t>(stream));
}
