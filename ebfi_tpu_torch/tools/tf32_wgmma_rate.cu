// Throughput of register-A TF32 wgmma (m64nNk8, f32 accumulate) on one
// Hopper card, N = 64 and 128, with no loads: the ceiling a kernel built
// from these instructions can reach.  Each block is two warpgroups on one
// SM; per step each warpgroup issues three wgmma into one accumulator (as
// the 3xTF32 kernel csrc/mod_fac.cu does), commits, and waits for the
// previous step's group.  Built and run by tf32_wgmma_rate.py beside it.
#include <stdint.h>

#include "hopper.cuh"

using namespace hopper;

template <int N>
__device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  if (N == 128) {
    wgmma_m64n128k8_tf32_rs(d, a, db, 1);
  } else {
    wgmma_m64n64k8_tf32_rs(*reinterpret_cast<float(*)[32]>(d), a, db, 1);
  }
}

template <int N>
__global__ void __launch_bounds__(256, 1) rate_kernel(float* out, int steps) {
  extern __shared__ __align__(128) uint8_t smem[];
  for (int i = threadIdx.x; i < 4096; i += 256) reinterpret_cast<float*>(smem)[i] = 1e-3f * (i % 7);
  __syncthreads();
  const uint32_t b0 = smem_addr(smem);
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  for (int s = 0; s < steps; ++s) {
    const uint64_t db = smem_desc(b0 + (s % 4) * 4096, 128, 256, 0);
    for (int q = 0; q < 4; ++q) a[q] = tf32_rna(__uint_as_float(a[q]) + 1.0f);
    wgmma_fence();
    mma<N>(d, a, db);
    mma<N>(d, a, db);
    mma<N>(d, a, db);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(d);
  float acc = 0.f;
  for (int i = 0; i < 64; ++i) acc += d[i];
  out[blockIdx.x * 256 + threadIdx.x] = acc;
}

// D (64 x 64) = A (64 x depth) * B (depth x 64) by one warpgroup, one
// m64n64k8 wgmma per k8 step into one f32 accumulator: how the tensor
// cores round their f32 sums.  A and B hold TF32 values (row-major f32),
// so every product is exact; B is staged step by step in the no-swizzle
// K-major layout of csrc/mod_fac.cu.
__global__ void __launch_bounds__(128, 1)
    sum_kernel(const float* a, const float* b, float* d_out, int depth) {
  __shared__ __align__(128) float bs[64 * 8];
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, g = lane / 4, tig = lane % 4;
  float d[32];
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  for (int k0 = 0; k0 < depth; k0 += 8) {
    __syncthreads();
    for (int e = t; e < 64 * 8; e += 128) {  // element (n, k) of the step
      const int n = e / 8, k = e % 8;
      bs[((n / 8) * 2 + k / 4) * 32 + (n % 8) * 4 + k % 4] = b[(k0 + k) * 64 + n];
    }
    fence_proxy_async();
    __syncthreads();
    uint32_t af[4];
    for (int i = 0; i < 4; ++i)
      af[i] = __float_as_uint(a[(16 * warp + g + 8 * (i % 2)) * depth + k0 + tig + 4 * (i / 2)]);
    wgmma_fence();
    wgmma_m64n64k8_tf32_rs(d, af, smem_desc(smem_addr(bs), 128, 256, 0), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
  }
  for (int i = 0; i < 32; ++i)
    d_out[(16 * warp + g + 8 * ((i / 2) % 2)) * 64 + 8 * (i / 4) + 2 * tig + i % 2] = d[i];
}

// A (64 x depth), B (depth x 64), D (64 x 64) f32 in device memory; 0 or a
// CUDA error code.
extern "C" int tf32_wgmma_sum(const float* a, const float* b, float* d, int depth) {
  sum_kernel<<<1, 128>>>(a, b, d, depth);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

// Milliseconds of one launch of `blocks` blocks x `steps` steps at width n
// (64 or 128), after a warm-up launch; negative on a CUDA error.
extern "C" float tf32_wgmma_ms(int n, int blocks, int steps) {
  float* out = nullptr;
  if (cudaMalloc(&out, (size_t)blocks * 256 * sizeof(float)) != cudaSuccess) return -1.f;
  auto kern = n == 128 ? rate_kernel<128> : rate_kernel<64>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 16384);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  kern<<<blocks, 256, 16384>>>(out, steps);
  cudaEventRecord(e0);
  kern<<<blocks, 256, 16384>>>(out, steps);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = -1.f;
  if (cudaGetLastError() == cudaSuccess) cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
  return ms;
}
