// Shared helpers of the hand-written Hopper kernels: dtype conversion.
// Every kernel reads f32 or bf16 and accumulates in f32.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ebfi {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Flat pixel index of output image row y, column x: (img, y, x) of a
// (batch, H, W, C) output, or, rows2-packed (H even), the pixel of a
// (batch, H/2, W, 2C) output whose channel half (y & 1) holds row y.  Times
// C, plus the channel, gives the element.
__host__ __device__ __forceinline__ long long out_pixel(long long img, int y, int x, int H,
                                                        int W, bool packed) {
  return packed ? ((img * (H / 2) + y / 2) * W + x) * 2 + (y & 1) : (img * H + y) * W + x;
}

// dtype codes shared with the Python wrappers
enum DType { kF32 = 0, kBF16 = 1 };

}  // namespace ebfi
