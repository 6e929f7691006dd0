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

// dtype codes shared with the Python wrappers
enum DType { kF32 = 0, kBF16 = 1 };

}  // namespace ebfi
