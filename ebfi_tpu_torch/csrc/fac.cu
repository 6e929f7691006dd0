// Kernel B1: filter-adaptive convolution (FAC) apply with a given bank.
//
// Replaces the TPU kernel ebfi_tpu/ops/pallas/fac.py::_fac_kernel.
//   out[b,y,x,c] = sum_{ky,kx<K} xrep[b, y+ky-p, x+kx-p, c] * bank[b,y,x,(ky*K+kx)*C + c]
// with xrep the input replication-padded by p = (K-1)/2 (clamped indices
// here, no padded copy), NHWC, tap-major bank, f32 accumulation, output in
// the input dtype.
//
// Bound on the H100: memory.  Per output element it reads K*K bank values
// that nobody else reads (1600 channels at C=64, K=5) and does 2*K*K flops,
// far below the ~20 flop/byte (f32) needed to leave the memory bound.  The
// design streams the bank exactly once: one thread per output (b,y,x,c),
// neighbouring threads on neighbouring channels, so every bank and input
// read of a warp is one contiguous 128-byte (f32) segment.  The input is
// re-read K*K times but is 1/(K*K) of the bank and stays in L1/L2.
//
// Band mode (ebfi_fac_band_forward, spatial parallelism): x is a band of H
// output rows with its K-1 halo rows in place, (B, H + K - 1, W, C), the
// rows above and below from the neighbouring bands (or the replicated
// edge row at the image's own edges, filled by the caller).  Row y + ky of
// x is read as it is; only the column index is clamped.
#include <stdint.h>

#include "common.cuh"

namespace {

template <typename T, bool kBand>
__global__ void __launch_bounds__(256) fac_kernel(const T* __restrict__ x,
                                                  const T* __restrict__ bank,
                                                  T* __restrict__ out, int B, int H, int W,
                                                  int C, int K) {
  const long long total = (long long)B * H * W * C;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  const long long pix = idx / C;  // (b*H + y)*W + x
  const int xw = (int)(pix % W);
  const int y = (int)((pix / W) % H);
  const long long b = pix / ((long long)W * H);
  const int p = (K - 1) / 2;
  const T* bk = bank + pix * (long long)(K * K * C) + c;
  const int Hx = kBand ? H + K - 1 : H;  // rows of x
  const T* xb = x + b * Hx * W * C + c;
  float acc = 0.f;
  for (int ky = 0; ky < K; ++ky) {
    const int yy = kBand ? y + ky : min(max(y + ky - p, 0), H - 1);
    for (int kx = 0; kx < K; ++kx) {
      const int xx = min(max(xw + kx - p, 0), W - 1);
      acc += ebfi::to_f32(xb[((long long)yy * W + xx) * C]) *
             ebfi::to_f32(bk[(ky * K + kx) * C]);
    }
  }
  out[idx] = ebfi::from_f32<T>(acc);
}

template <typename T, bool kBand>
cudaError_t launch_fac(const void* x, const void* bank, void* out, int B, int H, int W, int C,
                       int K, cudaStream_t stream) {
  const long long total = (long long)B * H * W * C;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  fac_kernel<T, kBand><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bank), static_cast<T*>(out), B, H, W,
      C, K);
  return cudaGetLastError();
}

template <bool kBand>
int fac_forward(const void* x, const void* bank, void* out, int B, int H, int W, int C, int K,
                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || K <= 0 || K % 2 == 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == ebfi::kF32) return (int)launch_fac<float, kBand>(x, bank, out, B, H, W, C, K, s);
  if (dtype == ebfi::kBF16)
    return (int)launch_fac<__nv_bfloat16, kBand>(x, bank, out, B, H, W, C, K, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// H: the rows of bank and out; x has H rows (replication-padded by clamping)
extern "C" int ebfi_fac_forward(const void* x, const void* bank, void* out, int B, int H,
                                int W, int C, int K, int dtype, void* stream) {
  return fac_forward<false>(x, bank, out, B, H, W, C, K, dtype, stream);
}

// H: the rows of bank and out; x has H + K - 1 rows, its halo in place
extern "C" int ebfi_fac_band_forward(const void* x, const void* bank, void* out, int B, int H,
                                     int W, int C, int K, int dtype, void* stream) {
  return fac_forward<true>(x, bank, out, B, H, W, C, K, dtype, stream);
}

extern "C" const char* ebfi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
