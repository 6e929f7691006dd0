// Host data plane of the loader: event stacks, blur synthesis and event
// timestamp normalisation, bound with ctypes (ebfi_tpu_torch/native/__init__.py).
//
// Each function computes what its numpy plain version computes, bit for
// bit (ebfi_tpu_torch/data/encodings.py):
// - events_to_stack: f64 bin edges in the reference's op order
//   (dt = ts[n-1] - ts[0] + 1e-6, delta = dt / B, tstart = ts[0] + delta * b,
//   tend = tstart + delta), CLOSED bins found by binary search over the
//   sorted timestamps (an event on a shared edge lands in both bins), the
//   weights p * (p < 0 ? 0 : p) and p * (p > 0 ? 0 : p) summed per pixel in
//   f64 in event order and cast to f32 once, events whose truncated
//   coordinates fall outside the image dropped.  The caller returns zeros
//   for streams of <= 3 events or with ts.sum() == 0, numpy's own predicate.
// - blurry_mean: the uint8 frames summed in f64, the mean cast to f32, then
//   divided by 255 in f32; BGR in, RGB out.
// - normalize_ts: (ts - ts[0]) / (ts[n-1] - ts[0] + 1e-6) in f64.
// Build without FMA contraction or fast math (-ffp-contract=off): every
// product and sum is rounded on its own, as numpy rounds it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// out: float32 (H, W, 2 * B), zeroed by the caller, the loader's item
// layout: channel 2 * b + q of a pixel holds polarity q of bin b.
void ebfi_events_to_stack(const double* xs, const double* ys, const double* ts,
                          const double* ps, int64_t n, int num_bins, int64_t H, int64_t W,
                          float* out) {
  if (n <= 3) return;
  const double t0 = ts[0];
  const double dt = (ts[n - 1] - t0) + 1e-6;
  const double delta = dt / static_cast<double>(num_bins);
  // one bin's f64 sums, two per pixel; only the pixels its events touch are
  // written out and cleared again
  std::vector<double> acc(static_cast<size_t>(H * W) * 2, 0.0);
  std::vector<int64_t> touched;
  const double wd = static_cast<double>(W), hd = static_cast<double>(H);
  for (int b = 0; b < num_bins; ++b) {
    const double tstart = t0 + delta * static_cast<double>(b);
    const double tend = tstart + delta;
    const int64_t beg = std::lower_bound(ts, ts + n, tstart) - ts;
    const int64_t end = std::upper_bound(ts, ts + n, tend) - ts;
    touched.clear();
    for (int64_t i = beg; i < end; ++i) {
      // truncation toward zero lands in [0, W) exactly when -1 < x < W
      // (false for NaN, which numpy's cast sends out of range too)
      if (!(xs[i] > -1.0 && xs[i] < wd && ys[i] > -1.0 && ys[i] < hd)) continue;
      const int64_t pix = static_cast<int64_t>(ys[i]) * W + static_cast<int64_t>(xs[i]);
      const double p = ps[i];
      const double w_pos = p * (p < 0 ? 0.0 : p);
      const double w_neg = p * (p > 0 ? 0.0 : p);
      acc[2 * pix] += w_pos;
      acc[2 * pix + 1] += w_neg;
      touched.push_back(pix);
    }
    for (const int64_t pix : touched) {
      float* ob = out + pix * 2 * num_bins + 2 * b;
      for (int q = 0; q < 2; ++q) {
        double& a = acc[2 * pix + q];
        // a pixel touched twice is written at its first visit; a sum of
        // +0.0 writes nothing over the zeroed output (a sum starting at
        // +0.0 is never -0.0)
        if (a != 0.0 || std::isnan(a)) {
          ob[q] = static_cast<float>(a);
          a = 0.0;
        }
      }
    }
  }
}

// images: uint8 (N, H, W, 3) BGR; the mean of images[idx[0..n)] as float32
// (H, W, 3) RGB in [0, 1].
void ebfi_blurry_mean(const uint8_t* images, const int64_t* idx, int64_t n, int64_t H,
                      int64_t W, float* out) {
  const int64_t px = H * W;
  std::vector<double> acc(static_cast<size_t>(px) * 3, 0.0);
  for (int64_t f = 0; f < n; ++f) {
    const uint8_t* src = images + idx[f] * px * 3;
    for (int64_t i = 0; i < px; ++i) {
      acc[3 * i + 0] += src[3 * i + 2];
      acc[3 * i + 1] += src[3 * i + 1];
      acc[3 * i + 2] += src[3 * i + 0];
    }
  }
  const double dn = static_cast<double>(n);
  for (int64_t i = 0; i < px * 3; ++i) out[i] = static_cast<float>(acc[i] / dn) / 255.0f;
}

void ebfi_normalize_ts(const double* ts, int64_t n, double* out) {
  if (n == 0) return;
  const double t0 = ts[0];
  const double dt = (ts[n - 1] - t0) + 1e-6;
  for (int64_t i = 0; i < n; ++i) out[i] = (ts[i] - t0) / dt;
}

}  // extern "C"
