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
//
// Two byte codecs of the ingest and render paths live here too:
// - lz4_frame_decode: LZ4 frames (the format of ROS bags' lz4 chunks), every
//   bound checked, the header, block and content checksums (xxHash32)
//   verified; returns the decoded size or a negative error code.
// - gif_lzw: the LZW code stream of one GIF image, variable-width codes of
//   up to 12 bits, a clear code whenever the table fills (giflib's order).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kP1 = 2654435761U, kP2 = 2246822519U, kP3 = 3266489917U,
                   kP4 = 668265263U, kP5 = 374761393U;

inline uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}

uint32_t xxh32(const uint8_t* p, int64_t n, uint32_t seed) {
  const uint8_t* end = p + n;
  uint32_t h;
  if (n >= 16) {
    uint32_t v[4] = {seed + kP1 + kP2, seed + kP2, seed, seed - kP1};
    for (; end - p >= 16; p += 16)
      for (int i = 0; i < 4; ++i) v[i] = rotl(v[i] + le32(p + 4 * i) * kP2, 13) * kP1;
    h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
  } else {
    h = seed + kP5;
  }
  h += uint32_t(n);
  for (; end - p >= 4; p += 4) h = rotl(h + le32(p) * kP3, 17) * kP4;
  for (; p < end; ++p) h = rotl(h + *p * kP5, 11) * kP1;
  h ^= h >> 15;
  h *= kP2;
  h ^= h >> 13;
  h *= kP3;
  h ^= h >> 16;
  return h;
}

enum Lz4Error : int64_t {
  kTruncated = -1, kBadMagic = -2, kUnsupported = -3, kChecksum = -4, kOverflow = -5,
  kBadOffset = -6,
};

// One LZ4 block into dst[pos, cap); matches may reach back to `window`.
int64_t lz4_block(const uint8_t* ip, const uint8_t* iend, uint8_t* dst, int64_t pos,
                  int64_t cap, int64_t window) {
  while (true) {
    if (ip >= iend) return kTruncated;
    const int token = *ip++;
    int64_t lit = token >> 4;
    if (lit == 15) {
      int b;
      do {
        if (ip >= iend) return kTruncated;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (lit > iend - ip) return kTruncated;
    if (lit > cap - pos) return kOverflow;
    std::memcpy(dst + pos, ip, size_t(lit));
    pos += lit;
    ip += lit;
    if (ip == iend) return pos;  // the last sequence holds literals only
    if (iend - ip < 2) return kTruncated;
    const int64_t offset = int64_t(ip[0]) | int64_t(ip[1]) << 8;
    ip += 2;
    if (offset == 0 || offset > pos - window) return kBadOffset;
    int64_t match = token & 15;
    if (match == 15) {
      int b;
      do {
        if (ip >= iend) return kTruncated;
        b = *ip++;
        match += b;
      } while (b == 255);
    }
    match += 4;
    if (match > cap - pos) return kOverflow;
    for (int64_t i = 0; i < match; ++i, ++pos) dst[pos] = dst[pos - offset];  // may overlap
  }
}

}  // namespace

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

// LZ4 frames (concatenated frames and skippable frames too) from src[0, n)
// into dst[0, cap).  Returns the number of bytes written or an Lz4Error.
int64_t ebfi_lz4_frame_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  const uint8_t* ip = src;
  const uint8_t* end = src + n;
  int64_t pos = 0;
  while (ip < end) {
    if (end - ip < 4) return kTruncated;
    const uint32_t magic = le32(ip);
    ip += 4;
    if ((magic & 0xFFFFFFF0U) == 0x184D2A50U) {  // skippable frame
      if (end - ip < 4) return kTruncated;
      const int64_t size = le32(ip);
      ip += 4;
      if (size > end - ip) return kTruncated;
      ip += size;
      continue;
    }
    if (magic != 0x184D2204U) return kBadMagic;
    const uint8_t* desc = ip;
    if (end - ip < 3) return kTruncated;
    const int flg = ip[0], bd = ip[1];
    ip += 2;
    if ((flg >> 6) != 1 || (flg & 0x02) || (bd & 0x8F)) return kUnsupported;
    if (flg & 0x01) return kUnsupported;  // a dictionary id: no dictionaries here
    const bool independent = flg & 0x20, block_sum = flg & 0x10, content_sum = flg & 0x04;
    const int size_id = (bd >> 4) & 7;
    if (size_id < 4) return kUnsupported;
    const int64_t block_max = int64_t(1) << (8 + 2 * size_id);
    if (flg & 0x08) {
      if (end - ip < 8) return kTruncated;
      ip += 8;  // the content size: the caller knows the size it expects
    }
    if (end - ip < 1) return kTruncated;
    if (((xxh32(desc, ip - desc, 0) >> 8) & 0xFF) != *ip) return kChecksum;
    ++ip;
    const int64_t frame_start = pos;
    while (true) {
      if (end - ip < 4) return kTruncated;
      const uint32_t word = le32(ip);
      ip += 4;
      if (word == 0) break;  // the end mark
      const int64_t size = word & 0x7FFFFFFFU;
      if (size > block_max) return kUnsupported;
      if (size > end - ip) return kTruncated;
      if (block_sum) {
        if (end - ip - size < 4) return kTruncated;
        if (xxh32(ip, size, 0) != le32(ip + size)) return kChecksum;
      }
      if (word & 0x80000000U) {  // stored uncompressed
        if (size > cap - pos) return kOverflow;
        std::memcpy(dst + pos, ip, size_t(size));
        pos += size;
      } else {
        const int64_t got = lz4_block(ip, ip + size, dst, pos, cap,
                                      independent ? pos : frame_start);
        if (got < 0) return got;
        pos = got;
      }
      ip += size + (block_sum ? 4 : 0);
    }
    if (content_sum) {
      if (end - ip < 4) return kTruncated;
      if (xxh32(dst + frame_start, pos - frame_start, 0) != le32(ip)) return kChecksum;
      ip += 4;
    }
  }
  return pos;
}

uint32_t ebfi_xxh32(const uint8_t* p, int64_t n, uint32_t seed) { return xxh32(p, n, seed); }

// The LZW code stream of one GIF image: `idx` holds n palette indices below
// 2^min_code_size (2..8).  Codes are packed LSB first into out[0, cap).
// Returns the number of bytes written, or -1 when out is too small.
int64_t ebfi_gif_lzw(const uint8_t* idx, int64_t n, int min_code_size, uint8_t* out,
                     int64_t cap) {
  const int clear = 1 << min_code_size, eoi = clear + 1;
  std::vector<uint32_t> stamp(size_t(4096) << 8, 0);  // (prefix code, byte) -> generation
  std::vector<uint16_t> codes(size_t(4096) << 8);
  uint32_t gen = 1;
  int width = min_code_size + 1, next = eoi + 1;
  uint64_t acc = 0;
  int bits = 0;
  int64_t pos = 0;
  bool full = false;
  auto put = [&](int code) {
    acc |= uint64_t(code) << bits;
    bits += width;
    while (bits >= 8) {
      if (pos >= cap) {
        full = true;
        return;
      }
      out[pos++] = uint8_t(acc & 255);
      acc >>= 8;
      bits -= 8;
    }
    if (next >= (1 << width) && width < 12) ++width;
  };
  put(clear);
  if (n > 0) {
    int cur = idx[0];
    for (int64_t i = 1; i < n && !full; ++i) {
      const size_t key = size_t(cur) << 8 | idx[i];
      if (stamp[key] == gen) {
        cur = codes[key];
        continue;
      }
      put(cur);
      cur = idx[i];
      if (next >= 4095) {  // the table is full: start it again
        put(clear);
        width = min_code_size + 1;
        next = eoi + 1;
        ++gen;
      } else {
        stamp[key] = gen;
        codes[key] = uint16_t(next++);
      }
    }
    put(cur);
  }
  put(eoi);
  if (bits > 0 && !full) {
    if (pos >= cap) return -1;
    out[pos++] = uint8_t(acc & 255);
  }
  return full ? -1 : pos;
}

}  // extern "C"
