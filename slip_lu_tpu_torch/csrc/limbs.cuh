// Warp-cooperative multi-limb two's-complement arithmetic (kernel table
// entry K1): the device counterpart of ops/device_limbs.py, replacing the
// in-kernel helpers of slip_lu_tpu/ops/pallas_limbs.py and
// tpu/factor_fused.py:_signed_terms.
//
// A residue mod 2^(16*D) is D limbs of 16 bits, stored as int (0..65535)
// in a warp's shared-memory buffer; it reads as signed through bit 15 of
// its top limb. Every routine is called by all 32 lanes of one warp,
// splits its limbs across the lanes, and ends with __syncwarp(), so the
// next routine sees the result.
//
// Products are column sums of 16-bit limb products in int64: a signed
// operand contributes its top limb as a signed value, so the columns sum
// to the exact signed product, and one carry sweep reduces them mod
// 2^(16*D). The sweep is sequential on lane 0: at the slice's widths
// (D <= 56 on uni10k and uni100k) it costs less than a parallel prefix,
// and it keeps the kernels simple and exact.
#pragma once

#include <cstdint>

namespace slip {

constexpr int kMask16 = 0xFFFF;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Limb i of x (n limbs); with SIGNED the top limb counts negative.
template <bool SIGNED>
__device__ __forceinline__ long long limb_at(const int* x, int i, int n) {
  int v = x[i];
  if (SIGNED && i == n - 1) v -= (v >> 15) << 16;
  return (long long)v;
}

__device__ __forceinline__ int sign_fill(int top) {
  return (top >> 15) ? kMask16 : 0;
}

// dst[0, D) = src[0, W) two's-complement extended (or cut) to D limbs.
// src may be global or shared memory.
__device__ __forceinline__ void load_ext(int* dst, const int* src, int W,
                                         int D) {
  int fill = sign_fill(src[W - 1]);
  for (int k = lane_id(); k < D; k += 32) dst[k] = k < W ? src[k] : fill;
  __syncwarp();
}

// cb[k] (=, +=, -=) sum_{i+j=k} x_i * y_j for k < D.
// mode 0: set, 1: add, -1: subtract.
template <bool SX, bool SY>
__device__ __forceinline__ void columns(long long* cb, const int* x, int nx,
                                        const int* y, int ny, int D,
                                        int mode) {
  for (int k = lane_id(); k < D; k += 32) {
    long long s = 0;
    int lo = k - ny + 1 > 0 ? k - ny + 1 : 0;
    int hi = k < nx - 1 ? k : nx - 1;
    for (int i = lo; i <= hi; ++i)
      s += limb_at<SX>(x, i, nx) * limb_at<SY>(y, k - i, ny);
    cb[k] = mode == 0 ? s : (mode > 0 ? cb[k] + s : cb[k] - s);
  }
  __syncwarp();
}

// out[0, D) = sum_k cb[k] * 2^(16k) mod 2^(16*D); cb may be negative.
__device__ __forceinline__ void carry_out(int* out, const long long* cb,
                                          int D) {
  if (lane_id() == 0) {
    long long c = 0;
    for (int k = 0; k < D; ++k) {
      long long v = cb[k] + c;
      out[k] = (int)(v & kMask16);
      c = v >> 16;                      // arithmetic: floor division
    }
  }
  __syncwarp();
}

// out[0, Dout) = low limbs of floor(signed(x) / 2^tz), x of D limbs.
__device__ __forceinline__ void shr_bits(int* out, const int* x, int D,
                                         int tz, int Dout) {
  unsigned fill = (unsigned)sign_fill(x[D - 1]);
  int q = tz >> 4, r = tz & 15;
  for (int k = lane_id(); k < Dout; k += 32) {
    unsigned m = k + q < D ? (unsigned)x[k + q] : fill;
    unsigned nx = k + q + 1 < D ? (unsigned)x[k + q + 1] : fill;
    out[k] = (int)(((m >> r) | (nx << (16 - r))) & kMask16);
  }
  __syncwarp();
}

// Does the D-limb residue x hold a signed value that fits in W limbs?
__device__ __forceinline__ bool fits_in(const int* x, int W, int D) {
  int fill = sign_fill(x[W - 1]);
  bool ok = true;
  for (int k = W + lane_id(); k < D; k += 32) ok &= x[k] == fill;
  return __all_sync(0xffffffffu, ok);
}

// x (Wx limbs) and y (Wy limbs), both extended to D limbs, are equal.
__device__ __forceinline__ bool equal_ext(const int* x, int Wx, const int* y,
                                          int Wy, int D) {
  int fx = sign_fill(x[Wx - 1]), fy = sign_fill(y[Wy - 1]);
  bool ok = true;
  for (int k = lane_id(); k < D; k += 32)
    ok &= (k < Wx ? x[k] : fx) == (k < Wy ? y[k] : fy);
  return __all_sync(0xffffffffu, ok);
}

__device__ __forceinline__ bool is_zero(const int* x, int D) {
  bool ok = true;
  for (int k = lane_id(); k < D; k += 32) ok &= x[k] == 0;
  return __all_sync(0xffffffffu, ok);
}

// Trailing zero bits of a nonzero D-limb residue.
__device__ __forceinline__ int trailing_zero_bits(const int* x, int D) {
  unsigned first = 0xffffffffu;
  for (int k = lane_id(); k < D; k += 32)
    if (x[k] != 0 && (unsigned)k < first) first = (unsigned)k;
  first = __reduce_min_sync(0xffffffffu, first);
  if (first == 0xffffffffu) return 16 * D + 16;
  return 16 * (int)first + __ffs(x[first]) - 1;
}

// Newton inverse mod 2^16 of an odd limb.
__device__ __forceinline__ int inv16(int d) {
  unsigned ud = (unsigned)d & kMask16, x = ud;
  for (int it = 0; it < 4; ++it) x = (x * (2u - ud * x)) & kMask16;
  return (int)x;
}

// x[0, D) = inverse of the odd residue d (>= D limbs) mod 2^(16*D), by
// Newton doubling x <- x * (2 - d * x). t, u: scratch of D limbs.
__device__ __forceinline__ void inverse_mod(int* x, const int* d, int D,
                                            long long* cb, int* t, int* u) {
  if (lane_id() == 0) x[0] = inv16(d[0]);
  __syncwarp();
  int w = 1;
  while (w < D) {
    int w2 = 2 * w < D ? 2 * w : D;
    columns<false, false>(cb, d, w2, x, w, w2, 0);
    carry_out(t, cb, w2);
    for (int k = lane_id(); k < w2; k += 32)
      cb[k] = (long long)(kMask16 - t[k]) + (k == 0 ? 3 : 0);
    __syncwarp();
    carry_out(u, cb, w2);
    columns<false, false>(cb, x, w, u, w2, w2, 0);
    carry_out(x, cb, w2);
    w = w2;
  }
}

}  // namespace slip
