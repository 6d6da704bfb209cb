// The segment-boundary Hensel re-lift (kernel table entry K4) for sm_90a,
// bound with ctypes (plain C entry point at the end of this file).
//
//   relift_gt_kernel replaces slip_lu_tpu/tpu/relift.py:_relift_kernel
//     (launched by relift_gt): every row r of the pivot-inverse table GT,
//     a residue mod 2^(16*WIo), is lifted to mod 2^(16*WIn) by Newton
//     doubling. Per row:
//         d = odd part of SMT[r] (its W8 limbs sign-extended to WIn and
//             shifted right by TZ[r][0] bits),
//         x = GT_old[r] zero-extended to WIn limbs,
//         steps times:  t = x*d,  u = 2 - t,  x = x*u   (mod 2^(16*WIn)).
//     The seed and the step count are the reference's, so rows whose seed
//     is not an inverse (zero rows, the identity row 0, rows written
//     after an overflow) come out bit-equal to it as well.
//
// Layouts are the reference's: int32 limbs in 0..65535, SMT [n8, >= W8]
// (row stride smt_stride), GT_old [n8, WIo], TZ [n8, 8], GT_new [n8, WIn].
//
// Design. Unlike the stream kernels (K2, K3), the rows are independent, so
// the grid spreads them over all SMs: one warp per row (grid-stride over
// rows), four warps a block. Each warp keeps x, d and t (3*WIn int32) and
// the int64 column sums (WIn) in its slice of dynamic shared memory:
// 20*WIn bytes, 5.3 KB at WIn = 264. The products are limbs.cuh's column
// sums and carry sweeps (K1).
//
// What bounds it on an H100: at uni100k's boundary (13,024 rows, WIo = 24
// -> WIn = 120, 3 steps) the work is 13,024 * 3 * 2 truncated products of
// 120*121/2 limb products, about 5.7e8 16-bit products, against 13.8 MB of
// table traffic (SMT 112 + GT_old 24 + TZ 8 + GT_new 120 limbs a row),
// about 4.1 us at 3.35 TB/s. The card's exact integer peak is int8 on the
// tensor cores, 1,979 TOP/s: at four byte products a limb product that is
// 2.47e14 limb products/s, so the products take about 2.3 us and the
// bytes bound it. The width ladder settles uni100k one rung higher
// (WIo = 40 -> WIn = 232): 2.1e9 products, 8.5 us, against 26.3 MB,
// 7.8 us, so there the operations bound it, barely. This kernel uses no
// tensor core: its multiply-adds run on the CUDA cores (32-bit IMAD,
// 1.67e13/s at 64 a clock on 132 SMs at 1.98 GHz, about 126 us of products
// at 40 -> 232), and each product ends in a carry sweep on one lane, which
// serializes WIn steps per product. Byte products on the tensor cores,
// parallel carries and tiled products are left to later work.

#include <cuda_runtime.h>

#include "limbs.cuh"

namespace slip {

constexpr int kReliftWarps = 4;
constexpr int kReliftBytesPerLimb = 8 + 4 * 3;

__global__ void __launch_bounds__(kReliftWarps * 32)
relift_gt_kernel(const int* SMT, const int* GT_old, const int* TZ,
                 int* GT_new, int rows, int smt_stride, int W8, int WIo,
                 int WIn, int steps) {
  extern __shared__ long long smem_ll[];
  const int warp = threadIdx.x >> 5;
  char* base = (char*)smem_ll + (size_t)warp * kReliftBytesPerLimb * WIn;
  long long* cb = (long long*)base;
  int* x = (int*)(base + 8 * WIn);
  int* d = x + WIn;
  int* t = d + WIn;
  const int stride = gridDim.x * kReliftWarps;
  for (int r = blockIdx.x * kReliftWarps + warp; r < rows; r += stride) {
    // the odd part of rho: sign-extend, then an arithmetic shift
    load_ext(t, SMT + (size_t)r * smt_stride, W8, WIn);
    shr_bits(d, t, WIn, TZ[(size_t)r * 8], WIn);
    for (int k = lane_id(); k < WIn; k += 32)
      x[k] = k < WIo ? GT_old[(size_t)r * WIo + k] : 0;
    __syncwarp();
    for (int s = 0; s < steps; ++s) {
      columns<false, false>(cb, x, WIn, d, WIn, WIn, 0);
      carry_out(t, cb, WIn);                      // t = x*d
      for (int k = lane_id(); k < WIn; k += 32)
        cb[k] = (long long)(kMask16 - t[k]) + (k == 0 ? 3 : 0);
      __syncwarp();
      carry_out(t, cb, WIn);                      // u = 2 - t
      columns<false, false>(cb, x, WIn, t, WIn, WIn, 0);
      carry_out(x, cb, WIn);                      // x = x*u
    }
    for (int k = lane_id(); k < WIn; k += 32)
      GT_new[(size_t)r * WIn + k] = x[k];
    __syncwarp();
  }
}

}  // namespace slip

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int slip_relift_gt(const void* SMT, const void* GT_old,
                              const void* TZ, void* GT_new, int rows,
                              int smt_stride, int W8, int WIo, int WIn,
                              int steps, void* stream) {
  if (rows <= 0) return 0;
  const size_t smem =
      (size_t)slip::kReliftWarps * slip::kReliftBytesPerLimb * WIn;
  int rc = (int)cudaFuncSetAttribute(
      slip::relift_gt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != 0) return rc;
  const int blocks = (rows + slip::kReliftWarps - 1) / slip::kReliftWarps;
  slip::relift_gt_kernel<<<blocks, slip::kReliftWarps * 32, smem,
                           (cudaStream_t)stream>>>(
      (const int*)SMT, (const int*)GT_old, (const int*)TZ, (int*)GT_new,
      rows, smt_stride, W8, WIo, WIn, steps);
  return (int)cudaGetLastError();
}
