// The fused exact solve's two stream kernels for sm_90a, bound with ctypes
// (plain C entry points at the end of this file).
//
//   factor_stream_kernel (K2) replaces slip_lu_tpu/tpu/factor_fused.py:
//     _factor_kernel (launched by factor_fused): per chunk the pivot heads
//     (_heads_phase), the Hensel lift of the new pivot inverses
//     (_lift_phase), then pass 1 and pass 2 of
//         out = (val[t] * SMT[m] - val[a] * B[b]) / rho[d]   (_pass_body).
//   solve_stream_kernel (K3) replaces tpu/factor_fused.py:_solve_kernel
//     (launched by solve_fused): the same two passes over X, with the
//     a-operands from the finished value table.
//
// Layouts at the boundary are the reference's: int32 limbs in 0..65535,
// val [E8, W8], SMT [n8, W8], GT [n8, WI8], TZ [n8, 8], X [X8, Ws8], the
// head/count block hmeta [nc, 3H+4] (counts [nc, 4] for the solve) and the
// field-major events [nc, 5, C] (t, m, d, a, b). Flags are int32[8]: 0 sing,
// 1 any overflow, 2 heads, 3 pass 1, 4 pass 2.
//
// Design. The chunks of a stream depend on each other in order (a chunk
// reads what earlier chunks wrote), like the TPU grid, so ONE block walks
// them with __syncthreads() between phases. Inside a chunk:
//   * warp 0 runs the heads one after another, so head k's history fix
//     multiplies by the rho of head k-1 computed just before (the
//     reference's speculative-then-refine scheme gives the same values);
//   * one warp per head lifts the new pivot inverses;
//   * one warp per event computes a pass (events round-robin over the
//     warps) into a scratch row, and only after a barrier does the block
//     scatter the rows: every read of a pass lands before any write.
// Each warp keeps its operands and products in its own slice of dynamic
// shared memory (48 bytes per limb of the widest width L, so the wrapper
// picks the warp count from L). Division is the reference's verified
// short division: the Hensel product at WQ = W+8 limbs, re-multiplied by
// the divisor at WV limbs and compared with the numerator, so a quotient
// that wraps can never pass, and fits_in(q, W) then detects overflow
// exactly. Events whose mult is row 0 (= 1) skip the product, and events
// whose div is row 0 skip the division; both give the same residues as
// the general formula. The chunk body (passes, heads, lift) is in
// stream_body.cuh, shared with the sharded chunk kernels of fused_shard.cu.
//
// What bounds it on an H100: at the slice's widths (W8 = 16) the work per
// chunk is a few thousand multiply-adds, so the single block is bound by
// latency (barriers, lane-0 carry sweeps, one SM of 132) and by the
// chunk count, not by arithmetic. At W8 = 256 each event costs O(W8^2)
// 64-bit multiply-adds (about 2.3e5), which one SM runs slowly. Spreading
// independent chunks over many blocks and tiling the products are left to
// later work.

#include "stream_body.cuh"

namespace slip {

__global__ void __launch_bounds__(kMaxThreads)
factor_stream_kernel(const int* hmeta, const int* ev1,
                                     const int* ev2, int* val, int* SMT,
                                     int* GT, int* TZ, int* flags, int* obuf,
                                     Dims d) {
  extern __shared__ long long smem_ll[];
  __shared__ int s_flags[8];
  if (threadIdx.x < 8) s_flags[threadIdx.x] = 0;
  Warp w = warp_scratch((char*)smem_ll, d.L);
  const int HM = 3 * d.H + 4;
  __syncthreads();
  for (int c = 0; c < d.nc; ++c) {
    const int* hm = hmeta + (size_t)c * HM;
    if (hm[3 * d.H] > 0)
      run_heads_and_lift(hm, nullptr, val, SMT, GT, TZ, d, w, s_flags);
    run_pass(ev1 + (size_t)c * 5 * d.C1, d.C1, hm[3 * d.H + 1], val, val,
             val, false, SMT, GT, TZ, obuf, d, w, s_flags, 3);
    run_pass(ev2 + (size_t)c * 5 * d.C2, d.C2, hm[3 * d.H + 2], val, val,
             val, true, SMT, GT, TZ, obuf, d, w, s_flags, 4);
  }
  __syncthreads();
  if (threadIdx.x < 8) flags[threadIdx.x] = s_flags[threadIdx.x];
}

__global__ void __launch_bounds__(kMaxThreads)
solve_stream_kernel(const int* cnts, const int* ev1,
                                    const int* ev2, const int* val,
                                    const int* SMT, const int* GT,
                                    const int* TZ, int* X, int* flags,
                                    int* obuf, Dims d) {
  extern __shared__ long long smem_ll[];
  __shared__ int s_flags[8];
  if (threadIdx.x < 8) s_flags[threadIdx.x] = 0;
  Warp w = warp_scratch((char*)smem_ll, d.L);
  __syncthreads();
  for (int c = 0; c < d.nc; ++c) {
    const int* cn = cnts + (size_t)c * 4;
    run_pass(ev1 + (size_t)c * 5 * d.C1, d.C1, cn[1], X, val, X, false, SMT,
             GT, TZ, obuf, d, w, s_flags, 3);
    run_pass(ev2 + (size_t)c * 5 * d.C2, d.C2, cn[2], X, val, X, true, SMT,
             GT, TZ, obuf, d, w, s_flags, 4);
  }
  __syncthreads();
  if (threadIdx.x < 8) flags[threadIdx.x] = s_flags[threadIdx.x];
}

}  // namespace slip

// Plain C interface: every pointer (and the stream) is a void*, every size
// an int. Each returns cudaGetLastError() after the launch (0 = launched).
extern "C" int slip_factor_stream(const void* hmeta, const void* ev1,
                                  const void* ev2, void* val, void* SMT,
                                  void* GT, void* TZ, void* flags, void* obuf,
                                  int nc, int H, int C1, int C2, int W8,
                                  int WN, int WQ, int WV, int WI8, int L,
                                  int nwarps, void* stream) {
  slip::Dims d{nc, H, C1, C2, W8, W8, WN, WQ, WV, WI8, L};
  size_t smem;
  int rc = slip::launch_cfg(slip::factor_stream_kernel, nwarps, L, &smem);
  if (rc != 0) return rc;
  slip::factor_stream_kernel<<<1, nwarps * 32, smem, (cudaStream_t)stream>>>(
      (const int*)hmeta, (const int*)ev1, (const int*)ev2, (int*)val,
      (int*)SMT, (int*)GT, (int*)TZ, (int*)flags, (int*)obuf, d);
  return (int)cudaGetLastError();
}

extern "C" int slip_solve_stream(const void* cnts, const void* ev1,
                                 const void* ev2, const void* val,
                                 const void* SMT, const void* GT,
                                 const void* TZ, void* X, void* flags,
                                 void* obuf, int nc, int C1, int C2, int W8,
                                 int Ws8, int WNS, int WQ, int WV, int WI8,
                                 int L, int nwarps, void* stream) {
  slip::Dims d{nc, 0, C1, C2, W8, Ws8, WNS, WQ, WV, WI8, L};
  size_t smem;
  int rc = slip::launch_cfg(slip::solve_stream_kernel, nwarps, L, &smem);
  if (rc != 0) return rc;
  slip::solve_stream_kernel<<<1, nwarps * 32, smem, (cudaStream_t)stream>>>(
      (const int*)cnts, (const int*)ev1, (const int*)ev2, (const int*)val,
      (const int*)SMT, (const int*)GT, (const int*)TZ, (int*)X, (int*)flags,
      (int*)obuf, d);
  return (int)cudaGetLastError();
}
