// The sharded fused exact solve's two chunk kernels for sm_90a, bound with
// ctypes (plain C entry points at the end of this file). One launch runs
// one chunk of one rank; the host loop around them (factor_fused_shard.py)
// sums the owner-masked diagonals and B operands over the ranks with
// torch.distributed between the launches.
//
//   ab_chunk_kernel (K6) replaces slip_lu_tpu/parallel/factor_fused_shard.py:
//     _ab_kernel (launched by _ab_call). Factor mode: the chunk's heads from
//     the all-reduced diagonals (replicated on every rank, so SMT, GT and
//     TZ stay bit-identical everywhere), the Hensel lift of the new pivot
//     inverses, the rank's pass 1, then the owner-masked gather of the
//     pass-2 B operands into bc_out (zeroed first: the all-reduce sums
//     every rank's buffer). Solve mode (no heads): pass 1 over X and the
//     gather of the broadcast X rows.
//   c_chunk_kernel (K7) replaces factor_fused_shard.py:_c_kernel (launched
//     by _c_call): the rank's pass 2. Factor mode: the B operands are
//     positions into the all-reduced bc, the A operands rows of the
//     rank's own value table. Solve mode: bc is first scattered into the X
//     rows bidx, and the A operands come from the finished value table.
//
// Layouts are the reference's, with the chunk's head block and counts in
// one row per chunk, meta [3H+5]: H head steps (pad -1), H LOCAL diag
// slots (the dummy row off the owner), H diag histories, the counts
// (heads, pass-1 events, pass-2 events, flag bits) and the broadcast count.
// val [Lp8, Wt] (the rank's slots; X [X8, Ws] in solve mode), SMT [n8, W8],
// GT [n8, WI8], TZ [n8, 8], diag [H, W8], bidx and mbc [CB8], bc [CB8, Wt],
// events field-major [5, C]. Flags are int32[8] (0 sing, 1 any overflow,
// 2 heads, 3 pass 1, 4 pass 2) and accumulate over the launches.
//
// Design: the chunk body of K2 (stream_body.cuh) on one block of up to 16
// warps: warp 0 runs the heads, one warp a head lifts, one warp an event
// computes a pass into scratch rows before a barrier and the scatter.
//
// What bounds it on an H100: a chunk carries at most a few hundred events
// of at most a few hundred limbs, so the bound (bytes of the chunk's rows
// and limb products, see chip_smoke.py) is microseconds, while each launch
// costs the host a few microseconds and the chunk's dependent phases a few
// more on one SM. Two launches and two all-reduces a chunk make the path
// host-bound by design; a CUDA graph over the chunk loop, or several
// chunks a launch at world size 1, is later work.

#include "stream_body.cuh"

namespace slip {

__global__ void __launch_bounds__(kMaxThreads)
ab_chunk_kernel(const int* hm, const int* ev1, const int* bidx,
                const int* mbc, const int* diag, int* val, int* SMT, int* GT,
                int* TZ, int* flags, int* bc_out, int* obuf, int CB8,
                Dims d) {
  extern __shared__ long long smem_ll[];
  __shared__ int s_flags[8];
  if (threadIdx.x < 8) s_flags[threadIdx.x] = flags[threadIdx.x];
  Warp w = warp_scratch((char*)smem_ll, d.L);
  const int* cnt = hm + 3 * d.H;
  __syncthreads();
  if (d.H > 0 && cnt[0] > 0)
    run_heads_and_lift(hm, diag, val, SMT, GT, TZ, d, w, s_flags);
  run_pass(ev1, d.C1, cnt[1], val, val, val, false, SMT, GT, TZ, obuf, d, w,
           s_flags, 3);
  // the B operands after pass 1, owner-masked; rows past the chunk's count
  // are zero
  const int nb = cnt[4];
  for (int i = threadIdx.x; i < CB8 * d.Wt; i += blockDim.x) {
    const int e = i / d.Wt;
    bc_out[i] = e < nb
        ? val[(size_t)bidx[e] * d.Wt + (i - e * d.Wt)] * mbc[e] : 0;
  }
  __syncthreads();
  if (threadIdx.x < 8) flags[threadIdx.x] = s_flags[threadIdx.x];
}

__global__ void __launch_bounds__(kMaxThreads)
c_chunk_kernel(const int* hm, const int* ev2, const int* bidx, const int* bc,
               const int* a_src, int* val, const int* SMT, const int* GT,
               const int* TZ, int* flags, int* obuf, Dims d) {
  extern __shared__ long long smem_ll[];
  __shared__ int s_flags[8];
  if (threadIdx.x < 8) s_flags[threadIdx.x] = flags[threadIdx.x];
  Warp w = warp_scratch((char*)smem_ll, d.L);
  const int* cnt = hm + 3 * d.H;
  const bool solve = a_src != nullptr;
  if (solve) {                         // the broadcast X rows land first
    const int nb = cnt[4];
    for (int i = threadIdx.x; i < nb * d.Wt; i += blockDim.x) {
      const int e = i / d.Wt;
      val[(size_t)bidx[e] * d.Wt + (i - e * d.Wt)] = bc[i];
    }
  }
  __syncthreads();
  run_pass(ev2, d.C2, cnt[2], val, solve ? a_src : val, solve ? val : bc,
           true, SMT, GT, TZ, obuf, d, w, s_flags, 4);
  __syncthreads();
  if (threadIdx.x < 8) flags[threadIdx.x] = s_flags[threadIdx.x];
}

// The dynamic shared memory limit is raised once per size: the chunk loop
// launches these kernels tens of thousands of times a solve.
template <typename K>
static int ensure_smem(K kernel, int nwarps, int L, size_t* smem,
                       size_t* raised) {
  *smem = (size_t)nwarps * kWarpBytesPerLimb * L;
  if (*smem <= *raised) return 0;
  int rc = launch_cfg(kernel, nwarps, L, smem);
  if (rc == 0) *raised = *smem;
  return rc;
}

}  // namespace slip

// Plain C interface: every pointer (and the stream) is a void*, every size
// an int; diag and a_src may be null (no heads; factor mode). Each returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int slip_ab_chunk(const void* hm, const void* ev1,
                             const void* bidx, const void* mbc,
                             const void* diag, void* val, void* SMT,
                             void* GT, void* TZ, void* flags, void* bc_out,
                             void* obuf, int H, int C1, int CB8, int W8,
                             int Wt, int WN, int WQ, int WV, int WI8, int L,
                             int nwarps, void* stream) {
  static size_t raised = 0;
  slip::Dims d{1, H, C1, 0, W8, Wt, WN, WQ, WV, WI8, L};
  size_t smem;
  int rc = slip::ensure_smem(slip::ab_chunk_kernel, nwarps, L, &smem,
                             &raised);
  if (rc != 0) return rc;
  slip::ab_chunk_kernel<<<1, nwarps * 32, smem, (cudaStream_t)stream>>>(
      (const int*)hm, (const int*)ev1, (const int*)bidx, (const int*)mbc,
      (const int*)diag, (int*)val, (int*)SMT, (int*)GT, (int*)TZ,
      (int*)flags, (int*)bc_out, (int*)obuf, CB8, d);
  return (int)cudaGetLastError();
}

extern "C" int slip_c_chunk(const void* hm, const void* ev2,
                            const void* bidx, const void* bc,
                            const void* a_src, void* val, const void* SMT,
                            const void* GT, const void* TZ, void* flags,
                            void* obuf, int H, int C2, int W8, int Wt, int WN,
                            int WQ, int WV, int WI8, int L, int nwarps,
                            void* stream) {
  static size_t raised = 0;
  slip::Dims d{1, H, 0, C2, W8, Wt, WN, WQ, WV, WI8, L};
  size_t smem;
  int rc = slip::ensure_smem(slip::c_chunk_kernel, nwarps, L, &smem,
                             &raised);
  if (rc != 0) return rc;
  slip::c_chunk_kernel<<<1, nwarps * 32, smem, (cudaStream_t)stream>>>(
      (const int*)hm, (const int*)ev2, (const int*)bidx, (const int*)bc,
      (const int*)a_src, (int*)val, (const int*)SMT, (const int*)GT,
      (const int*)TZ, (int*)flags, (int*)obuf, d);
  return (int)cudaGetLastError();
}
