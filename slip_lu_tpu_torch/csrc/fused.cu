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
// the general formula.
//
// What bounds it on an H100: at the slice's widths (W8 = 16) the work per
// chunk is a few thousand multiply-adds, so the single block is bound by
// latency (barriers, lane-0 carry sweeps, one SM of 132) and by the
// chunk count, not by arithmetic. At W8 = 256 each event costs O(W8^2)
// 64-bit multiply-adds (about 2.3e5), which one SM runs slowly. Spreading
// independent chunks over many blocks and tiling the products are left to
// later work.

#include <cuda_runtime.h>

#include "limbs.cuh"

namespace slip {

struct Dims {
  int nc, H, C1, C2;
  int W8;    // value-table / SMT width
  int Wt;    // target and b-operand width (W8 factor, Ws8 solve)
  int WN;    // numerator modulus
  int WQ;    // short-division quotient modulus
  int WV;    // verification modulus
  int WI8;   // GT width
  int L;     // per-warp buffer length (>= every width above)
};

// 16 warps: the factor kernel needs ~120 registers a thread, and the
// SM's 65,536 registers hold 512 such threads.
constexpr int kMaxThreads = 512;
constexpr int kBufs = 10;
constexpr int kWarpBytesPerLimb = 8 + 4 * kBufs;

struct Warp {
  long long* cb;
  int* b[kBufs];
};

__device__ __forceinline__ Warp warp_scratch(char* smem, int L) {
  Warp w;
  char* base = smem + (size_t)(threadIdx.x >> 5) * kWarpBytesPerLimb * L;
  w.cb = (long long*)base;
  for (int i = 0; i < kBufs; ++i) w.b[i] = (int*)(base + 8 * L + 4 * L * i);
  return w;
}

// One pass event: q = (T*M - A*B) / rho_d at width Wt -> out[0, Wt).
// Returns the event's overflow flag.
__device__ bool pass_event(const int* ev, int C, int e, const int* tgt,
                           const int* asrc, const int* bsrc, bool has_ab,
                           const int* SMT, const int* GT, const int* TZ,
                           const Dims& d, Warp& w, int* out) {
  const int t = ev[e], m = ev[C + e], dv = ev[2 * C + e];
  const int a = ev[3 * C + e], b = ev[4 * C + e];
  int *T = w.b[0], *M = w.b[1], *A = w.b[2], *B = w.b[3], *num = w.b[4];
  int *sh = w.b[5], *G = w.b[6], *q = w.b[7], *V = w.b[8], *v = w.b[9];
  const int Wt = d.Wt, W8 = d.W8;
  load_ext(T, tgt + (size_t)t * Wt, Wt, Wt);
  int mw = W8;
  if (m == 0) {                       // SMT[0] = 1
    if (lane_id() == 0) M[0] = 1;
    __syncwarp();
    mw = 1;
  } else {
    load_ext(M, SMT + (size_t)m * W8, W8, W8);
  }
  columns<true, true>(w.cb, T, Wt, M, mw, d.WN, 0);
  if (has_ab) {
    load_ext(A, asrc + (size_t)a * W8, W8, W8);
    load_ext(B, bsrc + (size_t)b * Wt, Wt, Wt);
    columns<true, true>(w.cb, A, W8, B, Wt, d.WN, -1);
  }
  carry_out(num, w.cb, d.WN);
  bool bad;
  if (dv == 0) {                      // GT[0] = SMT[0] = 1, TZ[0] = 0
    load_ext(q, num, d.WN, d.WQ);
    bad = !equal_ext(q, d.WQ, num, d.WN, d.WV);
  } else {
    shr_bits(sh, num, d.WN, TZ[(size_t)dv * 8], d.WQ);
    load_ext(G, GT + (size_t)dv * d.WI8, d.WQ, d.WQ);
    columns<false, false>(w.cb, sh, d.WQ, G, d.WQ, d.WQ, 0);
    carry_out(q, w.cb, d.WQ);
    load_ext(V, SMT + (size_t)dv * W8, W8, W8);
    columns<true, true>(w.cb, q, d.WQ, V, W8, d.WV, 0);
    carry_out(v, w.cb, d.WV);
    bad = !equal_ext(v, d.WV, num, d.WN, d.WV);
  }
  const bool ovf = bad || !fits_in(q, Wt, d.WQ);
  for (int k = lane_id(); k < Wt; k += 32) out[k] = q[k];
  __syncwarp();
  return ovf;
}

// A pass: every event into obuf, a barrier, then the scatter.
__device__ void run_pass(const int* ev, int C, int cnt, int* tgt,
                         const int* asrc, const int* bsrc, bool has_ab,
                         const int* SMT, const int* GT, const int* TZ,
                         int* obuf, const Dims& d, Warp& w, int* s_flags,
                         int flag_slot) {
  if (cnt == 0) return;               // uniform across the block
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  for (int e = warp; e < cnt; e += nw) {
    bool ovf = pass_event(ev, C, e, tgt, asrc, bsrc, has_ab, SMT, GT, TZ, d,
                          w, obuf + (size_t)e * d.Wt);
    if (ovf && lane_id() == 0) {
      atomicOr(&s_flags[1], 1);
      atomicOr(&s_flags[flag_slot], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cnt * d.Wt; i += blockDim.x) {
    const int e = i / d.Wt;
    tgt[(size_t)ev[e] * d.Wt + (i - e * d.Wt)] = obuf[i];
  }
  __syncthreads();
}

// The chunk's pivot heads, one after another (warp 0).
__device__ void run_heads(const int* hm, int* val, int* SMT, const int* GT,
                          const int* TZ, const Dims& d, Warp& w,
                          int* s_flags) {
  const int H = d.H, W8 = d.W8;
  const int nh = hm[3 * H];
  const bool anyfix = (hm[3 * H + 3] & 256) != 0;
  int *X = w.b[0], *Mu = w.b[1], *num = w.b[4], *sh = w.b[5], *G = w.b[6];
  int *V = w.b[8], *v = w.b[9];
  int *R = w.b[7], *Rp = w.b[2];      // this head's rho, the previous one's
  for (int t = 0; t < H; ++t) {
    const int k = hm[t];
    if (k < 0) continue;
    const int slot = hm[H + t], dv = hm[2 * H + t];
    const bool live = t < nh;
    load_ext(X, val + (size_t)slot * W8, W8, W8);
    bool bad = false;
    if (anyfix && dv != k) {
      // history fix: rho = x * rho_{k-1} / rho_{dv-1}; a chain link takes
      // rho_{k-1} from the head just before it in this chunk
      const int* mult = Rp;
      if (!(t > 0 && hm[t - 1] == k - 1)) {
        load_ext(Mu, SMT + (size_t)k * W8, W8, W8);
        mult = Mu;
      }
      columns<true, true>(w.cb, X, W8, mult, W8, d.WN, 0);
      carry_out(num, w.cb, d.WN);
      shr_bits(sh, num, d.WN, TZ[(size_t)dv * 8], d.WQ);
      load_ext(G, GT + (size_t)dv * d.WI8, d.WQ, d.WQ);
      columns<false, false>(w.cb, sh, d.WQ, G, d.WQ, d.WQ, 0);
      carry_out(R, w.cb, d.WQ);
      load_ext(V, SMT + (size_t)dv * W8, W8, W8);
      columns<true, true>(w.cb, R, d.WQ, V, W8, d.WV, 0);
      carry_out(v, w.cb, d.WV);
      bad = !equal_ext(v, d.WV, num, d.WN, d.WV);
    } else {
      load_ext(R, X, W8, d.WQ);
    }
    const bool zer = is_zero(R, d.WQ);
    const bool hovf = !fits_in(R, W8, d.WQ);
    if (live && lane_id() == 0) {
      if (zer) atomicOr(&s_flags[0], 1);
      if (bad || hovf) {
        atomicOr(&s_flags[1], 1);
        atomicOr(&s_flags[2], 1);
      }
    }
    // a zero pivot is flagged and stored as 1
    for (int i = lane_id(); i < W8; i += 32) {
      const int r = zer ? (i == 0) : R[i];
      SMT[(size_t)(k + 1) * W8 + i] = r;
      val[(size_t)slot * W8 + i] = r;
    }
    __syncwarp();
    int* tmp = R;
    R = Rp;
    Rp = tmp;
  }
}

// Hensel lift of head t's new pivot: GT[k+1] = odd(rho)^-1 mod 2^(16*WI8),
// TZ[k+1] = its trailing zero bits (one warp).
__device__ void run_lift(const int* hm, int t, const int* SMT, int* GT,
                         int* TZ, const Dims& d, Warp& w) {
  const int k = hm[t];
  if (k < 0 || t >= hm[3 * d.H]) return;
  int *rho = w.b[0], *odd = w.b[1], *x = w.b[2];
  load_ext(rho, SMT + (size_t)(k + 1) * d.W8, d.W8, d.WI8);
  const int tz = trailing_zero_bits(rho, d.W8);
  shr_bits(odd, rho, d.WI8, tz, d.WI8);
  inverse_mod(x, odd, d.WI8, w.cb, w.b[3], w.b[4]);
  for (int i = lane_id(); i < d.WI8; i += 32)
    GT[(size_t)(k + 1) * d.WI8 + i] = x[i];
  if (lane_id() < 8) TZ[(size_t)(k + 1) * 8 + lane_id()] = tz;
  __syncwarp();
}

__global__ void __launch_bounds__(kMaxThreads)
factor_stream_kernel(const int* hmeta, const int* ev1,
                                     const int* ev2, int* val, int* SMT,
                                     int* GT, int* TZ, int* flags, int* obuf,
                                     Dims d) {
  extern __shared__ long long smem_ll[];
  __shared__ int s_flags[8];
  if (threadIdx.x < 8) s_flags[threadIdx.x] = 0;
  Warp w = warp_scratch((char*)smem_ll, d.L);
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int HM = 3 * d.H + 4;
  __syncthreads();
  for (int c = 0; c < d.nc; ++c) {
    const int* hm = hmeta + (size_t)c * HM;
    if (hm[3 * d.H] > 0) {
      if (warp == 0) run_heads(hm, val, SMT, GT, TZ, d, w, s_flags);
      __syncthreads();
      for (int t = warp; t < d.H; t += nw) run_lift(hm, t, SMT, GT, TZ, d, w);
      __syncthreads();
    }
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

template <typename K>
static int launch_cfg(K kernel, int nwarps, int L, size_t* smem) {
  *smem = (size_t)nwarps * kWarpBytesPerLimb * L;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
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
