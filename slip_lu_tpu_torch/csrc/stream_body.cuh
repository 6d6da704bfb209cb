// The chunk body shared by the stream kernels: K2/K3 (fused.cu) and the
// sharded chunk kernels K6/K7 (fused_shard.cu). Each .cu compiles on its
// own (no -rdc), so the pieces live in this header, static to each file.
//
//   pass_event / run_pass   one batched pass of
//                             out = (val[t] * SMT[m] - val[a] * B[b]) / rho[d]
//                           (the reference's _pass_body);
//   run_heads               a chunk's pivot heads (_heads_phase), the
//                           diagonals read from the value table or, for the
//                           sharded path, from the all-reduced rows diag_b
//                           (_heads_phase's diag_ext);
//   run_lift                the Hensel lift of a new pivot inverse
//                           (_lift_phase).
//
// Layouts: int32 limbs in 0..65535; val [E8, Wt], SMT [n8, W8], GT
// [n8, WI8], TZ [n8, 8]; the head block hm of a chunk is [3H+4]: H head
// steps (pad -1), H diag slots, H diag histories, then the counts (heads,
// pass-1 events, pass-2 events, flag bits; bit 256: a head needs a history
// fix); events are field-major [5, C] (t, m, d, a, b). Flags are int32[8]:
// 0 sing, 1 any overflow, 2 heads, 3 pass 1, 4 pass 2.
#pragma once

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

static __device__ __forceinline__ Warp warp_scratch(char* smem, int L) {
  Warp w;
  char* base = smem + (size_t)(threadIdx.x >> 5) * kWarpBytesPerLimb * L;
  w.cb = (long long*)base;
  for (int i = 0; i < kBufs; ++i) w.b[i] = (int*)(base + 8 * L + 4 * L * i);
  return w;
}

// One pass event: q = (T*M - A*B) / rho_d at width Wt -> out[0, Wt).
// Returns the event's overflow flag.
static __device__ bool pass_event(const int* ev, int C, int e, const int* tgt,
                                  const int* asrc, const int* bsrc,
                                  bool has_ab, const int* SMT, const int* GT,
                                  const int* TZ, const Dims& d, Warp& w,
                                  int* out) {
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
static __device__ void run_pass(const int* ev, int C, int cnt, int* tgt,
                                const int* asrc, const int* bsrc, bool has_ab,
                                const int* SMT, const int* GT, const int* TZ,
                                int* obuf, const Dims& d, Warp& w,
                                int* s_flags, int flag_slot) {
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

// The chunk's pivot heads, one after another (warp 0). diag: nullptr to
// read head t's diagonal from val[slot], else from row t of diag
// ([H, W8]: the sharded path's all-reduced diagonals).
static __device__ void run_heads(const int* hm, const int* diag, int* val,
                                 int* SMT, const int* GT, const int* TZ,
                                 const Dims& d, Warp& w, int* s_flags) {
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
    load_ext(X, diag ? diag + (size_t)t * W8 : val + (size_t)slot * W8, W8,
             W8);
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
static __device__ void run_lift(const int* hm, int t, const int* SMT, int* GT,
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

// A chunk's heads then the lift of its new pivots (every warp of the
// block calls it; barriers between the phases).
static __device__ void run_heads_and_lift(const int* hm, const int* diag,
                                          int* val, int* SMT, int* GT,
                                          int* TZ, const Dims& d, Warp& w,
                                          int* s_flags) {
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  if (warp == 0) run_heads(hm, diag, val, SMT, GT, TZ, d, w, s_flags);
  __syncthreads();
  for (int t = warp; t < d.H; t += nw) run_lift(hm, t, SMT, GT, TZ, d, w);
  __syncthreads();
}

template <typename K>
static int launch_cfg(K kernel, int nwarps, int L, size_t* smem) {
  *smem = (size_t)nwarps * kWarpBytesPerLimb * L;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

}  // namespace slip
