// The shared-operand multiply (kernel table entry K5) for sm_90a, bound
// with ctypes (plain C entry point at the end of this file).
//
//   mul_shared_kernel replaces slip_lu_tpu/ops/pallas_kernels.py:
//     _mul_shared_kernel (launched by mul_shared_digits_pallas): for B
//     magnitudes a[b] of La limbs and ONE shared magnitude s of Ls limbs,
//         out[b] = (a[b] * s) mod 2^(16*D),
//     D clean 16-bit limbs with every carry resolved. The TPU kernel's
//     output after its digit fold (pallas_kernels.py:144) is the same
//     residue, so the two agree bit for bit. Callers: every shared
//     multiply of the dense exact solve (ops/matarith.py): rho x M, the
//     exact division by a Hensel inverse, the Hensel doubling steps and
//     the TOL pivot tests.
//
// Layouts: a [B, La] and out [B, D] row-major int32, s [Ls] int32, every
// limb in 0..65535.
//
// Design. The TPU kernel cut limbs into 8-bit digits and multiplied by
// the shared operand's Toeplitz matrix in f32 on the matrix unit (exact
// only up to La = 257 digits). Here each output column is a sum of 16-bit
// limb products: a product is below 2^32, so one widening 32 x 32 -> 64
// multiply-add per term, and the int64 column sums are exact for any La
// below 2^31. One warp per row, eight warps a block, a grid-stride loop
// over the rows across all SMs (as K4). The shared operand sits in shared
// memory for the whole block; each warp stages its row of a there, its
// lanes take the output columns k = lane, lane + 32, ..., and one carry
// sweep on lane 0 turns the columns into limbs, which the warp writes out
// coalesced. Shared memory: 4*Ls + warps * (12*D + 4*La) bytes, 23 KB at
// the grid24 division (La = Ls = D = 179).
//
// What bounds it on an H100: at grid16's division (B = 65,536,
// La = Ls = D = 81) the work is 65,536 * 3,321 = 2.2e8 limb products, 0.9
// us at the card's exact integer peak (int8 on the tensor cores, 2.47e14
// limb products/s), against 42.5 MB of operands and results, 12.7 us at
// 3.35 TB/s: the bytes bound it, and so at every shape the dense path
// gives it. This kernel is further from that bound: its multiply-adds run
// on the CUDA cores, and the carry sweep serializes D steps on one lane
// per row. A parallel carry, byte products on the tensor cores (wgmma)
// and TMA loads are left to later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace slip {

constexpr int kMulSharedWarps = 8;
constexpr int kMulSharedMaxBlocks = 4096;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemTarget = 96 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

__host__ __device__ inline size_t mul_shared_smem(int warps, int La, int Ls,
                                                  int D) {
  return (size_t)warps * (12 * (size_t)D + 4 * (size_t)La) + 4 * (size_t)Ls;
}

__global__ void __launch_bounds__(kMulSharedWarps * 32)
mul_shared_kernel(const int* __restrict__ a, const int* __restrict__ s,
                  int* __restrict__ out, int B, int La, int Ls, int D) {
  extern __shared__ unsigned long long smem_u64[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned long long* cb = smem_u64 + (size_t)warp * D;       // columns
  unsigned* sh = (unsigned*)(smem_u64 + (size_t)warps * D);   // shared s
  unsigned* ar = sh + Ls + (size_t)warp * (La + D);           // row of a
  unsigned* ob = ar + La;                                      // its limbs
  for (int k = threadIdx.x; k < Ls; k += blockDim.x) sh[k] = (unsigned)s[k];
  __syncthreads();
  const long long stride = (long long)gridDim.x * warps;
  for (long long row = (long long)blockIdx.x * warps + warp; row < B;
       row += stride) {
    const int* arow = a + row * La;
    for (int i = lane; i < La; i += 32) ar[i] = (unsigned)arow[i];
    __syncwarp();
    for (int k = lane; k < D; k += 32) {
      const int lo = k - Ls + 1 > 0 ? k - Ls + 1 : 0;
      const int hi = k < La - 1 ? k : La - 1;
      unsigned long long sum = 0;
      for (int i = lo; i <= hi; ++i)
        sum += (unsigned long long)ar[i] * (unsigned long long)sh[k - i];
      cb[k] = sum;
    }
    __syncwarp();
    if (lane == 0) {
      unsigned long long c = 0;
      for (int k = 0; k < D; ++k) {
        const unsigned long long v = cb[k] + c;
        ob[k] = (unsigned)(v & 0xFFFFu);
        c = v >> 16;                    // carries past limb D-1 drop: mod
      }
    }
    __syncwarp();
    int* orow = out + row * D;
    for (int k = lane; k < D; k += 32) orow[k] = (int)ob[k];
    __syncwarp();
  }
}

}  // namespace slip

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue when one warp's buffers exceed shared memory.
extern "C" int slip_mul_shared(const void* a, const void* s, void* out,
                               int B, int La, int Ls, int D, void* stream) {
  if (B <= 0) return 0;
  int warps = slip::kMulSharedWarps;
  while (warps > 1 &&
         slip::mul_shared_smem(warps, La, Ls, D) > slip::kSmemTarget)
    warps >>= 1;
  const size_t smem = slip::mul_shared_smem(warps, La, Ls, D);
  if (smem > slip::kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > slip::kSmemDefault) {
    int rc = (int)cudaFuncSetAttribute(
        slip::mul_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != 0) return rc;
  }
  const long long want = ((long long)B + warps - 1) / warps;
  const int blocks = (int)(want < slip::kMulSharedMaxBlocks
                               ? want : slip::kMulSharedMaxBlocks);
  slip::mul_shared_kernel<<<blocks, warps * 32, smem,
                            (cudaStream_t)stream>>>(
      (const int*)a, (const int*)s, (int*)out, B, La, Ls, D);
  return (int)cudaGetLastError();
}
