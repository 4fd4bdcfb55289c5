// Block-CSR SpMM on Hopper: C = A_bcsr @ B, f32 accumulation and output.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bcsr_spmm/kernel.py
// (pallas_call_bcsr, body _kernel), whose sequential grid (k_tiles, bcap)
// revisits one output tile in VMEM for consecutive blocks of a block-row.
//
// Design.  Blocks of a GPU grid run in parallel and in no order, so the
// sequential block axis becomes a loop inside the CTA: one CTA owns one
// (block-row, row sub-tile, column tile) output tile and walks its row's
// live blocks [indptr[r], min(indptr[r+1], n_blocks)) in order, keeping the
// sum in registers.  The block order per output element is the Pallas
// grid's, no atomics are needed, and every output element is written once
// (rows without live blocks are written as zeros, as ops.py masks them).
// Each step stages a (TM x TK) slice of the A block and the matching
// (TK x TN) slice of B's block-row in shared memory as f32 (bf16 inputs
// are widened on load), and each of the 256 threads accumulates a 4 x 4
// micro-tile with plain f32 FMA (no TF32), so f32 inputs meet 1e-5 against
// the plain version.  Any bm, bn and column count work: edges are masked.
//
// Bound at the smoke shape (1024 x 1024 A, 128 x 128 blocks at 12.5%
// density, k = 512, f32): the 10 live blocks, the 6 B block-rows they name
// and C move 4.3 MB (1.3 us at 3.35 TB/s) and take 0.17 GFLOP, so the
// card's f32 FMA rate (67 TFLOP/s) bounds it at 2.5 us.  Known gap: plain
// FMA from shared memory reaches a fraction of that, and only 80 of the 128
// CTAs have work; wgmma with TMA-fed tiles (and a bf16 path on the tensor
// cores) is the redesign left to a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;    // output rows per CTA (within one block-row)
constexpr int TN = 64;    // output columns per CTA
constexpr int TK = 16;    // contraction slice staged per step
constexpr int NT = 256;   // threads per CTA: 16 x 16, each 4 x 4 outputs

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
bcsr_spmm_kernel(const int* __restrict__ indptr,
                 const int* __restrict__ indices,
                 const T* __restrict__ blocks, const T* __restrict__ b,
                 float* __restrict__ out, int bm, int bn, int kp,
                 int n_blocks) {
  __shared__ float As[TK][TM];
  __shared__ float Bs[TK][TN];
  const int msub = (bm + TM - 1) / TM;
  const int r = blockIdx.x / msub;
  const int m0 = (blockIdx.x % msub) * TM;
  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int e0 = indptr[r];
  const int e1 = min(indptr[r + 1], n_blocks);
  for (int e = e0; e < e1; ++e) {
    const T* blk = blocks + (size_t)e * bm * bn;
    const T* bsrc = b + (size_t)indices[e] * bn * kp;
    for (int k0 = 0; k0 < bn; k0 += TK) {
      for (int i = tid; i < TM * TK; i += NT) {
        const int mm = i / TK, kk = i % TK;
        const int gm = m0 + mm, gk = k0 + kk;
        As[kk][mm] = (gm < bm && gk < bn)
                         ? to_f32(blk[(size_t)gm * bn + gk]) : 0.f;
      }
      for (int i = tid; i < TK * TN; i += NT) {
        const int kk = i / TN, nn = i % TN;
        const int gk = k0 + kk, gn = n0 + nn;
        Bs[kk][nn] = (gk < bn && gn < kp)
                         ? to_f32(bsrc[(size_t)gk * kp + gn]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= bm) continue;
    float* orow = out + ((size_t)r * bm + gm) * kp;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < kp) orow[gn] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* indptr, const void* indices, const void* blocks,
           const void* b, void* out, int mb, int bm, int bn, int kp,
           int n_blocks, void* stream) {
  const int msub = (bm + TM - 1) / TM;
  dim3 grid((unsigned)(mb * msub), (unsigned)((kp + TN - 1) / TN));
  bcsr_spmm_kernel<T><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const int*)indptr, (const int*)indices, (const T*)blocks,
      (const T*)b, (float*)out, bm, bn, kp, n_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (loaded with ctypes).  out is (mb * bm, kp) f32; blocks is
// (bcap, bm, bn) and b is (nb * bn, kp), both f32 or both bf16, contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int bcsr_spmm_f32(const void* indptr, const void* indices,
                             const void* blocks, const void* b, void* out,
                             int mb, int bm, int bn, int kp, int n_blocks,
                             void* stream) {
  return launch<float>(indptr, indices, blocks, b, out, mb, bm, bn, kp,
                       n_blocks, stream);
}

extern "C" int bcsr_spmm_bf16(const void* indptr, const void* indices,
                              const void* blocks, const void* b, void* out,
                              int mb, int bm, int bn, int kp, int n_blocks,
                              void* stream) {
  return launch<__nv_bfloat16>(indptr, indices, blocks, b, out, mb, bm, bn,
                               kp, n_blocks, stream);
}
