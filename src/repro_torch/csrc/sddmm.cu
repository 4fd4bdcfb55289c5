// Block-sampled dense-dense matmul (SDDMM) on Hopper:
//   out[e] = A[brow[e]*bm : +bm, :] @ B[:, bcol[e]*bn : +bn]   (e < n_blocks)
//   out[e] = 0                                                 (e >= n_blocks)
// with f32 accumulation and output of shape (bcap, bm, bn).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sddmm/kernel.py
// (pallas_call_sddmm, body _kernel), whose grid (bcap, d_tiles) carries the
// block's sum in VMEM across the sequential contraction axis.
//
// Design.  The contraction axis becomes a loop inside the CTA: one CTA owns
// one (block, row sub-tile, column sub-tile) of the output and walks d in
// order, keeping the sum in registers, so nothing carries between CTAs and
// no atomics are needed.  Each step stages a (TM x TK) slice of the block's
// A row-panel and a (TK x TN) slice of its B column-panel in shared memory
// as f32 (bf16 inputs are widened on load); each of the 256 threads
// accumulates a 4 x 4 micro-tile with plain f32 FMA (no TF32), so f32
// inputs meet 1e-5 against the plain version.  Lanes at or past n_blocks
// write zeros and read nothing.  Any bm, bn and d work: edges are masked.
//
// Bound at the smoke shape (4096 tokens, d = 512, 128 x 128 blocks, 61
// blocks over 27 block-rows and 27 block-columns, f32): 1.0 GFLOP over the
// card's f32 FMA rate (67 TFLOP/s) gives 15 us, above the 5.4 us of the
// 18 MB of panels and output.  Known gap: plain FMA from shared memory
// reaches a fraction of that; wgmma with TMA-fed panels (and a bf16 path on
// the tensor cores) is the redesign left to a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;    // output rows per CTA (within one block)
constexpr int TN = 64;    // output columns per CTA (within one block)
constexpr int TK = 16;    // contraction slice staged per step
constexpr int NT = 256;   // threads per CTA: 16 x 16, each 4 x 4 outputs

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
sddmm_kernel(const int* __restrict__ brow, const int* __restrict__ bcol,
             const T* __restrict__ a, const T* __restrict__ b,
             float* __restrict__ out, int n_blocks, int bm, int bn, int d,
             int n) {
  __shared__ float As[TK][TM];
  __shared__ float Bs[TK][TN];
  const int msub = (bm + TM - 1) / TM;
  const int nsub = (bn + TN - 1) / TN;
  const int e = blockIdx.x / (msub * nsub);
  const int sub = blockIdx.x % (msub * nsub);
  const int m0 = (sub / nsub) * TM;
  const int n0 = (sub % nsub) * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (e < n_blocks) {
    const T* apan = a + (size_t)brow[e] * bm * d;   // (bm, d) row-panel
    const T* bpan = b + (size_t)bcol[e] * bn;       // (d, bn) column-panel
    for (int k0 = 0; k0 < d; k0 += TK) {
      for (int i = tid; i < TM * TK; i += NT) {
        const int mm = i / TK, kk = i % TK;
        const int gm = m0 + mm, gk = k0 + kk;
        As[kk][mm] = (gm < bm && gk < d)
                         ? to_f32(apan[(size_t)gm * d + gk]) : 0.f;
      }
      for (int i = tid; i < TK * TN; i += NT) {
        const int kk = i / TN, nn = i % TN;
        const int gk = k0 + kk, gn = n0 + nn;
        Bs[kk][nn] = (gk < d && gn < bn)
                         ? to_f32(bpan[(size_t)gk * n + gn]) : 0.f;
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

  float* oblk = out + (size_t)e * bm * bn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= bm) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < bn) oblk[(size_t)gm * bn + gn] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* brow, const void* bcol, const void* a, const void* b,
           void* out, int bcap, int n_blocks, int bm, int bn, int d, int n,
           void* stream) {
  const int msub = (bm + TM - 1) / TM;
  const int nsub = (bn + TN - 1) / TN;
  dim3 grid((unsigned)(bcap * msub * nsub));
  sddmm_kernel<T><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const int*)brow, (const int*)bcol, (const T*)a, (const T*)b,
      (float*)out, n_blocks, bm, bn, d, n);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (loaded with ctypes).  a is (m, d) and b is (d, n), both
// f32 or both bf16, contiguous; out is (bcap, bm, bn) f32.  Returns
// cudaGetLastError() after the launch.
extern "C" int sddmm_f32(const void* brow, const void* bcol, const void* a,
                         const void* b, void* out, int bcap, int n_blocks,
                         int bm, int bn, int d, int n, void* stream) {
  return launch<float>(brow, bcol, a, b, out, bcap, n_blocks, bm, bn, d, n,
                       stream);
}

extern "C" int sddmm_bf16(const void* brow, const void* bcol, const void* a,
                          const void* b, void* out, int bcap, int n_blocks,
                          int bm, int bn, int d, int n, void* stream) {
  return launch<__nv_bfloat16>(brow, bcol, a, b, out, bcap, n_blocks, bm,
                               bn, d, n, stream);
}
