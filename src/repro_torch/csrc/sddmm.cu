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
// a 128 x 64 output tile of one block and walks d in order with the shared
// f32 tile core (tile_f32.cuh: 8 x 8 outputs a thread, 16-deep
// double-buffered shared-memory slices, plain f32 FMA, never TF32), so
// nothing carries between CTAs and no atomics are needed.  bf16 inputs are
// widened on load.  Lanes at or past n_blocks write zeros and read
// nothing.  Any bm, bn and d work: edges are masked; 4-element vector loads
// are chosen by the launcher when d, n, bn and the base pointers allow
// them.
//
// Bound at the leg's shape (4096 tokens, d = 512, 128 x 128 blocks, 61
// blocks over 27 block-rows and 27 block-columns, f32): 1.0 GFLOP over the
// card's f32 FMA rate (67 TFLOP/s) gives 15.3 us, above the 5.4 us of the
// 18 MB of panels and output.  A 128 x 64 tile gives 122 CTAs of 4 warps,
// one wave on 132 SMs with no split of d (splitting d between the two CTAs
// of a cluster, summed in a fixed order through distributed shared memory,
// measured slower); each CTA does 8.4 MFLOP, 16.5 us at one SM's share of
// the peak.
#include "tile_f32.cuh"

namespace {

constexpr int BM = 128, BN = 64;
using Core = tile_f32::Tile<BM, BN, 16>;

template <typename T, bool VEC>
__global__ void __launch_bounds__(Core::NT)
sddmm_kernel(const int* __restrict__ brow, const int* __restrict__ bcol,
             const T* __restrict__ a, const T* __restrict__ b,
             float* __restrict__ out, int n_blocks, int bm, int bn, int d,
             int n) {
  __shared__ __align__(16) Core::Smem smem;
  const int msub = (bm + BM - 1) / BM;
  const int nsub = (bn + BN - 1) / BN;
  const int e = blockIdx.x / (msub * nsub);
  const int sub = blockIdx.x % (msub * nsub);
  const int m0 = (sub / nsub) * BM, n0 = (sub % nsub) * BN;
  const int mv = min(BM, bm - m0), nv = min(BN, bn - n0);
  Core core;
  core.fill(0.f);
  if (e < n_blocks)   // CTA-uniform: the barriers inside are all reached
    core.mma<T, VEC>(a + ((size_t)brow[e] * bm + m0) * d, d, 0, mv,
                     b + (size_t)bcol[e] * bn + n0, n, nv, d, smem);
  core.store(out + (size_t)e * bm * bn + (size_t)m0 * bn + n0, bn, 0, mv,
             nv);
}

template <typename T>
int launch(const void* brow, const void* bcol, const void* a, const void* b,
           void* out, int bcap, int n_blocks, int bm, int bn, int d, int n,
           void* stream) {
  const int msub = (bm + BM - 1) / BM;
  const int nsub = (bn + BN - 1) / BN;
  const dim3 grid((unsigned)(bcap * msub * nsub));
  const auto st = (cudaStream_t)stream;
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = d % 4 == 0 && n % 4 == 0 && bn % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a) % align) == 0 &&
                   (reinterpret_cast<uintptr_t>(b) % align) == 0;
  const auto ab = (const int*)brow;
  const auto ac = (const int*)bcol;
  if (vec)
    sddmm_kernel<T, true><<<grid, Core::NT, 0, st>>>(
        ab, ac, (const T*)a, (const T*)b, (float*)out, n_blocks, bm, bn, d,
        n);
  else
    sddmm_kernel<T, false><<<grid, Core::NT, 0, st>>>(
        ab, ac, (const T*)a, (const T*)b, (float*)out, n_blocks, bm, bn, d,
        n);
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
