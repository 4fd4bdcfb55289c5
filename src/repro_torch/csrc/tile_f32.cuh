// Register-blocked f32 SIMT tile product, shared by group_matmul.cu (its
// tiled shape) and sddmm.cu.  Both compute a gathered row-panel of A times
// a gathered column-panel of B:
//
//   C[m, n] += sum_k A[m * lda + k] * B[k * ldb + n]
//   (lo <= m < hi, n < nv, k < K; rows, columns and depth masked)
//
// Bound.  A CTA tile of BM x BN outputs reads (BM + BN) K inputs for
// 2 BM BN K FLOPs: 21-32 FLOPs per f32 byte read from L2 at the two tiles
// in use (128 x 64, 128 x 128), above the card's f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20).  The f32 FMA pipe bounds it, and the design feeds it:
//
// * Each thread holds 8 x 8 outputs, in 2 x 2 blocks of 4 x 4 spaced BM / 2
//   rows and BN / 2 columns apart.  Every step of k reads them with four
//   16-byte shared-memory loads for 64 FMAs, and a warp is 4 x 8 threads,
//   so each of those loads is one shared-memory wavefront.  The next
//   step's fragments are read while this step's FMAs run.
// * BK-deep slices of A and B are double-buffered in shared memory: the
//   next slice's global loads are issued into registers before the current
//   slice's FMAs and land in the other buffer after them, one barrier per
//   slice.  Staging through registers is what lets A be transposed to
//   k-major (padded by 4 floats against bank conflicts) and bf16 be widened
//   on the way in; cp.async copies bytes as they are.
// * Plain f32 FMA, never TF32: f32 inputs keep the reference's 1e-5.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_f32 {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// the two bf16 halves of a 32-bit word, low half first, as f32
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// p[0..3] as f32, of which the first `n` exist (the rest read as 0).  VEC:
// one 16-byte (f32) or 8-byte (bf16) load when all four exist, which needs
// p aligned to it.
template <typename T, bool VEC>
__device__ __forceinline__ float4 load4(const T* p, int n) {
  if (VEC && n >= 4) {
    if constexpr (sizeof(T) == 4) {
      return __ldg(reinterpret_cast<const float4*>(p));
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                         bf16_hi(u.y));
    }
  }
  float4 v;
  v.x = n > 0 ? to_f32(p[0]) : 0.f;
  v.y = n > 1 ? to_f32(p[1]) : 0.f;
  v.z = n > 2 ? to_f32(p[2]) : 0.f;
  v.w = n > 3 ? to_f32(p[3]) : 0.f;
  return v;
}

template <bool B>
struct Flag {   // a compile-time bool to pass to a generic lambda
  static constexpr bool value = B;
};

template <int BM, int BN, int BK>
struct Tile {
  static constexpr int RM = 2, RN = 2;   // 4 x 4 blocks a thread
  static constexpr int TY = BM / (4 * RM), TX = BN / (4 * RN);
  static constexpr int NT = TY * TX;                 // threads per CTA
  static constexpr int A4 = BM * BK / 4, B4 = BK * BN / 4;   // float4s
  static constexpr int AL = (A4 + NT - 1) / NT, BL = (B4 + NT - 1) / NT;
  static_assert(TX % 8 == 0 && TY % 4 == 0, "a warp is 4 x 8 threads");
  static_assert(BK % 4 == 0, "slices are loaded as float4s along k");

  struct Smem {
    // k-major; a warp stores 32 / (BK / 4) rows at each of BK / 4 depths,
    // which the padding puts 0 or 16 banks apart (2-way at BK = 16)
    float a[2][BK][BM + 4];
    float b[2][BK][BN];
  };

  float acc[4 * RM][4 * RN];
  int ty, tx;

  __device__ Tile() {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    ty = (warp / (TX / 8)) * 4 + lane / 8;
    tx = (warp % (TX / 8)) * 8 + lane % 8;
  }

  __device__ __forceinline__ void fill(float v) {
#pragma unroll
    for (int i = 0; i < 4 * RM; ++i)
#pragma unroll
      for (int j = 0; j < 4 * RN; ++j) acc[i][j] = v;
  }

  // acc += A[lo..hi) @ B[:, 0..nv) over k < K.  CTA-uniform arguments
  // (the loop holds barriers).  VEC: lda, ldb, a and b allow 4-element
  // vector loads.
  template <typename T, bool VEC>
  __device__ void mma(const T* __restrict__ a, int lda, int lo, int hi,
                      const T* __restrict__ b, int ldb, int nv, int K,
                      Smem& s) {
    const int tid = threadIdx.x;
    // this thread's loads of a slice, fixed for the whole loop: A row m at
    // depth kq, B depth kb at columns nq (only k0 moves)
    const T* pa[AL];
    const T* pb[BL];
    bool oka[AL], okb[BL];
    int kqa[AL], kbb[BL], nvb[BL];
#pragma unroll
    for (int u = 0; u < AL; ++u) {
      const int i = tid + u * NT;
      const int m = i / (BK / 4);
      kqa[u] = (i % (BK / 4)) * 4;
      oka[u] = i < A4 && m >= lo && m < hi;
      pa[u] = a + (size_t)m * lda + kqa[u];
    }
#pragma unroll
    for (int u = 0; u < BL; ++u) {
      const int i = tid + u * NT;
      kbb[u] = i / (BN / 4);
      const int nq = (i % (BN / 4)) * 4;
      okb[u] = i < B4;
      nvb[u] = nv - nq;
      pb[u] = b + (size_t)kbb[u] * ldb + nq;
    }
    float4 ra[AL], rb[BL];
    // a slice that lies inside K loads without the depth masks
    auto fetch = [&](int k0, auto flag) {
      constexpr bool full = decltype(flag)::value;
#pragma unroll
      for (int u = 0; u < AL; ++u)
        ra[u] = oka[u] ? load4<T, VEC>(pa[u] + k0, full ? 4 : K - k0 - kqa[u])
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < BL; ++u)
        rb[u] = okb[u] && (full || k0 + kbb[u] < K)
                    ? load4<T, VEC>(pb[u] + (size_t)k0 * ldb, nvb[u])
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    auto fetch_any = [&](int k0) {
      if (k0 + BK <= K) fetch(k0, Flag<true>{});
      else fetch(k0, Flag<false>{});
    };
    auto stash = [&](int buf) {
#pragma unroll
      for (int u = 0; u < AL; ++u) {
        const int i = tid + u * NT;
        if (i < A4) {
          const int m = i / (BK / 4), kq = kqa[u];
          s.a[buf][kq][m] = ra[u].x;
          s.a[buf][kq + 1][m] = ra[u].y;
          s.a[buf][kq + 2][m] = ra[u].z;
          s.a[buf][kq + 3][m] = ra[u].w;
        }
      }
#pragma unroll
      for (int u = 0; u < BL; ++u) {
        const int i = tid + u * NT;
        if (i < B4)
          *reinterpret_cast<float4*>(
              &s.b[buf][kbb[u]][(i % (BN / 4)) * 4]) = rb[u];
      }
    };
    // fragments of depth kk: RM float4s of A, RN of B
    auto frag = [&](int buf, int kk, float (&av)[4 * RM],
                    float (&bv)[4 * RN]) {
#pragma unroll
      for (int p = 0; p < RM; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(
            &s.a[buf][kk][p * (BM / RM) + ty * 4]);
        av[4 * p] = v.x; av[4 * p + 1] = v.y;
        av[4 * p + 2] = v.z; av[4 * p + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            &s.b[buf][kk][q * (BN / RN) + tx * 4]);
        bv[4 * q] = v.x; bv[4 * q + 1] = v.y;
        bv[4 * q + 2] = v.z; bv[4 * q + 3] = v.w;
      }
    };
    // the fragments of depth kk + 1 are read while depth kk is multiplied
    auto compute = [&](int buf) {
      float av[2][4 * RM], bv[2][4 * RN];
      frag(buf, 0, av[0], bv[0]);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        if (kk + 1 < BK) frag(buf, kk + 1, av[(kk + 1) & 1], bv[(kk + 1) & 1]);
#pragma unroll
        for (int i = 0; i < 4 * RM; ++i)
#pragma unroll
          for (int j = 0; j < 4 * RN; ++j)
            acc[i][j] = fmaf(av[kk & 1][i], bv[kk & 1][j], acc[i][j]);
      }
    };

    const int nk = (K + BK - 1) / BK;
    if (nk == 0) return;
    fetch_any(0);
    stash(0);
    __syncthreads();
    for (int t = 0; t < nk; ++t) {
      if (t + 1 < nk) fetch_any((t + 1) * BK);   // in flight during the FMAs
      compute(t & 1);
      if (t + 1 < nk) stash((t + 1) & 1);
      __syncthreads();
    }
  }

  // C[lo..hi) x [0..nv) = acc; row stride ldc.
  __device__ void store(float* __restrict__ c, int ldc, int lo, int hi,
                        int nv) const {
#pragma unroll
    for (int p = 0; p < RM; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = p * (BM / RM) + ty * 4 + i;
        if (m < lo || m >= hi) continue;
        float* row = c + (size_t)m * ldc;
#pragma unroll
        for (int q = 0; q < RN; ++q) {
          const int n = q * (BN / RN) + tx * 4;
          const int r = 4 * p + i, c0 = 4 * q;
          if (n + 3 < nv &&
              (reinterpret_cast<uintptr_t>(row + n) & 15) == 0) {
            *reinterpret_cast<float4*>(row + n) =
                make_float4(acc[r][c0], acc[r][c0 + 1], acc[r][c0 + 2],
                            acc[r][c0 + 3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (n + j < nv) row[n + j] = acc[r][c0 + j];
          }
        }
      }
  }
};

}  // namespace tile_f32
