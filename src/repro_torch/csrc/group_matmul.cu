// Ragged grouped matmul on Hopper (MoE expert compute):
//   out[i] = x[i] @ w[expert_of_tile[i / tile_m]]      (w[e] is (d, f)), or,
//   transposed, out[i] = x[i] @ w[e]^T                  (w[e] is (f, d)),
// f32 output; x is (t, d), out (t, f) either way.
//
// Replaces the Pallas TPU kernel src/repro/kernels/group_matmul/kernel.py
// (pallas_call_group_matmul, body _kernel), whose sequential grid
// (m_tiles, f_tiles, d_tiles) revisits one (tile_m, fk) VMEM accumulator
// over the contraction axis and gathers the weight block of the tile's
// expert through a scalar-prefetched expert id.  The reference widens bf16
// to f32 and multiplies with an f32 result; a product of two bf16 values
// is exact in f32, so every shape here computes the same terms and only
// the order of the sum differs.
//
// The sequential contraction axis becomes a loop inside the CTA, which
// reads its expert ids itself.  Each output is written once by one CTA, in
// an order fixed by the shapes (no atomics: two calls give the same bits).
// Any d, f and tile_m work: edges are masked, nothing is padded or copied.
// Rows of a tile whose expert id is out of range are NaN; nothing outside
// w is read.  variant() picks the CTA shape from the dtype, tile_m, d, f
// and the alignment alone; a launch that fails returns its error:
//
// * tile_m <= 16, the weight stream (every serving call: capacity 1-6 in
//   one 8-row tile per expert).  Phi-3.5-MoE's decode step (16 experts,
//   d 4096, f 6400, bf16) reads 839 MB of weights for 6.7 GFLOP, 8 FLOP a
//   byte: the card's memory rate bounds it (0.25 ms at 3.35 TB/s).  Each
//   lane loads 16 bytes of a weight row at a time (8 for bf16 at 16 rows),
//   a CTA's 8 warps are 2 column groups x 4 row groups splitting d, each
//   lane keeps 16 rows in flight in its own cp.async ring of shared memory,
//   the tile's x rows are staged k-major in 16 KB slabs, and the row
//   groups' partial sums are added in shared memory in a fixed order.  An
//   f or a w that does not allow the wide load takes scalar loads into an
//   8-deep register ring.
// * bf16, tile_m > 16, d and f multiples of 8, x and w 16-byte aligned (the
//   TMA's strides and addresses): the tensor-core shape.  At the training
//   shapes the weights bound it: Phi-3.5-MoE's wg (16 experts x 256 padded
//   rows, 4096 -> 6400) multiplies 215 GFLOP (0.217 ms at 989 TFLOP/s)
//   but reads 839 MB of weights (0.25 ms at 3.35 TB/s; 0.276 ms with x and
//   the output), DeepSeek-V2-Lite's wg (64 experts x 60 rows, 2048 ->
//   1408) 369 MB (0.121 ms).  The design reads each weight byte from
//   device memory once and keeps the tensor cores fed from shared memory:
//   - a CTA is 3 warpgroups: one thread of the first issues TMA loads, the
//     other two multiply with wgmma (m64n128k16, bf16 in, f32 accumulated
//     in registers; setmaxnreg moves registers from the loader to them);
//   - its tile is BM = 64 or 128 rows (tile_m <= 64 or not) of ONE tile of
//     x, so of one expert, times BN = 256 columns, through a ring of 4
//     (BM 128) or 5 (BM 64) stages of BK = 64-deep slices, one mbarrier
//     pair a stage (loaded / released).  At BM 128 each multiplying
//     warpgroup owns 64 rows and all 256 columns, at BM 64 all 64 rows and
//     128 columns.  A tile of more than 128 rows takes several row blocks;
//     DeepSeek's 60-row tile is one block of 64 with 4 rows masked;
//   - x is read as a 3-d tensor (tile, row, d), so rows past the tile and
//     columns past d arrive as zeros; w as (expert, d, f), so nothing past
//     an expert's own d x f is read.  The result goes from registers to
//     device memory, masked to the tile's rows and to f;
//   - both layouts of w[e] read in place: as stored, (d, f), it is the
//     MN-major operand through wgmma's transpose bit (four 64-column TMA
//     boxes a stage); transposed, (f, d), it is K-major (one 256-row box),
//     so the backward's dx needs no transposed copy of w;
//   - the row blocks of a column panel run in adjacent pairs, so Phi's two
//     128-row blocks of an expert read its panel from device memory once
//     and the second from the 50 MB L2; x rows are re-read from L2 for
//     each column block.
// * other tiles of more than 16 rows (f32, or a bf16 shape the TMA cannot
//   take), a register-blocked f32 SIMT product (tile_f32.cuh: 128 x 128
//   CTA tiles, 8 x 8 outputs a thread, 16-deep double-buffered slices;
//   plain f32 FMA, no TF32, bf16 widened on load).  At the f32 benchmark
//   leg (16 x 1024 rows, d 1024, f 4096, tile_m 32) the f32 FMA rate
//   bounds it (137 GFLOP, 2.05 ms at 67 TFLOP/s).  A CTA's 128 rows may
//   cover several tiles: it works one run of equal expert ids at a time.
//   Column blocks are the fast grid axis, so the CTAs in flight re-read an
//   expert's weight panel and their x rows from L2.
// The transposed layout runs only on the tensor-core shape; the caller
// gives the other shapes a contiguous transposed copy.
#include <dlfcn.h>

#include <climits>
#include <cstring>
#include <type_traits>

#include "hopper.cuh"
#include "tile_f32.cuh"

namespace {

using tile_f32::bf16_hi;
using tile_f32::bf16_lo;

// ---- weight stream: one tile of <= R rows, the warps split d ---------------
constexpr int SNT = 256;        // threads of a stream CTA: two fit an SM
constexpr int SNW = SNT / 32;   // its warps
constexpr int SWS = 4;          // row groups: warps that split d
constexpr int SCG = SNW / SWS;  // column groups

template <int BYTES> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };

template <typename T, int R, bool VEC>
struct Stream {
  static constexpr int CW = 16 / (int)sizeof(T) < 64 / R
                                ? 16 / (int)sizeof(T) : 64 / R;   // columns a lane
  static constexpr int COLS = SCG * 32 * CW;          // columns a CTA
  static constexpr int VB = CW * (int)sizeof(T);      // bytes a weight load
  // weight loads in flight a lane: a ring of 16 shared-memory slots fed by
  // cp.async, or (scalar loads) of 8 registers
  static constexpr int U = VEC ? 16 : 8;
  static constexpr int XS = 16 * 1024;                // x slab bytes
  static constexpr int KS = XS / (R * (int)sizeof(T));   // x rows a slab
  static constexpr int RING = VEC ? SNT * U * VB : 0;
  static constexpr int RED = SWS * R * COLS * 4;      // the warps' partial sums
  static constexpr int SMEM = XS + RING > RED ? XS + RING : RED;
  using V = typename Vec<VB>::type;
  static_assert(R % 8 == 0 && (R * sizeof(T)) % 16 == 0, "x row reads");
  static_assert(KS % (U * SWS) == 0, "the ring carries over slabs");
};

// The 32-bit words of a raw vector of T as f32: two bf16 or one f32 a word.
template <typename T, int N>
__device__ __forceinline__ void unpack(const uint32_t (&wd)[N], float* out) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (sizeof(T) == 2) {
      out[2 * i] = bf16_lo(wd[i]);
      out[2 * i + 1] = bf16_hi(wd[i]);
    } else {
      out[i] = __uint_as_float(wd[i]);
    }
  }
}

// A 16- or 8-byte asynchronous copy from device to shared memory, its
// commit, and the wait until at most N of this thread's groups are pending.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// CW elements of a weight row at p, one load an element, zero where !ok or
// past the `left` columns that exist from p on (the scalar variant).
template <typename T, typename V>
__device__ __forceinline__ V load_scalar(const T* p, bool ok, int left) {
  using E = typename std::conditional<sizeof(T) == 2, unsigned short,
                                      unsigned int>::type;
  constexpr int CW = sizeof(V) / sizeof(T);
  E e[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c)
    e[c] = (ok && c < left) ? __ldg(reinterpret_cast<const E*>(p) + c) : E(0);
  V v;
  memcpy(&v, e, sizeof(V));
  return v;
}

template <typename T, int R, bool VEC>
__global__ void __launch_bounds__(SNT, 2)
group_matmul_stream(const T* __restrict__ x, const int* __restrict__ eid,
                    const T* __restrict__ w, float* __restrict__ out,
                    int tile_m, int d, int f, int n_experts) {
  using S = Stream<T, R, VEC>;
  using V = typename S::V;
  constexpr int CW = S::CW, U = S::U;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);             // [KS][R], a slab of x
  V* ring = reinterpret_cast<V*>(smem + S::XS);   // [U][SNT] weight slots
  float* red = reinterpret_cast<float*>(smem);    // [SWS][R][COLS] at the end
  const int tile = blockIdx.y;
  const size_t row0 = (size_t)tile * tile_m;
  const int n0 = blockIdx.x * S::COLS;
  const int tid = threadIdx.x, lane = tid % 32;
  const int wr = tid / 32 % SWS;              // this warp's rows: wr + j SWS
  const int lc = (tid / 32 / SWS) * 32 + lane;   // its lane's column group
  const int n = n0 + lc * CW;
  const int ex = eid[tile];
  if (ex < 0 || ex >= n_experts) {   // CTA-uniform: no barrier is skipped
    for (int i = tid; i < tile_m * S::COLS; i += SNT) {
      const int c = n0 + i % S::COLS;
      if (c < f) out[(row0 + i / S::COLS) * f + c] = __int_as_float(0x7fc00000);
    }
    return;
  }
  const bool col_ok = n < f;
  const int left = f - n;
  const T* wn = w + (size_t)ex * d * f + n;   // this lane's columns, row 0
  const T* xt = x + row0 * d;
  // step j of a lane is row wr + j * SWS, held in slot j % U of its ring
  auto row_ok = [&](int k) { return col_ok && k < d; };
  V regs[VEC ? 1 : U];
  auto issue = [&](int slot, int k) {   // start the load of row k
    if constexpr (VEC) {
      if (row_ok(k)) cp_async<S::VB>(ring + slot * SNT + tid, wn + (size_t)k * f);
      cp_commit();   // one group a step, empty or not
    } else {
      regs[slot] = load_scalar<T, V>(wn + (size_t)k * f, row_ok(k), left);
    }
  };

  float acc[R][CW];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[r][c] = 0.f;

  constexpr int AHEAD = VEC ? U - 1 : U;   // steps in flight before the first
#pragma unroll
  for (int j = 0; j < AHEAD; ++j) issue(j, wr + j * SWS);

  for (int k0 = 0; k0 < d; k0 += S::KS) {
    const int kn = min(S::KS, d - k0);
    if (k0) __syncthreads();   // the previous slab is read
    for (int i = tid; i < kn * R; i += SNT) {
      const int r = i / kn, kk = i % kn;
      xs[kk * R + r] = r < tile_m ? xt[(size_t)r * d + k0 + kk] : T(0.f);
    }
    __syncthreads();
    // no barrier from here to the slab's end; the ring runs on into the
    // next slab (KS is a multiple of U * SWS, so slot j % U stays aligned)
    for (int kb = wr; kb < kn; kb += U * SWS) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = kb + u * SWS;        // row in the slab
        const int kg = k0 + k;             // row in w
        V cur;
        if constexpr (VEC) {
          issue((u + U - 1) % U, kg + (U - 1) * SWS);
          cp_wait<U - 1>();                // step u's copy has landed
          cur = ring[u * SNT + tid];
        } else {
          cur = regs[u];
          issue(u, kg + U * SWS);
        }
        if (k < kn) {
          uint32_t wd[S::VB / 4];
          memcpy(wd, &cur, sizeof(V));
          float wf[CW];
          unpack<T>(wd, wf);
          float xr[R];
          const uint4* xv = reinterpret_cast<const uint4*>(xs + k * R);
#pragma unroll
          for (int q = 0; q < (int)(R * sizeof(T)) / 16; ++q) {
            const uint4 v = xv[q];
            const uint32_t xw[4] = {v.x, v.y, v.z, v.w};
            unpack<T>(xw, xr + q * (16 / (int)sizeof(T)));
          }
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < CW; ++c)
              acc[r][c] = fmaf(xr[r], wf[c], acc[r][c]);
        }
      }
    }
  }

  if constexpr (VEC) cp_wait<0>();
  __syncthreads();   // x and the ring are dead: their space takes the sums
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < CW; ++c)
      red[(wr * R + r) * S::COLS + lc * CW + c] = acc[r][c];
  __syncthreads();
  for (int i = tid; i < tile_m * S::COLS; i += SNT) {
    const int r = i / S::COLS, c = i % S::COLS;
    if (n0 + c >= f) continue;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < SWS; ++v) s += red[(v * R + r) * S::COLS + c];
    out[(row0 + r) * f + n0 + c] = s;
  }
}

// ---- tiled: 128 x 128 CTA tiles of the shared f32 core ---------------------
constexpr int TBM = 128, TBN = 128;   // CTA tile
using Core = tile_f32::Tile<TBM, TBN, 16>;
constexpr int NT = Core::NT;

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT, 2)
group_matmul_tiled(const T* __restrict__ x, const int* __restrict__ eid,
                   const T* __restrict__ w, float* __restrict__ out,
                   int t, int tile_m, int d, int f, int n_experts) {
  __shared__ __align__(16) Core::Smem smem;
  const int n0 = blockIdx.x * TBN;
  const int r0 = blockIdx.y * TBM;
  const int rows = min(TBM, t - r0), nv = min(TBN, f - n0);
  const T* xr = x + (size_t)r0 * d;
  float* orow = out + (size_t)r0 * f + n0;
  Core core;
  // runs of rows [lo, hi) whose tiles share one expert id; every thread
  // reads the same ids, so the loop and the barriers in it are uniform
  for (int lo = 0; lo < rows;) {
    const int tile = (r0 + lo) / tile_m;
    const int ex = eid[tile];
    int hi = min(rows, (tile + 1) * tile_m - r0);
    while (hi < rows && eid[(r0 + hi) / tile_m] == ex)
      hi = min(rows, hi + tile_m);
    if (ex < 0 || ex >= n_experts) {
      core.fill(__int_as_float(0x7fc00000));
    } else {
      core.fill(0.f);
      core.mma<T, VEC>(xr, d, lo, hi, w + (size_t)ex * d * f + n0, f, nv, d,
                       smem);
    }
    core.store(orow, f, lo, hi, nv);
    lo = hi;
  }
}

// ---- tensor cores: bf16 tiles of more than 16 rows --------------------------
namespace tc {

constexpr int BN = 256, BK = 64;   // CTA columns, slice depth (128 bytes)
constexpr int NT = 384;            // the loading warpgroup, two multiplying
constexpr int CONSUMER_WARPS = 8;  // each releases a stage once

template <int BM>
struct Shape {
  static constexpr int STAGES = BM == 128 ? 4 : 5;
  static constexpr int A_BYTES = BM * BK * 2;   // the x rows of a slice
  static constexpr int B_BYTES = BN * BK * 2;   // the weight panel's slice
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int NW = BM / 64;   // n128 products a warpgroup a k16 step
  // the stages, their 2 x STAGES barriers, and room to align to 1,024 bytes
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
  static_assert(A_BYTES % 1024 == 0 && STAGE % 1024 == 0, "swizzle atoms");
};

}  // namespace tc

// KMAJOR: w is (E, f, d), the transposed layout (the backward's dx); else
// (E, d, f).  Here K = d is the contraction and N = f the output width.
template <int BM, bool KMAJOR>
__global__ void __launch_bounds__(tc::NT, 1)
group_matmul_tc(__grid_constant__ const CUtensorMap xmap,
                __grid_constant__ const CUtensorMap wmap,
                const int* __restrict__ eid, float* __restrict__ out,
                int n_tiles, int tile_m, int K, int N, int n_experts) {
  using S = tc::Shape<BM>;
  using namespace hopper;
  constexpr int BN = tc::BN, BK = tc::BK, ST = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + ST * S::STAGE;   // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + ST * 8;
  // this CTA's (row block, column block): the row blocks of a column
  // panel in adjacent pairs, so a pair's CTAs run side by side
  const int chunks = (tile_m + BM - 1) / BM;   // row blocks a tile
  const int rbn = n_tiles * chunks;
  const int cbn = (N + BN - 1) / BN;
  const int g = blockIdx.x / (2 * cbn);
  const int in = blockIdx.x - g * 2 * cbn;
  const int pair = min(2, rbn - 2 * g);
  const int cb = in / pair, rb = 2 * g + in % pair;
  const int tile = rb / chunks;
  const int m0 = (rb % chunks) * BM;       // first row inside the tile
  const int rows = min(BM, tile_m - m0);   // rows of the block to store
  float* orow = out + ((size_t)tile * tile_m + m0) * N;
  const int n0 = cb * BN;
  const int tid = threadIdx.x;
  const int ex = eid[tile];
  if (ex < 0 || ex >= n_experts) {   // CTA-uniform, before any barrier
    const int cols = min(BN, N - n0);
    for (int i = tid; i < rows * cols; i += tc::NT)
      orow[(size_t)(i / cols) * N + n0 + i % cols] =
          __int_as_float(0x7fc00000);
    return;
  }
  const int nk = (K + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, tc::CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  // one branch a role, never rejoined (setmaxnreg needs it)
  if (tid < 128) {
    setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST;
        // stage s was released by the products of slice kt - ST
        if (kt >= ST) mbar_wait(empty0 + 8 * s, (kt / ST - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t a = base + s * S::STAGE, b = a + S::A_BYTES;
#ifdef GM_TC_NO_LOADS   // profile_kernels' floor: the products alone
        mbar_arrive(full);
#else
        mbar_expect_tx(full, S::STAGE);
        tma_load_3d(a, &xmap, full, kt * BK, m0, tile);
        if constexpr (KMAJOR) {
          tma_load_3d(b, &wmap, full, kt * BK, n0, ex);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_3d(b + j * 8192, &wmap, full, n0 + 64 * j, kt * BK, ex);
        }
#endif
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int c = tid / 128 - 1;   // this warpgroup among the two
    // its rows of the block and its first column in the panel
    const int arow = BM == 128 ? 64 * c : 0;
    const int bcol = BM == 128 ? 0 : 128 * c;
    float acc[S::NW][64];
#pragma unroll
    for (int j = 0; j < S::NW; ++j)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % ST;
      mbar_wait(full0 + 8 * s, (kt / ST) & 1);
      const uint32_t a = base + s * S::STAGE + arow * 128;
      const uint32_t b = base + s * S::STAGE + S::A_BYTES;
#pragma unroll
      for (int j = 0; j < S::NW; ++j) fence_acc(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = sw128_desc(a + kk * 32, 16, 1024);
#pragma unroll
        for (int j = 0; j < S::NW; ++j) {
          const int col = bcol + 128 * j;
          const uint64_t db =
              KMAJOR ? sw128_desc(b + col * 128 + kk * 32, 16, 1024)
                     : sw128_desc(b + (col / 64) * 8192 + kk * 2048, 8192,
                                  1024);
          wgmma_m64n128k16<KMAJOR ? 0 : 1>(acc[j], da, db);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();   // the previous slice's products are done
#pragma unroll
      for (int j = 0; j < S::NW; ++j) fence_acc(acc[j]);
      if (kt > 0 && tid % 32 == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % ST));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < S::NW; ++j) fence_acc(acc[j]);
    const int t = tid % 128;
    const int r = arow + 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
    for (int j = 0; j < S::NW; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = n0 + bcol + 128 * j + 8 * i + 2 * (t % 4);
        if (col >= N) continue;   // N % 8 == 0: col + 1 < N too
        if (r < rows)
          *reinterpret_cast<float2*>(orow + (size_t)r * N + col) =
              make_float2(acc[j][4 * i], acc[j][4 * i + 1]);
        if (r + 8 < rows)
          *reinterpret_cast<float2*>(orow + (size_t)(r + 8) * N + col) =
              make_float2(acc[j][4 * i + 2], acc[j][4 * i + 3]);
      }
  }
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? (int)cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : 0;
}

template <typename T, int R, bool VEC>
int launch_stream(const T* x, const int* eid, const T* w, float* out,
                  int n_tiles, int tile_m, int d, int f, int n_experts,
                  cudaStream_t st) {
  using S = Stream<T, R, VEC>;
  auto kernel = group_matmul_stream<T, R, VEC>;
  static const int attr = allow_smem(kernel, S::SMEM);   // once a variant
  if (attr) return attr;
  const dim3 grid((unsigned)((f + S::COLS - 1) / S::COLS),
                  (unsigned)n_tiles);
  kernel<<<grid, SNT, S::SMEM, st>>>(x, eid, w, out, tile_m, d, f,
                                     n_experts);
  return 0;
}

// cuTensorMapEncodeTiled from the libcuda that the process has loaded (no
// link against it); null if there is none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? (EncodeTiled)dlsym(lib, "cuTensorMapEncodeTiled") : nullptr;
  }();
  return fn;
}

// A 3-d bf16 tensor map, dims and box innermost first, 128-byte swizzle,
// zeros past the edges; cudaErrorInvalidValue if libcuda refuses it.
int tensor_map(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1,
               uint64_t d2, uint32_t b0, uint32_t b1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};   // bytes, dims 1, 2
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BM, bool KMAJOR>
int launch_tc(const __nv_bfloat16* x, const int* eid, const __nv_bfloat16* w,
              float* out, int n_tiles, int tile_m, int d, int f,
              int n_experts, cudaStream_t st) {
  using S = tc::Shape<BM>;
  auto kernel = group_matmul_tc<BM, KMAJOR>;
  static const int attr = allow_smem(kernel, S::SMEM);   // once a variant
  if (attr) return attr;
  CUtensorMap xm, wm;
  int err = tensor_map(&xm, x, d, tile_m, n_tiles, tc::BK, BM);
  if (!err)
    err = KMAJOR ? tensor_map(&wm, w, d, f, n_experts, tc::BK, tc::BN)
                 : tensor_map(&wm, w, f, d, n_experts, 64, tc::BK);
  if (err) return err;
  const long long ctas = (long long)n_tiles * ((tile_m + BM - 1) / BM) *
                         ((f + tc::BN - 1) / tc::BN);
  if (ctas > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)ctas, tc::NT, S::SMEM, st>>>(xm, wm, eid, out, n_tiles,
                                                   tile_m, d, f, n_experts);
  return 0;
}

// The launch variants, by shape and alignment only.
enum Variant {
  STREAM8_SCALAR, STREAM8_VEC, STREAM16_SCALAR, STREAM16_VEC,
  TILED_SCALAR, TILED_VEC, TC64, TC128
};

template <typename T>
int variant(const void* x, const void* w, int tile_m, int d, int f) {
  const auto xa = reinterpret_cast<uintptr_t>(x);
  const auto wa = reinterpret_cast<uintptr_t>(w);
  if (tile_m <= 16) {
    const int r8 = tile_m <= 8;
    const int cw = r8 ? Stream<T, 8, true>::CW : Stream<T, 16, true>::CW;
    const bool vec = f % cw == 0 && wa % (cw * sizeof(T)) == 0;
    return (r8 ? STREAM8_SCALAR : STREAM16_SCALAR) + vec;
  }
  if (sizeof(T) == 2 && d % 8 == 0 && f % 8 == 0 && xa % 16 == 0 &&
      wa % 16 == 0)
    return tile_m <= 64 ? TC64 : TC128;
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = d % 4 == 0 && f % 4 == 0 && xa % align == 0 &&
                   wa % align == 0;
  return TILED_SCALAR + vec;
}

template <typename T>
int launch(const void* x, const void* eid, const void* w, void* out,
           int n_tiles, int tile_m, int d, int f, int n_experts,
           int trans_w, void* stream) {
  const auto xp = (const T*)x;
  const auto ep = (const int*)eid;
  const auto wp = (const T*)w;
  const auto op = (float*)out;
  const auto st = (cudaStream_t)stream;
  const int v = variant<T>(x, w, tile_m, d, f);
  const bool on_tc = v == TC64 || v == TC128;
  if (trans_w && !on_tc) return (int)cudaErrorInvalidValue;
  int err = 0;
  if (on_tc) {
    if constexpr (sizeof(T) == 2) {
      const auto* xb = (const __nv_bfloat16*)x;
      const auto* wb = (const __nv_bfloat16*)w;
      if (v == TC64)
        err = trans_w ? launch_tc<64, true>(xb, ep, wb, op, n_tiles, tile_m,
                                            d, f, n_experts, st)
                      : launch_tc<64, false>(xb, ep, wb, op, n_tiles, tile_m,
                                             d, f, n_experts, st);
      else
        err = trans_w ? launch_tc<128, true>(xb, ep, wb, op, n_tiles, tile_m,
                                             d, f, n_experts, st)
                      : launch_tc<128, false>(xb, ep, wb, op, n_tiles,
                                              tile_m, d, f, n_experts, st);
    }
  } else if (v <= STREAM8_VEC) {
    err = v == STREAM8_VEC
              ? launch_stream<T, 8, true>(xp, ep, wp, op, n_tiles, tile_m, d,
                                          f, n_experts, st)
              : launch_stream<T, 8, false>(xp, ep, wp, op, n_tiles, tile_m, d,
                                           f, n_experts, st);
  } else if (v <= STREAM16_VEC) {
    err = v == STREAM16_VEC
              ? launch_stream<T, 16, true>(xp, ep, wp, op, n_tiles, tile_m, d,
                                           f, n_experts, st)
              : launch_stream<T, 16, false>(xp, ep, wp, op, n_tiles, tile_m,
                                            d, f, n_experts, st);
  } else {
    const int t = n_tiles * tile_m;
    const dim3 grid((unsigned)((f + TBN - 1) / TBN),
                    (unsigned)((t + TBM - 1) / TBM));
    if (v == TILED_VEC)
      group_matmul_tiled<T, true><<<grid, NT, 0, st>>>(
          xp, ep, wp, op, t, tile_m, d, f, n_experts);
    else
      group_matmul_tiled<T, false><<<grid, NT, 0, st>>>(
          xp, ep, wp, op, t, tile_m, d, f, n_experts);
  }
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

// C entry points (loaded with ctypes).  x is (n_tiles * tile_m, d); w is
// (n_experts, d, f), or (n_experts, f, d) with trans_w (the tensor-core
// shape only: elsewhere it returns cudaErrorInvalidValue); x and w both f32
// or both bf16; eid is (n_tiles,) int32; out is (n_tiles * tile_m, f) f32;
// all contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int group_matmul_f32(const void* x, const void* eid,
                                const void* w, void* out, int n_tiles,
                                int tile_m, int d, int f, int n_experts,
                                int trans_w, void* stream) {
  return launch<float>(x, eid, w, out, n_tiles, tile_m, d, f, n_experts,
                       trans_w, stream);
}

extern "C" int group_matmul_bf16(const void* x, const void* eid,
                                 const void* w, void* out, int n_tiles,
                                 int tile_m, int d, int f, int n_experts,
                                 int trans_w, void* stream) {
  return launch<__nv_bfloat16>(x, eid, w, out, n_tiles, tile_m, d, f,
                               n_experts, trans_w, stream);
}

// The Variant a launch of these operands takes (nothing is launched).
extern "C" int group_matmul_variant(const void* x, const void* w, int bf16,
                                    int tile_m, int d, int f) {
  return bf16 ? variant<__nv_bfloat16>(x, w, tile_m, d, f)
              : variant<float>(x, w, tile_m, d, f);
}
