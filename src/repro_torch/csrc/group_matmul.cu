// Ragged grouped matmul on Hopper (MoE expert compute):
//   out[i] = x[i] @ w[expert_of_tile[i / tile_m]], f32 accumulation and output.
//
// Replaces the Pallas TPU kernel src/repro/kernels/group_matmul/kernel.py
// (pallas_call_group_matmul, body _kernel), whose sequential grid
// (m_tiles, f_tiles, d_tiles) revisits one (tile_m, fk) VMEM accumulator
// over the contraction axis and gathers the weight block of the tile's
// expert through a scalar-prefetched expert id.
//
// The sequential contraction axis becomes a loop inside the CTA, which
// reads its expert ids itself.  All sums are plain f32 FMA (no TF32; bf16
// widened on load), each output is written once by one CTA, in an order
// fixed by the shapes (no atomics).  Any d, f and tile_m work: edges are
// masked, nothing is padded or copied.  Rows of a tile whose expert id is
// out of range are NaN; nothing outside w is read.  The launcher picks the
// CTA shape from tile_m, and the load width from f and the alignment:
//
// * tile_m <= 16, the weight stream (every serving call: capacity 1-6 in
//   one 8-row tile per expert).  Phi-3.5-MoE's decode step (16 experts,
//   d 4096, f 6400, bf16) reads 839 MB of weights for 6.7 GFLOP, 8 FLOP a
//   byte: the card's memory rate bounds it (0.25 ms at 3.35 TB/s), and the
//   design keeps that memory busy:
//   - each lane loads CW columns of a weight row at a time: 16 bytes (8
//     bf16 or 4 f32; 8 bytes for bf16 at 16 rows, to keep 64 sums a
//     thread), so a warp-wide load is 512 contiguous bytes;
//   - a CTA's 8 warps are 2 column groups x 4 row groups: it reads 1 KB of
//     each bf16 weight row (the best DRAM locality that still leaves more
//     CTAs than SMs at f = 4096), and its 4 row groups split d;
//   - each lane keeps 16 rows in flight in its own ring of shared-memory
//     slots fed by cp.async (no registers held, no barrier: a lane reads
//     back only what it copied), 64 KB a CTA, two CTAs an SM;
//   - the tile's x rows are staged k-major in 16 KB slabs of shared memory
//     (one 16-byte broadcast read per weight row at 8 bf16 rows), one
//     barrier a slab, and the weight ring runs on across it;
//   - the row groups' partial sums are added in shared memory in a fixed
//     order.
//   An f or a w that does not allow the wide load takes the same kernel
//   with scalar loads into an 8-deep register ring.
// * wider tiles, a register-blocked f32 SIMT product (tile_f32.cuh: 128 x
//   128 CTA tiles, 8 x 8 outputs a thread, 16-deep double-buffered slices).
//   At the benchmark leg (16 x 1024 rows, d 1024, f 4096, tile_m 32, f32)
//   the f32 FMA rate bounds it (137 GFLOP, 2.05 ms at 67 TFLOP/s).  A CTA's
//   128 rows may cover several tiles: it reads their expert ids and works
//   one run of equal ids at a time (one run when they are all equal, as in
//   the leg), storing each run's rows before the next.  Column blocks are
//   the fast grid axis, so the CTAs in flight (about 8 row blocks of one
//   expert) re-read that expert's 16 MB weight panel and their x rows from
//   the 50 MB L2.
#include <cstring>
#include <type_traits>

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

template <typename T, int R>
int launch_stream(const T* x, const int* eid, const T* w, float* out,
                  int n_tiles, int tile_m, int d, int f, int n_experts,
                  cudaStream_t st) {
  using S = Stream<T, R, true>;
  const bool vec = f % S::CW == 0 &&
                   reinterpret_cast<uintptr_t>(w) % S::VB == 0;
  return vec ? launch_stream<T, R, true>(x, eid, w, out, n_tiles, tile_m, d,
                                         f, n_experts, st)
             : launch_stream<T, R, false>(x, eid, w, out, n_tiles, tile_m, d,
                                          f, n_experts, st);
}

template <typename T>
int launch(const void* x, const void* eid, const void* w, void* out,
           int n_tiles, int tile_m, int d, int f, int n_experts,
           void* stream) {
  const auto xp = (const T*)x;
  const auto ep = (const int*)eid;
  const auto wp = (const T*)w;
  const auto op = (float*)out;
  const auto st = (cudaStream_t)stream;
  int err;
  if (tile_m <= 8) {
    err = launch_stream<T, 8>(xp, ep, wp, op, n_tiles, tile_m, d, f,
                              n_experts, st);
  } else if (tile_m <= 16) {
    err = launch_stream<T, 16>(xp, ep, wp, op, n_tiles, tile_m, d, f,
                               n_experts, st);
  } else {
    const int t = n_tiles * tile_m;
    const dim3 grid((unsigned)((f + TBN - 1) / TBN),
                    (unsigned)((t + TBM - 1) / TBM));
    const uintptr_t align = 4 * sizeof(T);
    const bool vec = d % 4 == 0 && f % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % align == 0 &&
                     reinterpret_cast<uintptr_t>(w) % align == 0;
    if (vec)
      group_matmul_tiled<T, true><<<grid, NT, 0, st>>>(
          xp, ep, wp, op, t, tile_m, d, f, n_experts);
    else
      group_matmul_tiled<T, false><<<grid, NT, 0, st>>>(
          xp, ep, wp, op, t, tile_m, d, f, n_experts);
    err = 0;
  }
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

// C entry points (loaded with ctypes).  x is (n_tiles * tile_m, d), w is
// (n_experts, d, f), both f32 or both bf16; eid is (n_tiles,) int32; out is
// (n_tiles * tile_m, f) f32; all contiguous.  Returns cudaGetLastError()
// after the launch.
extern "C" int group_matmul_f32(const void* x, const void* eid,
                                const void* w, void* out, int n_tiles,
                                int tile_m, int d, int f, int n_experts,
                                void* stream) {
  return launch<float>(x, eid, w, out, n_tiles, tile_m, d, f, n_experts,
                       stream);
}

extern "C" int group_matmul_bf16(const void* x, const void* eid,
                                 const void* w, void* out, int n_tiles,
                                 int tile_m, int d, int f, int n_experts,
                                 void* stream) {
  return launch<__nv_bfloat16>(x, eid, w, out, n_tiles, tile_m, d, f,
                               n_experts, stream);
}
