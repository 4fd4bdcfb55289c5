// Block-CSR SpMM on Hopper: C = A_bcsr @ B, f32 accumulation and output.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bcsr_spmm/kernel.py:40
// (pallas_call_bcsr, body _kernel), whose sequential grid (k_tiles, bcap)
// revisits one output tile in VMEM for consecutive blocks of a block-row.
//
// Bound at the leg (1024 x 1024 A, 128 x 128 blocks at 12.5% density,
// k = 512, f32): the 10 live blocks, the 6 B block-rows they name and C
// move 4.33 MB (1.29 us at 3.35 TB/s) and take 0.168 GFLOP, so the card's
// f32 FMA rate (67 TFLOP/s) bounds it at 2.50 us.
//
// Parallelism.  Only 5 of the leg's 8 block-rows hold blocks, 2 each: 327,680
// live outputs x 256 deep = 83.9 M FMAs.  At 8 x 8 outputs a thread the
// outputs fill 160 warps, and the card has 132 SMs x 4 schedulers = 528:
// no tiling of the output alone fills it, so each block-row's contraction
// is split as well.
//
// Design.  A CTA is (block-row r, 128-row sub-tile, 64-column tile, split
// rank s of S) and runs the shared f32 tile core (tile_f32.cuh: 8 x 8
// outputs a thread, 16-deep double-buffered slices, plain f32 FMA, never
// TF32; bf16 widened on load).  Row r's contraction is its live blocks'
// depths laid end to end, lanes [indptr[r], min(indptr[r+1], n_blocks)) in
// order; it is cut into S contiguous ranges of a multiple of 16, and rank s
// runs the core once for each block segment its range covers.  The S ranks
// of a tile form one thread-block cluster.  Rank s writes rows
// [s 128 / S, (s + 1) 128 / S) of the tile: every rank stores each row of
// its partial into slot s of the writing rank's shared memory (through
// distributed shared memory; its own rows locally), one cluster barrier
// later each rank sums its S slots in rank order 0..S-1 and writes C.  No
// atomics and no workspace: two calls give the same bits, and a captured
// graph replays it as it is.  The stores travel while the other ranks
// finish (pulling the partials after the barrier measured 1.2 us at the
// leg, pushing and summing 0.5 us), and a rank stores into another only
// after an early arrival on the cluster barrier shows that rank has
// started.  Rows
// without live blocks are written as zeros, every rank its share, with no
// barrier.  S is chosen by the wrapper from the tile count and the SM
// count, never from device data (S = 1 is the kernel without a split), and
// is a template parameter, so that the reduction's loads are all in flight
// at once.  4-element vector loads are chosen by the launcher when bn, kp
// and the base pointers allow them, scalar loads otherwise.
//
// What is left (PERF.md has the times): the core's inner loop, at ~1.1 us
// a 128 x 64 x 16 slice for a lone CTA, about half of one SM's FMA rate,
// is the floor; at S = 4 the leg's 160 working CTAs outnumber the SMs, so
// 36 SMs hold two and take ~1.5x as long, and which CTAs share an SM
// depends on which rows are empty, which the launch cannot see; the
// cluster barrier and the index loads ahead of the first slice take
// ~1.5 us more.  A bf16 path on the tensor cores (wgmma) is not written.
#include <cooperative_groups.h>

#include "tile_f32.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 128, BN = 64;
using Core = tile_f32::Tile<BM, BN, 16>;

template <int S>
struct Smem {
  Core::Smem core;
  // S slots of BM / S rows: slot q holds rank q's partial of the rows this
  // rank writes (S > 1 only)
  float part[S > 1 ? BM : 1][BN];
};

#ifdef BCSR_PHASES
// Profiling build only (python -m repro_torch.bench.profile_kernels): each
// CTA's thread 0 logs the card's clock at the kernel's phases and its SM.
constexpr int PHASE_CTAS = 8192, PHASES = 8;
__device__ unsigned long long phase_log[PHASE_CTAS][PHASES];
#define PHASE(i)                                                          \
  if (threadIdx.x == 0 && blockIdx.x < PHASE_CTAS) {                      \
    unsigned long long t;                                                 \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                 \
    phase_log[blockIdx.x][i] = t;                                         \
    if (i == 0) {                                                         \
      unsigned sm;                                                        \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));                     \
      phase_log[blockIdx.x][PHASES - 1] = sm;                             \
    }                                                                     \
  }
#else
#define PHASE(i)
#endif

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// two CTAs an SM: the registers the compiler then takes (~200) measured
// faster than three CTAs' 168, and the split rule keeps the grid in one
// wave of two an SM
template <typename T, bool VEC, int S>
__global__ void __launch_bounds__(Core::NT, 2)
bcsr_spmm_kernel(const int* __restrict__ indptr,
                 const int* __restrict__ indices,
                 const T* __restrict__ blocks, const T* __restrict__ b,
                 float* __restrict__ out, int bm, int bn, int kp,
                 int n_blocks) {
  constexpr int ROWS = BM / S;                      // rows a rank writes
  constexpr int PER = ROWS * (BN / 4) / Core::NT;   // their float4s a thread
  static_assert(BM % S == 0 && PER * Core::NT == ROWS * (BN / 4), "");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<S>& smem = *reinterpret_cast<Smem<S>*>(smem_raw);
  PHASE(0);   // start
  const int msub = (bm + BM - 1) / BM;
  const int nsub = (kp + BN - 1) / BN;
  const int tile = blockIdx.x / S, s = blockIdx.x % S;
  const int r = tile / (msub * nsub), sub = tile % (msub * nsub);
  const int m0 = (sub / nsub) * BM, n0 = (sub % nsub) * BN;
  const int mv = min(BM, bm - m0), nv = min(BN, kp - n0);
  float* c = out + ((size_t)r * bm + m0) * kp + n0;
  // rows [s ROWS, (s + 1) ROWS) of the tile are this rank's to write: the
  // u-th float4 of a thread is row m_of(u), columns n_of(u)..+3
  auto m_of = [&](int u) {
    return s * ROWS + (threadIdx.x + u * Core::NT) / (BN / 4);
  };
  auto n_of = [&](int u) {
    return ((threadIdx.x + u * Core::NT) % (BN / 4)) * 4;
  };
  auto put = [&](int m, int n, float4 v) {
    if (m >= mv) return;
    float* p = c + (size_t)m * kp + n;
    if (n + 3 < nv && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      *reinterpret_cast<float4*>(p) = v;
    } else {
      if (n < nv) p[0] = v.x;
      if (n + 1 < nv) p[1] = v.y;
      if (n + 2 < nv) p[2] = v.z;
      if (n + 3 < nv) p[3] = v.w;
    }
  };

  const int e0 = indptr[r];
  const int depth = max(0, min(indptr[r + 1], n_blocks) - e0) * bn;
  PHASE(1);   // the row's live blocks read
  if (depth == 0) {   // the same for the whole cluster: no barrier needed
#pragma unroll
    for (int u = 0; u < PER; ++u)
      put(m_of(u), n_of(u), make_float4(0.f, 0.f, 0.f, 0.f));
    PHASE(5);   // end
    return;
  }
  // a rank writes into another's shared memory only once that one has
  // started: this arrival, and the wait before the first remote store
  if (S > 1) cluster_arrive_relaxed();

  // this rank's range [k0, k1) of the row's depth, a multiple of 16 long
  const int chunk = ((depth + S - 1) / S + 15) / 16 * 16;
  const int k1 = min(depth, (s + 1) * chunk);
  Core core;
  core.fill(0.f);
  for (int k0 = min(depth, s * chunk); k0 < k1;) {   // CTA-uniform
    const int j = k0 / bn, off = k0 - j * bn;
    const int len = min(k1, (j + 1) * bn) - k0;
    const int e = e0 + j;
    core.mma<T, VEC>(blocks + ((size_t)e * bm + m0) * bn + off, bn, 0, mv,
                     b + ((size_t)indices[e] * bn + off) * kp + n0, kp, nv,
                     len, smem.core);
    k0 += len;
  }
  PHASE(2);   // the core's products done
  if constexpr (S == 1) {
    core.store(c, kp, 0, mv, nv);
  } else {
    // each output row goes to the rank that writes it, into this rank's
    // slot there (the rows this rank writes stay in its own memory)
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();
#pragma unroll
    for (int p = 0; p < Core::RM; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = p * (BM / Core::RM) + core.ty * 4 + i, q = m / ROWS;
        float* row = &smem.part[s * ROWS + m - q * ROWS][0];
        float* dst = q == s ? row : cluster.map_shared_rank(row, q);
#pragma unroll
        for (int h = 0; h < Core::RN; ++h) {
          const float* a = &core.acc[4 * p + i][4 * h];
          *reinterpret_cast<float4*>(dst + h * (BN / Core::RN) +
                                     core.tx * 4) =
              make_float4(a[0], a[1], a[2], a[3]);
        }
      }
    PHASE(3);   // partials sent
    cluster.sync();   // every partial has landed; none is sent after this
    PHASE(4);   // past the barrier
    float4 v[PER][S];
#pragma unroll
    for (int u = 0; u < PER; ++u)
#pragma unroll
      for (int q = 0; q < S; ++q)
        v[u][q] = *reinterpret_cast<const float4*>(
            &smem.part[q * ROWS + m_of(u) - s * ROWS][n_of(u)]);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
#pragma unroll
      for (int q = 1; q < S; ++q) {   // in rank order
        v[u][0].x += v[u][q].x;
        v[u][0].y += v[u][q].y;
        v[u][0].z += v[u][q].z;
        v[u][0].w += v[u][q].w;
      }
      put(m_of(u), n_of(u), v[u][0]);
    }
  }
  PHASE(5);   // end
}

template <typename T, bool VEC, int S>
int launch_as(const int* indptr, const int* indices, const T* blocks,
              const T* b, float* out, int mb, int bm, int bn, int kp,
              int n_blocks, cudaStream_t stream) {
  const auto kernel = bcsr_spmm_kernel<T, VEC, S>;
  const int tiles = mb * ((bm + BM - 1) / BM) * ((kp + BN - 1) / BN);
  // past the 48 KB of shared memory a launch may take unasked when S > 1
  // (set on every launch: the attribute is per device)
  const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem<S>));
  if (attr_err != cudaSuccess) return (int)attr_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * S));
  cfg.blockDim = dim3(Core::NT);
  cfg.dynamicSmemBytes = sizeof(Smem<S>);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, indptr, indices,
                                             blocks, b, out, bm, bn, kp,
                                             n_blocks);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_split(const int* indptr, const int* indices, const T* blocks,
                 const T* b, float* out, int mb, int bm, int bn, int kp,
                 int n_blocks, int split, cudaStream_t stream) {
  switch (split) {
    case 1:
      return launch_as<T, VEC, 1>(indptr, indices, blocks, b, out, mb, bm,
                                  bn, kp, n_blocks, stream);
    case 2:
      return launch_as<T, VEC, 2>(indptr, indices, blocks, b, out, mb, bm,
                                  bn, kp, n_blocks, stream);
    case 4:
      return launch_as<T, VEC, 4>(indptr, indices, blocks, b, out, mb, bm,
                                  bn, kp, n_blocks, stream);
    case 8:
      return launch_as<T, VEC, 8>(indptr, indices, blocks, b, out, mb, bm,
                                  bn, kp, n_blocks, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* indptr, const void* indices, const void* blocks,
           const void* b, void* out, int mb, int bm, int bn, int kp,
           int n_blocks, int split, void* stream) {
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = bn % 4 == 0 && kp % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(blocks) % align) == 0 &&
                   (reinterpret_cast<uintptr_t>(b) % align) == 0;
  const auto ip = (const int*)indptr;
  const auto ix = (const int*)indices;
  const auto st = (cudaStream_t)stream;
  if (vec)
    return launch_split<T, true>(ip, ix, (const T*)blocks, (const T*)b,
                                 (float*)out, mb, bm, bn, kp, n_blocks,
                                 split, st);
  return launch_split<T, false>(ip, ix, (const T*)blocks, (const T*)b,
                                (float*)out, mb, bm, bn, kp, n_blocks, split,
                                st);
}

}  // namespace

#ifdef BCSR_PHASES
// The phase log of the last launches into host (PHASE_CTAS x PHASES
// uint64, zeroed after the copy).
extern "C" int bcsr_spmm_phases(void* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, phase_log, sizeof(phase_log));
  if (err != cudaSuccess) return (int)err;
  static unsigned long long zero[PHASE_CTAS][PHASES];
  return (int)cudaMemcpyToSymbol(phase_log, zero, sizeof(zero));
}
#endif

// C entry points (loaded with ctypes).  out is (mb * bm, kp) f32; blocks is
// (bcap, bm, bn) and b is (nb * bn, kp), both f32 or both bf16, contiguous;
// split is S, the ranks of a cluster (1, 2, 4 or 8).  Returns the launch's
// error (cudaGetLastError() after it).
extern "C" int bcsr_spmm_f32(const void* indptr, const void* indices,
                             const void* blocks, const void* b, void* out,
                             int mb, int bm, int bn, int kp, int n_blocks,
                             int split, void* stream) {
  return launch<float>(indptr, indices, blocks, b, out, mb, bm, bn, kp,
                       n_blocks, split, stream);
}

extern "C" int bcsr_spmm_bf16(const void* indptr, const void* indices,
                              const void* blocks, const void* b, void* out,
                              int mb, int bm, int bn, int kp, int n_blocks,
                              int split, void* stream) {
  return launch<__nv_bfloat16>(indptr, indices, blocks, b, out, mb, bm, bn,
                               kp, n_blocks, split, stream);
}
