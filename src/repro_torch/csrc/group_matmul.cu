// Ragged grouped matmul on Hopper (MoE expert compute):
//   out[i] = x[i] @ w[expert_of_tile[i / tile_m]], f32 accumulation and output.
//
// Replaces the Pallas TPU kernel src/repro/kernels/group_matmul/kernel.py
// (pallas_call_group_matmul, body _kernel), whose sequential grid
// (m_tiles, f_tiles, d_tiles) revisits one (tile_m, fk) VMEM accumulator
// over the contraction axis and gathers the weight block of the tile's
// expert through a scalar-prefetched expert id.
//
// Design.  The sequential contraction axis becomes a loop inside the CTA.
// One CTA owns up to 64 rows of one expert tile and 64 output columns; it
// reads its expert id once and streams that expert's (d x 64) weight panel.
// All sums are plain f32 FMA (no TF32; bf16 widened on load), so f32 inputs
// meet 1e-5 against the plain version.  Any d, f and tile_m work: edges are
// masked, nothing is padded or copied.  A tile whose expert id is out of
// range writes NaN rather than reading outside w.  Two CTA shapes:
//
// * tile_m <= 16 (the serving path: capacity 1-6 padded to 8-row tiles):
//   the weight-streaming shape.  Few rows share each weight, so the CTA's
//   8 warps split the contraction (warp w takes rows k = w mod 8 of the
//   panel, each lane two columns), read the weights straight from device
//   memory with 8 rows of loads in flight per thread, and take x from a
//   shared-memory slice; the 8 partial sums are added at the end.
// * wider tiles: a tiled product.  TK-deep slices of x and w are staged in
//   shared memory and each thread accumulates RM x 4 outputs; the next
//   slice is loaded into registers while the current one is multiplied.
//   A tile wider than 64 rows is cut into several CTAs.
//
// Bound.  On the serving path (Phi-3.5-MoE, 16 experts, d 4096, f 6400,
// one 8-row tile per expert) every call reads all 16 experts' weight
// panels once: 839 MB of bf16 for 6.7 GFLOP, 8 FLOP per byte, so the card's
// memory rate bounds it (0.25 ms at 3.35 TB/s).  Each weight element is
// read by exactly one CTA there.  At the benchmark leg's shape (16 x 1024
// rows, d 1024, f 4096, tile_m 32, f32) the f32 FMA rate bounds it instead
// (137 GFLOP, 2.05 ms at 67 TFLOP/s); the weight panel of an expert is then
// re-read by each of its 32 row tiles, from L2 since consecutive CTAs walk
// the tiles of one column block.  Known gaps: no wgmma/TMA, no tensor
// cores for bf16; left to a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TN = 64;   // output columns per CTA
constexpr int NT = 256;  // threads per CTA

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Fills the CTA's rows x 64 outputs with NaN (an expert id out of range).
__device__ void fill_nan(float* out, size_t row0, int rows, int n0, int f) {
  for (int i = threadIdx.x; i < rows * TN; i += NT) {
    const int gn = n0 + i % TN;
    if (gn < f) out[(row0 + i / TN) * f + gn] = __int_as_float(0x7fc00000);
  }
}

// ---- weight-streaming shape: one tile of <= R rows, 8 warps split d ------
constexpr int NW = NT / 32;   // warps per CTA
constexpr int KB = 256;       // contraction rows of x staged per step

template <typename T, int R>
__global__ void __launch_bounds__(NT)
group_matmul_stream(const T* __restrict__ x, const int* __restrict__ eid,
                    const T* __restrict__ w, float* __restrict__ out,
                    int tile_m, int d, int f, int n_experts) {
  // x slice [KB][R] during the loop, then the warps' partial sums
  // [NW][R][TN]; R is a multiple of 4 so a row of the slice is float4s
  __shared__ __align__(16) float smem[NW * R * TN];
  const int tile = blockIdx.x;
  const size_t row0 = (size_t)tile * tile_m;
  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int n = n0 + 2 * lane;
  const int ex = eid[tile];
  if (ex < 0 || ex >= n_experts) {   // CTA-uniform: no barrier is skipped
    fill_nan(out, row0, tile_m, n0, f);
    return;
  }
  const T* xs = x + row0 * d;
  const T* wn = w + (size_t)ex * d * f + n;
  const bool c0 = n < f, c1 = n + 1 < f;

  float acc[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;

  for (int k0 = 0; k0 < d; k0 += KB) {
    for (int i = tid; i < KB * R; i += NT) {
      const int r = i / KB, kk = i % KB;
      smem[kk * R + r] = (r < tile_m && k0 + kk < d)
                             ? to_f32(xs[(size_t)r * d + k0 + kk]) : 0.f;
    }
    __syncthreads();
    const int kend = min(KB, d - k0);
#pragma unroll 8
    for (int kk = warp; kk < kend; kk += NW) {
      const T* wr = wn + (size_t)(k0 + kk) * f;
      const float w0 = c0 ? to_f32(wr[0]) : 0.f;
      const float w1 = c1 ? to_f32(wr[1]) : 0.f;
      const float4* xv = reinterpret_cast<const float4*>(smem + kk * R);
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 v = xv[q];
        acc[4 * q][0] = fmaf(v.x, w0, acc[4 * q][0]);
        acc[4 * q][1] = fmaf(v.x, w1, acc[4 * q][1]);
        acc[4 * q + 1][0] = fmaf(v.y, w0, acc[4 * q + 1][0]);
        acc[4 * q + 1][1] = fmaf(v.y, w1, acc[4 * q + 1][1]);
        acc[4 * q + 2][0] = fmaf(v.z, w0, acc[4 * q + 2][0]);
        acc[4 * q + 2][1] = fmaf(v.z, w1, acc[4 * q + 2][1]);
        acc[4 * q + 3][0] = fmaf(v.w, w0, acc[4 * q + 3][0]);
        acc[4 * q + 3][1] = fmaf(v.w, w1, acc[4 * q + 3][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    smem[(warp * R + r) * TN + 2 * lane] = acc[r][0];
    smem[(warp * R + r) * TN + 2 * lane + 1] = acc[r][1];
  }
  __syncthreads();
  for (int i = tid; i < tile_m * TN; i += NT) {
    const int r = i / TN, c = i % TN;
    if (n0 + c >= f) continue;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < NW; ++v) s += smem[(v * R + r) * TN + c];
    out[(row0 + r) * f + n0 + c] = s;
  }
}

// ---- tiled shape: TM rows x 64 columns, TK-deep slices in shared memory --
constexpr int TK = 32;

template <int TM>
struct Tiled {
  static constexpr int RM = TM / 16;        // rows per thread (16 x 16 grid)
  static constexpr int APT = TM * TK / NT;  // x slice per thread
  static constexpr int WPT = TK * TN / NT;  // w slice per thread
};

template <typename T, int TM>
__global__ void __launch_bounds__(NT)
group_matmul_tiled(const T* __restrict__ x, const int* __restrict__ eid,
                   const T* __restrict__ w, float* __restrict__ out,
                   int tile_m, int d, int f, int n_experts) {
  using S = Tiled<TM>;
  __shared__ float As[TK][TM];
  __shared__ float Ws[TK][TN];
  const int rb = (tile_m + TM - 1) / TM;          // CTAs per tile, rows
  const int tile = blockIdx.x / rb;
  const int m0 = (blockIdx.x % rb) * TM;          // first row in the tile
  const int rows = min(TM, tile_m - m0);
  const size_t row0 = (size_t)tile * tile_m + m0;
  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int ex = eid[tile];
  if (ex < 0 || ex >= n_experts) {   // CTA-uniform: no barrier is skipped
    fill_nan(out, row0, rows, n0, f);
    return;
  }
  const T* xs = x + row0 * d;
  const T* ws = w + (size_t)ex * d * f;

  float ar[S::APT], wr[S::WPT];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < S::APT; ++u) {
      const int i = tid + u * NT;
      const int mm = i / TK, gk = k0 + i % TK;
      ar[u] = (mm < rows && gk < d) ? to_f32(xs[(size_t)mm * d + gk]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < S::WPT; ++u) {
      const int i = tid + u * NT;
      const int gk = k0 + i / TN, gn = n0 + i % TN;
      wr[u] = (gk < d && gn < f) ? to_f32(ws[(size_t)gk * f + gn]) : 0.f;
    }
  };

  float acc[S::RM][4];
#pragma unroll
  for (int i = 0; i < S::RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < d; k0 += TK) {
#pragma unroll
    for (int u = 0; u < S::APT; ++u) {
      const int i = tid + u * NT;
      As[i % TK][i / TK] = ar[u];
    }
#pragma unroll
    for (int u = 0; u < S::WPT; ++u) {
      const int i = tid + u * NT;
      Ws[i / TN][i % TN] = wr[u];
    }
    __syncthreads();
    if (k0 + TK < d) load(k0 + TK);   // next slice in flight meanwhile
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float av[S::RM], bv[4];
#pragma unroll
      for (int i = 0; i < S::RM; ++i) av[i] = As[kk][ty * S::RM + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < S::RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < S::RM; ++i) {
    const int mm = ty * S::RM + i;
    if (mm >= rows) continue;
    float* orow = out + (row0 + mm) * f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < f) orow[gn] = acc[i][j];
    }
  }
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
  const unsigned cols = (unsigned)((f + TN - 1) / TN);
  if (tile_m <= 8) {
    group_matmul_stream<T, 8><<<dim3(n_tiles, cols), NT, 0, st>>>(
        xp, ep, wp, op, tile_m, d, f, n_experts);
  } else if (tile_m <= 16) {
    group_matmul_stream<T, 16><<<dim3(n_tiles, cols), NT, 0, st>>>(
        xp, ep, wp, op, tile_m, d, f, n_experts);
  } else if (tile_m <= 32) {
    group_matmul_tiled<T, 32><<<dim3(n_tiles, cols), NT, 0, st>>>(
        xp, ep, wp, op, tile_m, d, f, n_experts);
  } else {
    const unsigned rb = (unsigned)((tile_m + 63) / 64);
    group_matmul_tiled<T, 64><<<dim3(n_tiles * rb, cols), NT, 0, st>>>(
        xp, ep, wp, op, tile_m, d, f, n_experts);
  }
  return (int)cudaGetLastError();
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
