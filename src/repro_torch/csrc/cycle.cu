// The simulator's engine chunk on Hopper: `ticks` engine ticks of every
// lane of a batch in one launch, bit-equal to the torch-op engine.
//
// What it replaces.  No Pallas kernel: the reference runs the simulator
// as XLA ops.  This is the device counterpart of the `lax.scan` chunk of
// `_get_engine.engine_fn` (src/repro/core/machine.py:1314-1390): each
// tick is one call of the port's `machine._step` (the cycle of
// `_make_cycle.cycle`, then the freeze of `rr`, `cycle` and the `st_*`
// counters where a PE is not alive) and, on a compressed chunk, the
// lone-flight teleport of `core/fastforward.py::make_fast_forward` after
// it.  The plain PyTorch version is `kernels/cycle.py::
// cycle_chunk_plain`, and every int32 leaf equals it bit for bit.
//
// What bounds it.  Neither bytes nor FLOPs: a tick touches a few hundred
// bytes per PE and does a few hundred integer operations, but its phases
// depend on each other (a PE's route needs its neighbours' occupancy
// before the tick, a receiver needs its neighbours' grants, an idle test
// needs the sum over its sub-lane), so a tick is a chain of dependent
// instructions, loads and barriers, run by a few warps a lane with
// nothing to hide their latency: its time is the instructions a warp
// issues (every branch any of its PEs takes) times their latency.  Its
// floor is the barrier shape alone (`cycle_floor`).
//
// The design that follows.  One CTA per lane, looping over the chunk's
// ticks with four barriers a tick.  Up to 128 PEs two threads of a warp
// run each PE (16 PEs a warp; see `move_units`); past that one thread a
// PE.  Threads past the PE axis only join the barriers.  A tick:
//   1. each PE adds its outstanding work to its sub-lane's five sums
//      (shared-memory integer atomics: the order of an integer sum is
//      immaterial, so the sums are exact);
//   2. each PE reads its sub-lane's sums (idle, lone flight), its
//      neighbours' occupancy before the tick (credit) and its own FIFOs,
//      and does everything PE-local: selection, decode and ALU, the
//      stream queue, the memory write, the pending-FIFO pushes, the
//      stream emission and the output arbitration, publishing its grants;
//   3. each PE copies the heads its neighbours granted it (their FIFOs
//      are still as before the tick) into its inbox;
//   4. each PE compacts its FIFOs, clears reached waypoints, writes an
//      intercepted head's result in place, receives its inbox in port
//      order N, E, S, W, injects, freezes what is not alive
//      and, on a compressed chunk, rewrites a lone flight from the state
//      before the tick (the teleport is decided first, from that state,
//      and the tick then leaves every FIFO's head row as it was).
// What keeps a tick's instructions few and short:
//   - every floor division and remainder but the ALU's OP_DIV has a
//     positive divisor, so it is done in 32 bits (exact: no quotient can
//     overflow), by a multiply and shift where the divisor is fixed
//     (PORTS, K) and by a mask where a ring's cap is a power of two; a
//     PE's (x, y) comes from a per-lane table in shared memory for every
//     id in [0, n), and the exact division otherwise;
//   - `pick_one` rotates the candidate mask by r mod p and takes the
//     first set bit (the reference's loop where i - r wraps in int32);
//   - no per-message array is indexed at run time (loops over ports,
//     slots and fields unrolled, messages in registers), so there is no
//     stack frame up to 128 PEs; selection and routing are branch-free,
//     selection's op tests two masks over op values made once a tick;
//   - a PE's pair of threads splits the loops over slots and ports and
//     every row it moves within shared memory;
//   - up to 128 PEs the lane's program, each PE's FIFOs (`buf`), its inbox
//     and a window of the last rows pushed on its `pend` and `swq` rings
//     live in shared memory as 16-word rows (15 words and a spare, which
//     holds a window row's tag: its ring position), each moved by four
//     128-bit accesses at a per-PE stride of an odd number of 16-byte
//     units (no bank conflicts) and compile-time offsets; a push is
//     written through to device memory (the leaves hold what they held),
//     a pop reads the window when the row's tag is the head's position
//     and device memory otherwise; a FIFO slot is zeroed only where it
//     can hold a word (a message left it, or it held one past the count
//     when the chunk began); `amq` and `mem_meta` are read on the
//     read-only path; `mem_val` (2,048-8,192 words a PE) stays in device
//     memory, and a stream's next words are loaded at the start of the
//     tick, under the other work.
// Past 128 PEs, `buf` lives in device memory (15-word rows), the inbox in
// registers and there are no windows (up to 1,024 threads a CTA).  Every
// addition, subtraction and product that may wrap is done in uint32
// (signed overflow is undefined in C++).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int DEPTH = 3, PORTS = 5, MSG_F = 15, CFG_F = 7;
constexpr int PORT_WORDS = DEPTH * MSG_F;          // 45
constexpr int PE_WORDS = PORTS * PORT_WORDS;       // 225
constexpr int K = PORTS * DEPTH;                   // FIFO slots a PE
constexpr int P_N = 0, P_E = 1, P_S = 2, P_W = 3, P_INJ = 4, OUT_LOCAL = 4;
constexpr int F_VALID = 0, F_DST0 = 1, F_DST1 = 2, F_DST2 = 3, F_PC = 4,
              F_OP = 5, F_OP1C = 7, F_OP2C = 8, F_RES = 9, F_OP1 = 10,
              F_OP2 = 11, F_VIA = 12, F_HOPS = 14;
constexpr int C_OP = 0, C_NEXT_PC = 1, C_ROTATE = 2, C_OP1SEL = 3,
              C_OP2SEL = 4, C_DSTSEL = 5, C_RESSEL = 6;
constexpr int OP_NOP = 0, OP_LOAD2 = 1, OP_LOAD1 = 2, OP_STREAM = 3,
              OP_STORE_ADD = 4, OP_STORE_SET = 5, OP_STORE_MIN = 6,
              OP_CHECKSET = 7, OP_MUL = 8, OP_ADD = 9, OP_SUB = 10,
              OP_MIN = 11, OP_MAX = 12, OP_DIV = 13, OP_MAC = 14;
constexpr int UNSET = 0x7FFF;
constexpr int MODE_OPPORTUNISTIC = 1, MODE_DUAL_ISSUE = 2, MODE_VALIANT = 4;
constexpr int MAX_PES = 1024;       // one CTA a lane
constexpr int SMEM_BUF_PES = 128;   // `buf` in shared memory up to here
constexpr int N_SUMS = 5;           // flits, pending, waiting, streams, amq
// a message row in shared memory: 15 words and a spare (a window row's
// tag), four 16-byte units
constexpr int ROW = 16, TAG = 15;
// per-PE strides in shared memory, odd numbers of 16-byte units: FIFOs
// (15 rows), inbox (4 rows)
constexpr int BUF_STRIDE = PORTS * DEPTH * ROW + 4, IN_STRIDE = 4 * ROW + 4;
// the most rows of a PE's `pend` and `swq` rings kept in shared memory (a
// tick pushes at most 3 pending rows and the stream pauses at a queue of
// STREAM_THROTTLE = 8, so 16 rows hold a pending queue's live rows); the
// launcher halves them until the block's shared memory fits
constexpr int PEND_WINDOW = 16, SWQ_WINDOW = 8;
constexpr size_t SMEM_MAX = 232448; // a block's shared memory on Hopper

#ifdef CYCLE_PHASES
// Profiling build only (python -m repro_torch.bench.profile_engine --kernel
// --phases): each CTA's thread 0 logs the card's clock (%globaltimer, ns)
// and its SM's cycle counter in each of the first PHASE_TICKS ticks of a
// launch, at its marks in time order: the tick's start (0), after barrier
// 1 (1), five marks inside phase 2 (2-6), after barriers 2 and 3 (7, 8),
// three marks inside phase 4 (9-11) and after barrier 4 (12).
constexpr int PHASE_LANES = 64, PHASE_TICKS = 512, PHASE_MARKS = 13;
__device__ unsigned long long cycle_phase_log[PHASE_LANES][PHASE_TICKS]
                                             [PHASE_MARKS][2];
#define PHASE(tick, i)                                                     \
  if (threadIdx.x == 0 && blockIdx.x < PHASE_LANES && (tick) < PHASE_TICKS) { \
    unsigned long long t;                                                  \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                  \
    cycle_phase_log[blockIdx.x][tick][i][0] = t;                           \
    cycle_phase_log[blockIdx.x][tick][i][1] = clock64();                   \
  }
#else
#define PHASE(tick, i)
#endif

struct Args {
  const int* prog; const int* modes; const int* geoms; const int* sub_ids;
  const int* local_ids; const int* cycle0; const int* budget;
  int* buf; int* buf_n; const int* __restrict__ amq; int* amq_head;
  const int* amq_len; int* pend; int* pend_h; int* pend_n; int* mem_val;
  const int* __restrict__ mem_meta;
  unsigned char* stream_on; int* stream_msg; int* stream_base;
  int* stream_left; int* swq; int* swq_h; int* swq_n; int* rr; int* cycle;
  int* st_busy; int* st_exec; int* st_enroute; int* st_stall; int* st_hops;
  int* st_inj;
  int n, p_rows, qcap, pend_cap, swq_cap, m_words, mw, max_cycles, ticks,
      fast_forward, throttle;
  int pend_win, swq_win;   // rows of each ring in shared memory (0 or 2^k)
};

// --- int32 arithmetic with the reference's semantics -----------------------
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int iabs(int a) {
  return a < 0 ? (int)(0u - (uint32_t)a) : a;
}
__device__ __forceinline__ int isign(int a) { return (a > 0) - (a < 0); }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int iclamp(int a, int lo, int hi) {
  return imin(imax(a, lo), hi);
}
// floor division and Python's remainder by a positive divisor, in 32 bits
// (exact: with b > 0 no quotient overflows, and q * b lies between 0 and a)
__device__ __forceinline__ int fdivp(int a, int b) {
  const int q = a / b;
  return a - q * b < 0 ? q - 1 : q;
}
__device__ __forceinline__ int pmodp(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}
template <int B>
__device__ __forceinline__ int pmodc(int a) {
  const int r = a % B;
  return r < 0 ? r + B : r;
}
// floor division by any nonzero divisor (the ALU's OP_DIV), in int64 so
// that INT_MIN / -1 wraps
__device__ __forceinline__ int fdiv64(int a, int b) {
  long long q = (long long)a / b, r = (long long)a % b;
  if (r != 0 && ((r < 0) != (b < 0))) --q;
  return (int)(uint32_t)(unsigned long long)q;
}
__device__ __forceinline__ bool is_alu(int op) {
  return op >= OP_MUL && op <= OP_MAC;
}

// `_pick_one`: the candidate (bit i of `cand`, i < P) with the least
// (i - r) mod P in int32, -1 when there is none.  Where i - r cannot wrap
// (r >= INT_MIN + P), that is the first set bit of the mask rotated right
// by r mod P; below, the reference's priorities in turn.
template <int P>
__device__ __forceinline__ int pick_one(uint32_t cand, int r) {
  if (r < INT_MIN + P) {
    int best = -1, best_prio = INT_MAX;
#pragma unroll 1
    for (int i = 0; i < P; ++i) {
      const int prio = pmodc<P>(wsub(i, r));
      if (((cand >> i) & 1u) && prio < best_prio) {
        best_prio = prio;
        best = i;
      }
    }
    return best;
  }
  constexpr uint32_t FULL = (1u << P) - 1u;
  const int s = pmodc<P>(r);
  const uint32_t rot = ((cand >> s) | (cand << (P - s))) & FULL;
  const int i = __ffs(rot) - 1 + s;
  return cand == 0 ? -1 : i >= P ? i - P : i;
}

// --- message rows ------------------------------------------------------------
// A message in registers is ROW words (the spare last).  A row in shared
// memory (V) is four 16-byte units; in device memory it is MSG_F words.
template <bool V>
__device__ __forceinline__ void load_row(int (&m)[ROW], const int* src) {
  if constexpr (V) {
#pragma unroll
    for (int u = 0; u < ROW / 4; ++u) {
      const int4 v = reinterpret_cast<const int4*>(src)[u];
      m[4 * u] = v.x; m[4 * u + 1] = v.y; m[4 * u + 2] = v.z;
      m[4 * u + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int f = 0; f < MSG_F; ++f) m[f] = src[f];
    m[TAG] = 0;
  }
}
template <bool V>
__device__ __forceinline__ void store_row(int* dst, const int (&m)[ROW]) {
  if constexpr (V) {
#pragma unroll
    for (int u = 0; u < ROW / 4; ++u)
      reinterpret_cast<int4*>(dst)[u] =
          make_int4(m[4 * u], m[4 * u + 1], m[4 * u + 2], m[4 * u + 3]);
  } else {
#pragma unroll
    for (int f = 0; f < MSG_F; ++f) dst[f] = m[f];
  }
}
template <bool V>
__device__ __forceinline__ void zero_row(int* dst) {
  int z[ROW];
#pragma unroll
  for (int f = 0; f < ROW; ++f) z[f] = 0;
  store_row<V>(dst, z);
}

// Up to 128 PEs two threads of a warp run each PE (16 PEs a warp), both
// doing its serial work alike; the pair splits its loops over slots and
// ports, and a thread writes only the two 16-byte units of its half
// (`half`) of any FIFO row, so that the two never race on a word.  These
// writes, and the OR of a pair's partial masks, are the pair's only
// differences.
__device__ __forceinline__ void move_units(int* dst, const int* src, int half,
                                           bool hop = false) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int u = 2 * half + k;
    int4 v = reinterpret_cast<const int4*>(src)[u];
    if (hop && u == F_HOPS / 4) v.z = wadd(v.z, 1);   // F_HOPS = 4 * 3 + 2
    reinterpret_cast<int4*>(dst)[u] = v;
  }
}
__device__ __forceinline__ void store_units(int* dst, const int (&m)[ROW],
                                            int half) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int lo = 4 * k, hi = 8 + 4 * k;
    reinterpret_cast<int4*>(dst)[2 * half + k] =
        half ? make_int4(m[hi], m[hi + 1], m[hi + 2], m[hi + 3])
             : make_int4(m[lo], m[lo + 1], m[lo + 2], m[lo + 3]);
  }
}
__device__ __forceinline__ void zero_units(int* dst, int half) {
#pragma unroll
  for (int k = 0; k < 2; ++k)
    reinterpret_cast<int4*>(dst)[2 * half + k] = make_int4(0, 0, 0, 0);
}
// a row moved within the FIFOs (V: the pair's halves; else whole)
template <bool V>
__device__ __forceinline__ void move_row(int* dst, const int* src, int half) {
  if constexpr (V) {
    move_units(dst, src, half);
  } else {
    int m[ROW];
    load_row<false>(m, src);
    store_row<false>(dst, m);
  }
}
template <bool V>
__device__ __forceinline__ void put_row(int* dst, const int (&m)[ROW],
                                       int half) {
  if constexpr (V) store_units(dst, m, half);
  else store_row<false>(dst, m);
}
template <bool V>
__device__ __forceinline__ void clear_row(int* dst, int half) {
  if constexpr (V) zero_units(dst, half);
  else zero_row<false>(dst);
}
// the OR of a pair's partial masks (`pair`: the warp's threads at work)
template <bool V>
__device__ __forceinline__ uint32_t pair_or(uint32_t v, unsigned pair) {
  if constexpr (V) return v | __shfl_xor_sync(pair, v, 16);
  else return v;
}

__device__ __forceinline__ void rotate_dsts(int* m) {
  m[F_DST0] = m[F_DST1];
  m[F_DST1] = m[F_DST2];
  m[F_DST2] = -1;
}

// `_anchor_tia` on one message (TIA lanes only)
__device__ __forceinline__ void anchor_tia(int* m, int pe) {
  if (is_alu(m[F_OP]) && m[F_DST0] != pe && m[F_VALID] == 1) {
    m[F_DST2] = m[F_DST1];
    m[F_DST1] = m[F_DST0];
    m[F_DST0] = pe;
    m[F_VIA] = -2;
  }
}

// PE id `i`'s (x, y) on a mesh of width w >= 1: the lane's table for
// i in [0, n), floor division and remainder otherwise
__device__ __forceinline__ void xy_of(int i, const int* s_xy, int n, int w,
                                      int* x, int* y) {
  if ((unsigned)i < (unsigned)n) {
    const int v = s_xy[i];
    *x = v & 0xFFFF;
    *y = v >> 16;
  } else {
    *x = pmodp(i, w);
    *y = fdivp(i, w);
  }
}

// the cycle's `route`: west-first, credit-adaptive output port, from the
// destination's offset (dx, dy) and the credit bits of N, E, S, W
__device__ __forceinline__ int route(int dx, int dy, uint32_t credit) {
  const int ns = dy < 0 ? P_N : P_S;
  const bool east_ok = (credit >> P_E) & 1u, ns_ok = (credit >> ns) & 1u;
  const bool prefer_e = (east_ok & !ns_ok) |
                        (!(!east_ok & ns_ok) & (iabs(dx) >= iabs(dy)));
  const int east_or_ns = dy != 0 ? (prefer_e ? P_E : ns) : P_E;
  return dx < 0 ? P_W : dx > 0 ? east_or_ns : dy != 0 ? ns : OUT_LOCAL;
}

// the port a neighbour in direction q sends into us on (N <-> S, E <-> W)
__device__ __forceinline__ constexpr int opp_port(int q) { return q ^ 2; }

// fastforward.path_position: the lone flight's position after t hops
// (floor halves as arithmetic shifts)
__device__ __forceinline__ void path_position(int hx, int hy, int ex, int ey,
                                              int t, int* px, int* py) {
  const int dx = wsub(ex, hx), dy = wsub(ey, hy);
  const int na = iabs(dx), nb = iabs(dy);
  const int sx = isign(dx), sy = isign(dy);
  const int dist = wadd(na, nb);
  const int s = wsub(dist, t);
  const int a_w = imax(wsub(s, nb), 0), b_w = imin(s, nb);
  const int m2 = wmul(2, imin(na, nb));
  const int a_hi = na >= nb ? wsub(s, nb) : na;
  const int b_hi = na >= nb ? nb : wsub(s, na);
  const int a_e = s >= m2 ? a_hi : s >> 1;
  const int b_e = s >= m2 ? b_hi : wadd(s, 1) >> 1;
  const int a = dx < 0 ? a_w : a_e, b = dx < 0 ? b_w : b_e;
  *px = wadd(hx, wmul(sx, wsub(na, a)));
  *py = wadd(hy, wmul(sy, wsub(nb, b)));
}

__device__ __forceinline__ int alu(int op, int a, int b, int res) {
  switch (op) {
    case OP_MUL: return wmul(a, b);
    case OP_ADD: return wadd(a, b);
    case OP_SUB: return wsub(a, b);
    case OP_MIN: return imin(a, b);
    case OP_MAX: return imax(a, b);
    case OP_DIV: return b == 0 ? 0 : fdiv64(a, b);
    case OP_MAC: return wadd(res, wmul(a, b));
    default: return 0;
  }
}

// A PE's ring (`pend` or `swq`): its rows in device memory and a window of
// `nwin` rows in shared memory (row = position mod nwin, its tag the ring
// position last written there, -1 for none).
struct Ring {
  int* rows;       // this PE's rows in device memory
  int* win;        // this PE's window
  int nwin, cap;
  int mask;        // cap - 1 where cap is a power of two, else -1
  __device__ __forceinline__ int pos(int x) const {
    return mask >= 0 ? x & mask : pmodp(x, cap);
  }
  __device__ __forceinline__ void push(int at, int (&m)[ROW]) const {
    int* r = rows + (size_t)at * MSG_F;
#pragma unroll
    for (int f = 0; f < MSG_F; ++f) r[f] = m[f];
    if (nwin > 0) {
      m[TAG] = at;
      store_row<true>(win + (at & (nwin - 1)) * ROW, m);
    }
  }
  __device__ __forceinline__ void pop(int at, int (&m)[ROW]) const {
    if (nwin > 0) {
      load_row<true>(m, win + (at & (nwin - 1)) * ROW);
      if (m[TAG] == at) return;
    }
    const int* r = rows + (size_t)at * MSG_F;
#pragma unroll
    for (int f = 0; f < MSG_F; ++f) m[f] = r[f];
  }
  // the live rows [head, head + min(count, nwin)) into the window
  __device__ __forceinline__ void load(int head, int count) const {
    for (int s = 0; s < nwin; ++s) win[s * ROW + TAG] = -1;
    for (int i = 0; i < imin(count, nwin); ++i) {
      const int at = pos(wadd(head, i));
      int* w = win + (at & (nwin - 1)) * ROW;
      for (int f = 0; f < MSG_F; ++f) w[f] = rows[(size_t)at * MSG_F + f];
      w[TAG] = at;
    }
  }
};

// shared memory a lane, 16-byte units first: [buf] | [inbox] | pend window
// | swq window | lone flights | buf_n | sums | holders | (x, y) table |
// grants | program
__host__ __device__ __forceinline__ int win_stride(int nwin) {
  return nwin > 0 ? nwin * ROW + 4 : 0;
}
size_t smem_bytes(int np, bool smem_buf, int p_rows, int pend_win,
                  int swq_win) {
  const size_t ints =
      (smem_buf ? (size_t)np * (BUF_STRIDE + IN_STRIDE) : 0) +
      (size_t)np * (win_stride(pend_win) + win_stride(swq_win) + ROW) +
      (size_t)np * (PORTS + N_SUMS + 3) + (size_t)p_rows * CFG_F;
  return sizeof(int) * ints;
}

template <int MAXT, bool SMEM_BUF>
__global__ void __launch_bounds__(MAXT) cycle_kernel(const Args a) {
  // FIFO rows: 16-word rows in shared memory, MSG_F-word in device memory
  constexpr bool V = SMEM_BUF;
  constexpr int RW = V ? ROW : MSG_F, PW = DEPTH * RW;
  constexpr int PEW = V ? BUF_STRIDE : PE_WORDS;
  extern __shared__ __align__(16) int smem[];
  // V: thread t runs PE (t / 32) * 16 + t % 16 with its partner t ^ 16;
  // np is the lane's PE slots
  const int t = threadIdx.x, lane = blockIdx.x, n = a.n;
  const int half = V ? (t >> 4) & 1 : 0;
  const int p = V ? (t >> 5) * 16 + (t & 15) : t;
  const int np = V ? blockDim.x / 2 : blockDim.x;
  // the warp's threads of real PEs: every one reaches each of the pair's
  // shuffles and syncs (at the top of a phase's work), so one mask serves
  const int warp_pes = iclamp(n - (t >> 5) * 16, 0, 16);
  const unsigned pair = ((1u << warp_pes) - 1u) * 0x10001u;
  const bool real = p < n, leader = half == 0;
  const int wp = a.pend_win, ws = a.swq_win;
  int* s_in = smem + (V ? np * BUF_STRIDE : 0);
  int* s_pw = s_in + (V ? np * IN_STRIDE : 0);
  int* s_sw = s_pw + np * win_stride(wp);
  int* s_msg = s_sw + np * win_stride(ws);
  int* s_bufn = s_msg + np * ROW;
  int* s_sum = s_bufn + np * PORTS;
  int* s_hold = s_sum + N_SUMS * np;
  int* s_xy = s_hold + np;
  int* s_grant = s_xy + np;          // a PE's four grants, a byte each
  int* s_prog = s_grant + np;
  const size_t row = (size_t)lane * n + (p < n ? p : 0);   // (B, N) index
  int* gbuf = a.buf + (size_t)lane * n * PE_WORDS;
  int* buf = V ? smem : gbuf;
  const int p_last = a.p_rows - 1;
  const int mode = a.modes[lane];
  const int w = a.geoms[2 * lane], gh = a.geoms[2 * lane + 1];
  const bool opp_on = (mode & MODE_OPPORTUNISTIC) != 0;
  const bool dual_on = (mode & MODE_DUAL_ISSUE) != 0;
  const bool val_on = (mode & MODE_VALIANT) != 0;
  const bool ff = a.fast_forward != 0;
  const int mw = a.mw;

  // --- the lane's program and (x, y) table ----------------------------------
  {
    const int* gprog = a.prog + (size_t)lane * a.p_rows * CFG_F;
    for (int i = t; i < a.p_rows * CFG_F; i += blockDim.x) s_prog[i] = gprog[i];
    for (int i = t; i < n; i += blockDim.x)
      s_xy[i] = (fdivp(i, w) << 16) | pmodp(i, w);
    if (leader) s_hold[p] = 0;
  }

  // --- this PE's constants and registers ------------------------------------
  int sub = 0, lid = 0, c0 = 0, bud = 0;
  int xs = 0, ys = 0, nbr[4] = {-1, -1, -1, -1};
  bool active = false;
  int amq_head = 0, amq_len = 0, pend_h = 0, pend_n = 0, stream_on = 0;
  int stream_base = 0, stream_left = 0, swq_h = 0, swq_n = 0, rr = 0, cyc = 0;
  int st_busy = 0, st_exec = 0, st_enroute = 0, st_hops = 0, st_inj = 0;
  int st_stall[PORTS] = {0, 0, 0, 0, 0}, smsg[ROW];
  // FIFO slots (bit port * DEPTH + slot) that may hold a word past their
  // port's count: none once the chunk's first zeroing has passed them
  uint32_t dirty = 0;
  auto pow2_mask = [](int cap) { return (cap & (cap - 1)) == 0 ? cap - 1 : -1; };
  const Ring pend{a.pend + row * a.pend_cap * MSG_F,
                  s_pw + p * win_stride(wp), wp, a.pend_cap,
                  pow2_mask(a.pend_cap)};
  const Ring swq{a.swq + row * a.swq_cap * MSG_F, s_sw + p * win_stride(ws),
                 ws, a.swq_cap, pow2_mask(a.swq_cap)};
  const int* __restrict__ amq = a.amq + row * a.qcap * MSG_F;
  int* memv = a.mem_val + row * a.m_words;
  const int* __restrict__ meta = a.mem_meta + row * a.m_words * 2;
  int* mine = buf + (size_t)p * PEW;
  if (real) {
    sub = a.sub_ids[row]; lid = a.local_ids[row];
    c0 = a.cycle0[row]; bud = a.budget[row];
    xs = pmodp(p, w); ys = fdivp(p, w);
    active = p < wmul(w, gh);
    if (active && ys > 0) nbr[P_N] = p - w;
    if (active && xs < w - 1) nbr[P_E] = p + 1;
    if (active && ys < gh - 1) nbr[P_S] = p + w;
    if (active && xs > 0) nbr[P_W] = p - 1;
    amq_head = a.amq_head[row]; amq_len = a.amq_len[row];
    pend_h = a.pend_h[row]; pend_n = a.pend_n[row];
    stream_on = a.stream_on[row] ? 1 : 0;
    stream_base = a.stream_base[row]; stream_left = a.stream_left[row];
    swq_h = a.swq_h[row]; swq_n = a.swq_n[row];
    rr = a.rr[row]; cyc = a.cycle[row];
    st_busy = a.st_busy[row]; st_exec = a.st_exec[row];
    st_enroute = a.st_enroute[row]; st_hops = a.st_hops[row];
    st_inj = a.st_inj[row];
    const int* g = gbuf + (size_t)p * PE_WORDS;
#pragma unroll
    for (int q = 0; q < PORTS; ++q) {
      st_stall[q] = a.st_stall[row * PORTS + q];
      const int cnt = a.buf_n[row * PORTS + q];
      s_bufn[p * PORTS + q] = cnt;
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) {
        const int* src = g + q * PORT_WORDS + d * MSG_F;
        int any = 0;
        for (int f = 0; f < MSG_F; ++f) {
          any |= src[f];
          if (V && leader) mine[q * PW + d * RW + f] = src[f];
        }
        if (d >= cnt && any != 0) dirty |= 1u << (q * DEPTH + d);
      }
    }
#pragma unroll
    for (int f = 0; f < MSG_F; ++f) smsg[f] = a.stream_msg[row * MSG_F + f];
    smsg[TAG] = 0;
    if (leader) {
      pend.load(pend_h, pend_n);
      swq.load(swq_h, swq_n);
    }
  } else {
#pragma unroll
    for (int f = 0; f < ROW; ++f) smsg[f] = 0;
  }
  for (int k = 0; k < N_SUMS; ++k) s_sum[k * np + p] = 0;
  __syncthreads();

  for (int tick = 0; tick < a.ticks; ++tick) {
    PHASE(tick, 0);
    // ===== 1. this PE's outstanding work into its sub-lane's sums =====
    int bn[PORTS];
    if (real) {
      int flits = 0;
#pragma unroll
      for (int q = 0; q < PORTS; ++q) {
        bn[q] = s_bufn[p * PORTS + q];
        flits = wadd(flits, bn[q]);
      }
      if (leader) {
        atomicAdd(&s_sum[0 * np + sub], flits);
        atomicAdd(&s_sum[1 * np + sub], pend_n);
        atomicAdd(&s_sum[2 * np + sub], swq_n);
        atomicAdd(&s_sum[3 * np + sub], stream_on);
        atomicAdd(&s_sum[4 * np + sub], amq_head < amq_len ? 1 : 0);
      }
    }
    __syncthreads();
    PHASE(tick, 1);

    // ===== 2. everything PE-local, from the state before the tick =====
    bool lone = false, alive = false, act = false;
    int spent = 0;
    int sel_mem = -1, sel_alu = -1;
    bool was_icept = false, mv = false, mv_alu = false, can_emit = false;
    uint32_t removed = 0;       // bit port * DEPTH + slot
    uint32_t clear_via = 0;     // bit port
    int n_grants = 0, icept_port = -1;
    int nxt_a[ROW];             // the ALU's next message
    if (real) {
      // a running stream's next words, loaded under the work before its
      // emission (mem_meta is read-only; a memory write this tick to the
      // same word is forwarded there)
      const int e_addr0 = iclamp(stream_base, 0, mw - 1);
      int pre_val = 0, pre_m0 = 0, pre_m1 = 0;
      if (stream_on) {
        pre_val = memv[e_addr0];
        pre_m0 = __ldg(meta + e_addr0 * 2);
        pre_m1 = __ldg(meta + e_addr0 * 2 + 1);
      }
      const bool stream_was_on = stream_on != 0;
      const int g0 = s_sum[0 * np + sub], g1 = s_sum[1 * np + sub];
      const int g2 = s_sum[2 * np + sub], g3 = s_sum[3 * np + sub];
      const int g4 = s_sum[4 * np + sub];
      const bool gidle = wadd(wadd(wadd(wadd(g0, g1), g2), g3), g4) == 0;
      lone = g0 == 1 && g1 == 0 && g2 == 0 && g3 == 0 && g4 == 0;
      spent = wsub(cyc, c0);
      const bool halt = spent >= bud;
      act = !halt;
      alive = !gidle && cyc < a.max_cycles && !halt;
      if (ff && lone) {
        // the one flit of a lone sub-lane: its holder publishes it
#pragma unroll
        for (int q = 0; q < PORTS; ++q) {
          if (bn[q] > 0) {
            if constexpr (V) {
              move_units(s_msg + sub * ROW, mine + q * PW, half);
            } else {
              int m[ROW];
              load_row<V>(m, mine + q * PW);
              store_row<true>(s_msg + sub * ROW, m);
            }
            s_hold[sub] = p;
          }
        }
      }

      // --- downstream credit (bit q), from the neighbours' occupancy ---
      uint32_t credit = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = nbr[q];
        const int down = s_bufn[imax(s, 0) * PORTS + opp_port(q)];
        credit |= (uint32_t)((s >= 0) & (wsub(DEPTH, down) >= 2)) << q;
      }

      // --- route computation over the heads (used where live), a pair's
      // thread three ports (the sixth past its rows, unused): (x, y) from
      // the table, a destination past it by division after ---
      uint32_t head_v = 0;
#pragma unroll
      for (int q = 0; q < PORTS; ++q) head_v |= (uint32_t)(bn[q] > 0) << q;
      constexpr int RQ = V ? 3 : PORTS;
      const int q0 = V ? 3 * half : 0;
      uint32_t outs = 0, far = 0, clear = 0;   // out ports, 3 bits a port
#pragma unroll
      for (int k = 0; k < RQ; ++k) {
        const int q = q0 + k;
        const int* h = mine + q * PW;
        const int via = h[F_VIA];
        const int dest = via >= 0 ? via : h[F_DST0];
        const bool in = (unsigned)dest < (unsigned)n;
        const int xy = s_xy[in ? dest : 0];
        outs |= (uint32_t)route(wsub(xy & 0xFFFF, xs), wsub(xy >> 16, ys),
                                credit) << (3 * q);
        far |= (uint32_t)!in << q;
        clear |= (uint32_t)((via >= 0) & (dest == p)) << q;
      }
      outs = pair_or<V>(outs, pair) & 0x7FFFu;
      far = pair_or<V>(far, pair) & head_v;
      clear_via = pair_or<V>(clear, pair) & head_v & (act ? 31u : 0u);
      if (far) {
#pragma unroll
        for (int q = 0; q < PORTS; ++q) {
          if (!((far >> q) & 1u)) continue;
          const int* h = mine + q * PW;
          const int dest = h[F_VIA] >= 0 ? h[F_VIA] : h[F_DST0];
          const int o = route(wsub(pmodp(dest, w), xs),
                              wsub(fdivp(dest, w), ys), credit);
          outs = (outs & ~(7u << (3 * q))) | (uint32_t)o << (3 * q);
        }
      }
      int out_port[PORTS];
#pragma unroll
      for (int q = 0; q < PORTS; ++q) out_port[q] = (outs >> (3 * q)) & 7u;
      PHASE(tick, 2);   // lone flight published, credit, routes

      // --- execution selection (dual-issue or one trigger): which ops
      // may issue this tick, as masks over op values (bit op) ---
      const int pend_free = wsub(a.pend_cap, pend_n);
      const bool swq_ok = swq_n < a.swq_cap - 1;
      // memory class OP_LOAD2..OP_CHECKSET, ALU class OP_MUL..OP_MAC
      constexpr uint32_t MEM_OPS = 0xFEu, ALU_OPS = 0x7F00u;
      constexpr uint32_t STREAM_OP = 1u << OP_STREAM;
      constexpr uint32_t STORE_OPS = (1u << OP_STORE_ADD) | (1u << OP_STORE_SET);
      const uint32_t mem_ok =
          (pend_free >= 1 ? MEM_OPS : STORE_OPS | (swq_ok ? STREAM_OP : 0u)) &
          (swq_ok ? MEM_OPS : MEM_OPS & ~STREAM_OP);
      const uint32_t alu_ok = pend_free >= 2 ? ALU_OPS : 0u;
      // (a pair's thread eight slots; the sixteenth, past its rows, unused)
      uint32_t mem_cand = 0, alu_cand = 0;
      if (act && active) {
        uint32_t occ = 0;   // the slots held before the tick
#pragma unroll
        for (int q = 0; q < PORTS; ++q)
          occ |= ((1u << iclamp(bn[q], 0, DEPTH)) - 1u) << (q * DEPTH);
        constexpr int SQ = V ? 8 : K;
        const int i0 = V ? 8 * half : 0;
#pragma unroll
        for (int k = 0; k < SQ; ++k) {
          const int i = i0 + k;
          const int* m = mine + i * RW;
          const int op = m[F_OP], dst0 = m[F_DST0], via = m[F_VIA];
          const bool local = ((occ >> i) & 1u) & (dst0 == p) & (via < 0) &
                             ((unsigned)op < 16u);
          mem_cand |= ((uint32_t)local & (mem_ok >> (op & 15))) << i;
          alu_cand |= ((uint32_t)local & (alu_ok >> (op & 15))) << i;
        }
      }
      mem_cand = pair_or<V>(mem_cand, pair);
      alu_cand = pair_or<V>(alu_cand, pair);
      if (dual_on) {
        sel_mem = pick_one<K>(mem_cand, rr);
        sel_alu = pick_one<K>(alu_cand, wadd(rr, 2));
      } else {
        const int one = pick_one<K>(mem_cand | alu_cand, rr);
        if (one >= 0) {
          if ((mem_cand >> one) & 1u) sel_mem = one; else sel_alu = one;
        }
      }
      if (opp_on) {
        // in-network computing on a passing ALU-class head
        uint32_t icand = 0;
        if (sel_alu < 0 && act && active) {
#pragma unroll
          for (int k = 0; k < RQ; ++k) {
            const int q = q0 + k;
            const int* h = mine + q * PW;
            const int nop = s_prog[iclamp(h[F_PC], 0, p_last) * CFG_F + C_OP];
            const bool c = ((head_v >> q) & 1u) & (h[F_DST0] != p) &
                           (h[F_VIA] < 0) & is_alu(h[F_OP]) &
                           (h[F_OP1C] == 1) & (h[F_OP2C] == 1) &
                           (nop != OP_NOP);
            icand |= (uint32_t)c << q;
          }
        }
        icand = pair_or<V>(icand, pair) & 31u;
        icept_port = pick_one<PORTS>(icand, wadd(rr, 1));
      }
      was_icept = icept_port >= 0;
      if (was_icept) sel_alu = icept_port * DEPTH;
      mv = sel_mem >= 0;
      mv_alu = sel_alu >= 0;
      if (mv) removed |= 1u << sel_mem;
      if (mv_alu && !was_icept) removed |= 1u << sel_alu;
      PHASE(tick, 3);   // selection, interception

      // ===== decode unit (memory-class): its words loaded first =====
      int msg[ROW];
      int addr_res = 0, mem_r1 = 0, mem_r2 = 0, mem_rr = 0;
      int meta_r0 = 0, meta_r1 = 0;
      if (mv) {
        load_row<V>(msg, mine + sel_mem * RW);
        addr_res = iclamp(msg[F_RES], 0, mw - 1);
        mem_r1 = memv[iclamp(msg[F_OP1], 0, mw - 1)];
        mem_r2 = memv[iclamp(msg[F_OP2], 0, mw - 1)];
        mem_rr = memv[addr_res];
        meta_r0 = __ldg(meta + addr_res * 2);
        meta_r1 = __ldg(meta + addr_res * 2 + 1);
      }

      // ===== compute unit (ALU-class), while those loads are in flight =====
      bool emits_a = false;
      if (mv_alu) {
        load_row<V>(nxt_a, mine + sel_alu * RW);
        const int via_in = nxt_a[F_VIA];
        const int* crow = s_prog + iclamp(nxt_a[F_PC], 0, p_last) * CFG_F;
        const int res = alu(nxt_a[F_OP], nxt_a[F_OP1], nxt_a[F_OP2],
                            nxt_a[F_RES]);
        nxt_a[F_OP] = crow[C_OP];
        nxt_a[F_PC] = crow[C_NEXT_PC];
        nxt_a[F_OP1] = res;
        nxt_a[F_OP1C] = 1;
        if (crow[C_ROTATE] == 1 || via_in == -2) rotate_dsts(nxt_a);
        nxt_a[F_VIA] = -1;
        if (!opp_on) anchor_tia(nxt_a, p);
        emits_a = crow[C_OP] != OP_NOP;
        nxt_a[F_VALID] = emits_a ? 1 : 0;
      }

      // ===== decode unit: the next message, then the stream accept =====
      bool emits = false, write_mask = false;
      int new_word = 0;
      if (mv) {
        const int op = msg[F_OP];
        const int* crow = s_prog + iclamp(msg[F_PC], 0, p_last) * CFG_F;
        const int msg_op1 = msg[F_OP1];
        const bool do_add = op == OP_STORE_ADD, do_set = op == OP_STORE_SET;
        const bool improved = msg_op1 < mem_rr;
        const bool do_min = op == OP_STORE_MIN && improved;
        const bool was_unset = mem_rr == UNSET;
        const bool do_chk = op == OP_CHECKSET && was_unset;
        new_word = do_add ? wadd(mem_rr, msg_op1)
                          : (do_set || do_min || do_chk) ? msg_op1 : mem_rr;
        write_mask = do_add || do_set || do_min || do_chk;
        const bool starts_stream = op == OP_STREAM;
        if (starts_stream) {
          // the stream accept (before the issue below)
          swq.push(swq.pos(wadd(swq_h, swq_n)), msg);
          swq_n = wadd(swq_n, 1);
        }
        int* nxt = msg;                 // the message becomes the next
        nxt[F_OP] = crow[C_OP];
        nxt[F_PC] = crow[C_NEXT_PC];
        if (op == OP_LOAD1) { nxt[F_OP1] = mem_r1; nxt[F_OP1C] = 1; }
        if (op == OP_LOAD2) { nxt[F_OP2] = mem_r2; nxt[F_OP2C] = 1; }
        if (crow[C_ROTATE] == 1) rotate_dsts(nxt);
        nxt[F_VIA] = -1;
        if (!opp_on) anchor_tia(nxt, p);
        const bool cont = do_min || do_chk;
        if (do_chk) nxt[F_OP1] = wadd(msg_op1, 1);
        else if (do_min) nxt[F_OP1] = msg_op1;
        if (cont) {
          nxt[F_OP2] = meta_r0; nxt[F_OP2C] = 0; nxt[F_DST0] = meta_r1;
          nxt[F_DST1] = -1; nxt[F_DST2] = -1;
        }
        const bool terminal = op == OP_STORE_ADD || op == OP_STORE_SET;
        const bool cond_no = (op == OP_STORE_MIN && !improved) ||
                             (op == OP_CHECKSET && !was_unset);
        emits = !terminal && !cond_no && !starts_stream &&
                crow[C_OP] != OP_NOP;
        nxt[F_VALID] = emits ? 1 : 0;
      }
      PHASE(tick, 4);   // decode, stream accept, ALU

      // ===== stream issue (memory before the write) =====
      if (!stream_on && swq_n > 0 && act) {
        swq.pop(swq_h, smsg);
        const int t_res = iclamp(smsg[F_RES], 0, mw - 1);
        const int t_op2 = iclamp(smsg[F_OP2], 0, mw - 1);
        const int desc = smsg[F_OP2C] == 1 ? t_res : t_op2;
        const int s_cnt = __ldg(meta + desc * 2), s_base = memv[desc];
        if (s_cnt > 0) stream_on = 1;
        stream_base = s_base;
        stream_left = s_cnt;
        swq_h = swq.pos(wadd(swq_h, 1));
        swq_n = wsub(swq_n, 1);
      }

      // ===== the decode unit's memory write, then the pending pushes =====
      // (a pair writes only once both have read the memory before it)
      if constexpr (V) __syncwarp(pair);
      if (write_mask) memv[addr_res] = new_word;
      if (emits) {
        pend.push(pend.pos(wadd(pend_h, pend_n)), msg);
        pend_n = wadd(pend_n, 1);
      }
      if (emits_a && !was_icept) {
        pend.push(pend.pos(wadd(pend_h, pend_n)), nxt_a);
        pend_n = wadd(pend_n, 1);
      }
      PHASE(tick, 5);   // stream issue, memory write, pending pushes

      // ===== streaming decode: one spawned message (memory after) =====
      can_emit = stream_on && pend_n < a.throttle && act;
      if (can_emit) {
        const int e_addr = iclamp(stream_base, 0, mw - 1);
        int e_val, e_m0, e_m1;
        if (stream_was_on) {
          // the base is the tick's first (an issue needs the stream off)
          e_val = write_mask && addr_res == e_addr ? new_word : pre_val;
          e_m0 = pre_m0;
          e_m1 = pre_m1;
        } else {
          e_val = memv[e_addr];
          e_m0 = __ldg(meta + e_addr * 2);
          e_m1 = __ldg(meta + e_addr * 2 + 1);
        }
        const int* tc = s_prog + iclamp(smsg[F_PC], 0, p_last) * CFG_F;
        const int sel1 = tc[C_OP1SEL], sel2 = tc[C_OP2SEL];
        const int rsel = tc[C_RESSEL];
        int sp[ROW];
#pragma unroll
        for (int f = 0; f < ROW; ++f) sp[f] = smsg[f];
        sp[F_VALID] = 1;
        sp[F_OP] = tc[C_OP];
        sp[F_PC] = tc[C_NEXT_PC];
        sp[F_OP1] = sel1 == 1 ? e_val
                  : sel1 == 2 ? wadd(smsg[F_OP1], e_val) : smsg[F_OP1];
        sp[F_OP1C] = 1;
        sp[F_OP2] = sel2 == 1 ? e_val
                  : sel2 == 2 ? wadd(e_m0, smsg[F_OP2])
                  : sel2 == 3 ? wadd(e_m0, smsg[F_OP1]) : smsg[F_OP2];
        sp[F_OP2C] = sel2 > 0 ? (sel2 == 1 ? 1 : 0) : smsg[F_OP2C];
        sp[F_RES] = rsel == 1 ? wadd(smsg[F_RES], e_m0)
                  : rsel == 2 ? e_m0 : smsg[F_RES];
        if (tc[C_DSTSEL] == 1) {
          sp[F_DST0] = e_m1; sp[F_DST1] = smsg[F_DST1];
          sp[F_DST2] = smsg[F_DST2];
        } else {
          sp[F_DST0] = smsg[F_DST1]; sp[F_DST1] = smsg[F_DST2];
          sp[F_DST2] = -1;
        }
        sp[F_VIA] = -1;
        if (!opp_on) anchor_tia(sp, p);
        pend.push(pend.pos(wadd(pend_h, pend_n)), sp);
        pend_n = wadd(pend_n, 1);
        stream_base = wadd(stream_base, 1);
        stream_left = wsub(stream_left, 1);
      }
      if (!(stream_left > 0)) stream_on = 0;
      PHASE(tick, 6);   // stream emission

      // ===== output arbitration over the heads before the tick =====
      // (the requests for output o in bits 8 * o + port)
      uint32_t req = 0, req_by = 0, granted = 0, stall_local = 0;
#pragma unroll
      for (int q = 0; q < PORTS; ++q) {
        const bool taken = sel_mem == q * DEPTH || sel_alu == q * DEPTH;
        const bool live = ((head_v >> q) & 1u) && !taken && act;
        const bool net = live && out_port[q] < 4;
        req |= (uint32_t)net << q;
        req_by |= (uint32_t)net << (8 * (out_port[q] & 3) + q);
        stall_local |= (uint32_t)(live && out_port[q] == OUT_LOCAL) << q;
      }
      uint32_t grants = 0;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const uint32_t cand = ((credit >> o) & 1u) ? (req_by >> (8 * o)) & 31u
                                                   : 0u;
        const int g = pick_one<PORTS>(cand, wadd(rr, o));
        grants |= (uint32_t)(g & 0xFF) << (8 * o);
        if (g >= 0) {
          granted |= 1u << g;
          removed |= 1u << (g * DEPTH);
          ++n_grants;
        }
      }
      s_grant[p] = (int)grants;
      // head-of-line stalls (network and local), counted where alive
      if (alive) {
        const uint32_t stall = (req & ~granted) | stall_local;
#pragma unroll
        for (int q = 0; q < PORTS; ++q)
          st_stall[q] = wadd(st_stall[q], (stall >> q) & 1u);
      }
    }
    __syncthreads();
    PHASE(tick, 7);

    // ===== 3. what the neighbours granted (their FIFOs before the tick) =====
    uint32_t has_in = 0;
    int inreg[V ? 1 : 4][ROW];   // the inbox past 128 PEs
    if (real) {
      int grants_in[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) grants_in[q] = s_grant[imax(nbr[q], 0)];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = nbr[q];
        const int g = (signed char)(grants_in[q] >> (8 * opp_port(q)));
        if (s < 0 || g < 0) continue;
        if constexpr (V) {
          move_units(s_in + p * IN_STRIDE + q * ROW,
                     buf + (size_t)s * PEW + g * PW, half, true);
        } else {
          int m[ROW];
          load_row<V>(m, buf + (size_t)s * PEW + g * PW);
          m[F_HOPS] = wadd(m[F_HOPS], 1);
#pragma unroll
          for (int f = 0; f < ROW; ++f) inreg[q][f] = m[f];
        }
        has_in |= 1u << q;
      }
    }
    for (int k = 0; k < N_SUMS; ++k) s_sum[k * np + p] = 0;
    __syncthreads();
    PHASE(tick, 8);

    // ===== 4. own FIFOs, injection, statistics, freeze, teleport =====
    if (real) {
      // --- the lone flight's teleport, decided from the state before the
      // tick: the tick then leaves every head row (slot 0) as it was ---
      bool tele = false;
      int fp = -1, aport = 0, t_delta = 0, t_hop = 0;
      int lm[ROW];
      if (ff && lone) {
        load_row<true>(lm, s_msg + sub * ROW);
        const int hold = s_hold[sub];
        const int via = lm[F_VIA];
        const int de = via >= 0 ? via : lm[F_DST0];
        if (de >= 0 && de < wmul(w, gh)) {
          int ex, ey, hx, hy;
          xy_of(de, s_xy, n, w, &ex, &ey);
          xy_of(hold, s_xy, n, w, &hx, &hy);
          const int na = iabs(wsub(ex, hx)), nb = iabs(wsub(ey, hy));
          const int sx = isign(wsub(ex, hx)), sy = isign(wsub(ey, hy));
          const int dist = wadd(na, nb);
          const int nxt_op = s_prog[iclamp(lm[F_PC], 0, p_last) * CFG_F + C_OP];
          const bool icept = is_alu(lm[F_OP]) && lm[F_OP1C] == 1 &&
                             lm[F_OP2C] == 1 && nxt_op != OP_NOP && via < 0 &&
                             opp_on;
          const int remaining = wsub(bud, spent);
          const int cap_left = wsub(a.max_cycles, cyc);
          const int delta = imin(imin(dist, remaining), cap_left);
          if (!icept && delta >= 2) {
            int pxd, pyd, pxp, pyp, pxk, pyk;
            path_position(hx, hy, ex, ey, delta, &pxd, &pyd);
            path_position(hx, hy, ex, ey, wsub(delta, 1), &pxp, &pyp);
            const int stepx = wsub(pxd, pxp), stepy = wsub(pyd, pyp);
            aport = stepx > 0 ? P_W : stepx < 0 ? P_E : stepy > 0 ? P_N : P_S;
            fp = wadd(wmul(pyd, w), pxd);
            const int a_r = wsub(na, wmul(sx, wsub(xs, hx)));
            const int b_r = wsub(nb, wmul(sy, wsub(ys, hy)));
            const int k_r = wsub(dist, wadd(a_r, b_r));
            const int k_c = imin(imax(k_r, 0), dist);
            path_position(hx, hy, ex, ey, k_c, &pxk, &pyk);
            const bool on_path = pxk == xs && pyk == ys && k_r == k_c;
            t_hop = on_path && k_r < delta ? 1 : 0;
            t_delta = delta;
            tele = true;
          }
        }
      }
      PHASE(tick, 9);   // the teleport decided

      // --- stable compaction of the kept slots; a slot past the kept is
      // zeroed where a message left it or a word may remain ---
      int bn2[PORTS];
#pragma unroll
      for (int q = 0; q < PORTS; ++q) {
        // slots (3 bits) held before the tick, kept, and to zero: past
        // the kept, where a message left or a word may remain (a teleport
        // leaves slot 0 as it was)
        const uint32_t occ = (1u << iclamp(bn[q], 0, DEPTH)) - 1u;
        const uint32_t keep = occ & ~(removed >> (q * DEPTH)) & 7u;
        const int kept = __popc(keep);
        const uint32_t past = 7u & ~((1u << kept) - 1u);
        const uint32_t zero = past & (occ | (dirty >> (q * DEPTH))) &
                              (tele ? 6u : 7u);
        bn2[q] = kept;
        if (keep != (1u << kept) - 1u || zero != 0) {
          // stable compaction of the kept slots
          int* f = mine + q * PW;
          int at = 0;
#pragma unroll
          for (int d = 0; d < DEPTH; ++d) {
            if (!((keep >> d) & 1u)) continue;
            if (at != d && !(tele && at == 0))
              move_row<V>(f + at * RW, f + d * RW, half);
            ++at;
          }
#pragma unroll
          for (int d = 0; d < DEPTH; ++d)
            if ((zero >> d) & 1u) clear_row<V>(f + d * RW, half);
          dirty &= ~(zero << (q * DEPTH));
        }
        if (((clear_via >> q) & 1u) && !((removed >> (q * DEPTH)) & 1u) &&
            !tele && (!V || half == F_VIA / 8))
          mine[q * PW + F_VIA] = -1;
      }
      // an intercepted head takes its ALU result in place (it was not
      // requested, so no neighbour read it, and it stays its port's head)
      if (was_icept) put_row<V>(mine + icept_port * PW, nxt_a, half);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!((has_in >> q) & 1u)) continue;
        const int slot = iclamp(bn2[q], 0, DEPTH - 1);
        if (!(tele && slot == 0)) {
          if constexpr (V) {
            move_units(mine + q * PW + slot * RW, s_in + p * IN_STRIDE + q * ROW,
                       half);
          } else {
            int m[ROW];
#pragma unroll
            for (int f = 0; f < ROW; ++f) m[f] = inreg[q][f];
            store_row<V>(mine + q * PW + slot * RW, m);
          }
        }
        bn2[q] = wadd(bn2[q], 1);
      }
      PHASE(tick, 10);  // compaction, waypoints, interception, receives

      // --- injection (AM NIC) ---
      const bool inj_space = bn2[P_INJ] < DEPTH && act && active;
      const bool inj_dyn = inj_space && pend_n > 0;
      const bool inj_stat = inj_space && !(pend_n > 0) && amq_head < amq_len;
      if (inj_dyn || inj_stat) {
        int im[ROW];
        if (inj_dyn) {
          pend.pop(pend_h, im);
        } else {
          const int* r = amq + iclamp(amq_head, 0, a.qcap - 1) * MSG_F;
#pragma unroll
          for (int f = 0; f < MSG_F; ++f) im[f] = __ldg(r + f);
          im[TAG] = 0;
        }
        if (val_on) {
          // ROMM waypoint: the reference's uint32 hash; its moduli
          // |dx| + 1 and |dy| + 1 are positive and at most 2^31
          const uint32_t h = (uint32_t)lid * 2654435761u +
                             (uint32_t)cyc * 40503u;
          int xd, yd;
          xy_of(imax(im[F_DST0], 0), s_xy, n, w, &xd, &yd);
          const int dx = wsub(xd, xs), dy = wsub(yd, ys);
          int rx = (int)(h % ((uint32_t)iabs(dx) + 1u));
          const int ry = (int)((h >> 8) % ((uint32_t)iabs(dy) + 1u));
          if (dx < 0) rx = iabs(dx);
          const int via_pe = wadd(wmul(wadd(ys, wmul(isign(dy), ry)), w),
                                  wadd(xs, wmul(isign(dx), rx)));
          if (im[F_VIA] == -1 && im[F_DST0] != p && via_pe != p &&
              via_pe != im[F_DST0])
            im[F_VIA] = via_pe;
        }
        const int slot = iclamp(bn2[P_INJ], 0, DEPTH - 1);
        if (!(tele && slot == 0))
          put_row<V>(mine + P_INJ * PW + slot * RW, im, half);
        bn2[P_INJ] = wadd(bn2[P_INJ], 1);
      }
      if (inj_dyn) {
        pend_h = pend.pos(wadd(pend_h, 1));
        pend_n = wsub(pend_n, 1);
      }
      if (inj_stat) amq_head = wadd(amq_head, 1);
      PHASE(tick, 11);  // injection

      // --- statistics, frozen where the PE is not alive ---
      const int cyc_pre = cyc, rr_pre = rr, hops_pre = st_hops;
      if (alive) {
        rr = pmodc<PORTS>(wadd(rr, 1));
        cyc = wadd(cyc, 1);
        if (mv || mv_alu || can_emit) st_busy = wadd(st_busy, 1);
        st_exec = wadd(st_exec, (mv ? 1 : 0) + (mv_alu ? 1 : 0));
        if (was_icept) st_enroute = wadd(st_enroute, 1);
        st_hops = wadd(st_hops, n_grants);
        if (inj_dyn || inj_stat) st_inj = wadd(st_inj, 1);
      }

      // --- the lone flight's teleport: the head rows rewritten ---
      if (tele) {
#pragma unroll
        for (int q = 0; q < PORTS; ++q) {
          const bool holder = bn[q] > 0;
          const bool put = p == fp && q == aport;
          int* slot0 = mine + q * PW;
          if (put) {
            int m[ROW];
#pragma unroll
            for (int f = 0; f < ROW; ++f) m[f] = lm[f];
            m[F_HOPS] = wadd(lm[F_HOPS], t_delta);
            put_row<V>(slot0, m, half);
          } else if (holder) {
            clear_row<V>(slot0, half);
            dirty &= ~(1u << (q * DEPTH));
          }
          bn2[q] = wadd(wsub(bn[q], holder ? 1 : 0), put ? 1 : 0);
        }
        cyc = wadd(cyc_pre, t_delta);
        rr = pmodc<PORTS>(wadd(rr_pre, t_delta));
        st_hops = wadd(hops_pre, t_hop);
      }
#pragma unroll
      for (int q = 0; q < PORTS; ++q) s_bufn[p * PORTS + q] = bn2[q];
    }
    __syncthreads();
    PHASE(tick, 12);
  }

  // --- the registers back into the state ------------------------------------
  if (real) {
    a.amq_head[row] = amq_head;
    a.pend_h[row] = pend_h; a.pend_n[row] = pend_n;
    a.stream_on[row] = stream_on ? 1 : 0;
    a.stream_base[row] = stream_base; a.stream_left[row] = stream_left;
    a.swq_h[row] = swq_h; a.swq_n[row] = swq_n;
    a.rr[row] = rr; a.cycle[row] = cyc;
    a.st_busy[row] = st_busy; a.st_exec[row] = st_exec;
    a.st_enroute[row] = st_enroute; a.st_hops[row] = st_hops;
    a.st_inj[row] = st_inj;
    int* g = gbuf + (size_t)p * PE_WORDS;
#pragma unroll
    for (int q = 0; q < PORTS; ++q) {
      a.st_stall[row * PORTS + q] = st_stall[q];
      a.buf_n[row * PORTS + q] = s_bufn[p * PORTS + q];
      if (V && leader)
        for (int d = 0; d < DEPTH; ++d)
          for (int f = 0; f < MSG_F; ++f)
            g[q * PORT_WORDS + d * MSG_F + f] = mine[q * PW + d * RW + f];
    }
#pragma unroll
    for (int f = 0; f < MSG_F; ++f) a.stream_msg[row * MSG_F + f] = smsg[f];
  }
}

// The latency floor of the chunk kernel's barrier shape: the same grid,
// block, shared memory and ticks, four barriers a tick, and each PE's
// `s_bufn` row (at word `bufn_at` of the shared memory) read and written
// between them, so that no tick is dropped; `out` (lanes, np) gets each
// PE's last word.
template <int MAXT>
__global__ void __launch_bounds__(MAXT) floor_kernel(int* out, int ticks,
                                                     int bufn_at) {
  extern __shared__ __align__(16) int smem[];
  const int np = blockDim.x, p = threadIdx.x;
  int* row = smem + bufn_at + p * PORTS;   // (2 np rows: within the sums)
  for (int q = 0; q < PORTS; ++q) row[q] = q;
  __syncthreads();
  for (int tick = 0; tick < ticks; ++tick) {
    const int x = row[0];
    __syncthreads();
    row[1] = wadd(x, tick);
    __syncthreads();
    const int y = row[1];
    __syncthreads();
    row[0] = x ^ y;
    __syncthreads();
  }
  out[(size_t)blockIdx.x * np + p] = row[0];
}

// The launch plan of a lane of `np` threads: its shared memory and window
// rows (PEND_WINDOW and SWQ_WINDOW halved, the larger first, until the
// block fits; none past 128 PEs).  `smem` past SMEM_MAX: no launch.
struct Plan {
  size_t smem;
  int pend_win, swq_win;
};
template <bool SMEM_BUF>
Plan plan(int np, int p_rows) {
  Plan pl{0, SMEM_BUF ? PEND_WINDOW : 0, SMEM_BUF ? SWQ_WINDOW : 0};
  for (;;) {
    pl.smem = smem_bytes(np, SMEM_BUF, p_rows, pl.pend_win, pl.swq_win);
    if (pl.smem <= SMEM_MAX || (pl.pend_win == 0 && pl.swq_win == 0)) break;
    if (pl.swq_win * 2 >= pl.pend_win) pl.swq_win /= 2;
    else pl.pend_win /= 2;
  }
  return pl;
}

// a lane's threads and PE slots: a pair a PE, 16 PEs a warp, up to 128
// PEs (SMEM_BUF); a thread a PE past them
int lane_threads(int n) {
  return n <= SMEM_BUF_PES ? (n + 15) / 16 * 32 : (n + 31) / 32 * 32;
}
int pe_slots(int n) {
  return n <= SMEM_BUF_PES ? lane_threads(n) / 2 : lane_threads(n);
}

template <int MAXT, bool SMEM_BUF>
int launch(Args a, int lanes, int np, void* stream) {
  const Plan pl = plan<SMEM_BUF>(np, a.p_rows);
  if (pl.smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  a.pend_win = pl.pend_win;
  a.swq_win = pl.swq_win;
  cudaError_t err = cudaFuncSetAttribute(
      cycle_kernel<MAXT, SMEM_BUF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = lane_threads(a.n);
  cycle_kernel<MAXT, SMEM_BUF><<<lanes, threads, pl.smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MAXT, bool SMEM_BUF>
int launch_floor(int* out, int lanes, int n, int np, int p_rows, int ticks,
                 void* stream) {
  const Plan pl = plan<SMEM_BUF>(np, p_rows);
  if (pl.smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      floor_kernel<MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  const int bufn_at =
      np * ((SMEM_BUF ? BUF_STRIDE + IN_STRIDE : 0) + win_stride(pl.pend_win) +
            win_stride(pl.swq_win) + ROW);
  const int threads = lane_threads(n);
  floor_kernel<MAXT><<<lanes, threads, pl.smem, (cudaStream_t)stream>>>(
      out, ticks, bufn_at);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `ticks` engine ticks of `lanes` lanes of `n` PEs, every state leaf
// updated in place; returns cudaGetLastError() of the launch (or of the
// attribute call before it), or cudaErrorInvalidValue (1) for a PE axis
// outside 1..MAX_PES or a program too large for shared memory.
int cycle_chunk(const void* prog, const void* modes, const void* geoms,
                const void* sub_ids, const void* local_ids,
                const void* cycle0, const void* budget, void* buf,
                void* buf_n, const void* amq, void* amq_head,
                const void* amq_len, void* pend, void* pend_h, void* pend_n,
                void* mem_val, const void* mem_meta, void* stream_on,
                void* stream_msg, void* stream_base, void* stream_left,
                void* swq, void* swq_h, void* swq_n, void* rr, void* cycle,
                void* st_busy, void* st_exec, void* st_enroute,
                void* st_stall, void* st_hops, void* st_inj, int lanes,
                int n, int p_rows, int qcap, int pend_cap, int swq_cap,
                int m_words, int mw, int max_cycles, int ticks,
                int fast_forward, int throttle, void* stream) {
  if (n < 1 || n > MAX_PES) return (int)cudaErrorInvalidValue;
  Args a;
  a.prog = (const int*)prog; a.modes = (const int*)modes;
  a.geoms = (const int*)geoms; a.sub_ids = (const int*)sub_ids;
  a.local_ids = (const int*)local_ids; a.cycle0 = (const int*)cycle0;
  a.budget = (const int*)budget; a.buf = (int*)buf; a.buf_n = (int*)buf_n;
  a.amq = (const int*)amq; a.amq_head = (int*)amq_head;
  a.amq_len = (const int*)amq_len; a.pend = (int*)pend;
  a.pend_h = (int*)pend_h; a.pend_n = (int*)pend_n;
  a.mem_val = (int*)mem_val; a.mem_meta = (const int*)mem_meta;
  a.stream_on = (unsigned char*)stream_on; a.stream_msg = (int*)stream_msg;
  a.stream_base = (int*)stream_base; a.stream_left = (int*)stream_left;
  a.swq = (int*)swq; a.swq_h = (int*)swq_h; a.swq_n = (int*)swq_n;
  a.rr = (int*)rr; a.cycle = (int*)cycle; a.st_busy = (int*)st_busy;
  a.st_exec = (int*)st_exec; a.st_enroute = (int*)st_enroute;
  a.st_stall = (int*)st_stall; a.st_hops = (int*)st_hops;
  a.st_inj = (int*)st_inj;
  a.n = n; a.p_rows = p_rows; a.qcap = qcap; a.pend_cap = pend_cap;
  a.swq_cap = swq_cap; a.m_words = m_words; a.mw = mw;
  a.max_cycles = max_cycles; a.ticks = ticks; a.fast_forward = fast_forward;
  a.throttle = throttle;
  a.pend_win = a.swq_win = 0;
  const int np = pe_slots(n);
  if (n <= SMEM_BUF_PES)
    return launch<2 * SMEM_BUF_PES, true>(a, lanes, np, stream);
  return launch<MAX_PES, false>(a, lanes, np, stream);
}

// The barrier floor of a chunk of `ticks` ticks of `lanes` lanes of `n`
// PEs and a program of `p_rows` rows (the chunk kernel's launch shape):
// `out` is (lanes, the lane's threads) int32.
int cycle_floor(void* out, int lanes, int n, int p_rows, int ticks,
                void* stream) {
  if (n < 1 || n > MAX_PES) return (int)cudaErrorInvalidValue;
  const int np = pe_slots(n);
  if (n <= SMEM_BUF_PES)
    return launch_floor<2 * SMEM_BUF_PES, true>((int*)out, lanes, n, np,
                                                p_rows, ticks, stream);
  return launch_floor<MAX_PES, false>((int*)out, lanes, n, np, p_rows, ticks,
                                      stream);
}

#ifdef CYCLE_PHASES
// The phase log of the last launches into host (PHASE_LANES x PHASE_TICKS
// x PHASE_MARKS x 2 uint64: ns, SM cycles), zeroed after the copy.
int cycle_phases(void* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, cycle_phase_log,
                                         sizeof(cycle_phase_log));
  if (err != cudaSuccess) return (int)err;
  static unsigned long long zero[PHASE_LANES][PHASE_TICKS][PHASE_MARKS][2];
  return (int)cudaMemcpyToSymbol(cycle_phase_log, zero, sizeof(zero));
}
#endif

}  // extern "C"
