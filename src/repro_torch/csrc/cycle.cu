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
// loads and barriers.  The torch engine pays that chain as ~900 kernel
// launches a tick from the host; here it is paid inside one launch.
//
// The design that follows.  One CTA per lane, one thread per PE (blockDim
// is the PE axis rounded up to a warp; threads past it only join the
// barriers), looping over the chunk's ticks with four barriers a tick:
//   1. each PE adds its outstanding work to its sub-lane's five sums
//      (shared-memory integer atomics: the order of an integer sum is
//      immaterial, so the sums are exact);
//   2. each PE reads its sub-lane's sums (idle, lone flight), its
//      neighbours' occupancy before the tick (credit) and its own FIFOs,
//      and does everything PE-local: selection, decode and ALU, the
//      stream queue, the memory write, the pending-FIFO pushes, the
//      stream emission and the output arbitration, publishing its grants;
//   3. each PE copies the heads its neighbours granted it (their FIFOs
//      are still as before the tick) and, in lone flight, its own heads;
//   4. each PE compacts its FIFOs, clears reached waypoints, writes an
//      intercepted message back, receives in port order N, E, S, W,
//      injects, freezes what is not alive and, on a compressed chunk,
//      rewrites a lone flight from the state before the tick.
// The per-PE registers of the state (heads and counts of the queues, the
// stream's template, the counters) live in registers across the chunk;
// the input FIFOs (`buf`, 900 B a PE) live in dynamic shared memory up to
// 128 PEs (57.6 KB at 8x8) and in device memory beyond; the queues
// (`pend`, `swq`, `amq`) and the memories stay in device memory, where a
// tick touches one row of each.  Every addition, subtraction and product
// that may wrap is done in uint32 (signed overflow is undefined in C++),
// and floor division and Python's remainder are written out.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DEPTH = 3, PORTS = 5, MSG_F = 15, CFG_F = 7;
constexpr int PORT_WORDS = DEPTH * MSG_F;          // 45
constexpr int PE_WORDS = PORTS * PORT_WORDS;       // 225
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
constexpr int MAX_PES = 1024;       // one thread a PE, one CTA a lane
constexpr int SMEM_BUF_PES = 128;   // `buf` in shared memory up to here
constexpr int N_SUMS = 5;           // flits, pending, waiting, streams, amq

struct Args {
  const int* prog; const int* modes; const int* geoms; const int* sub_ids;
  const int* local_ids; const int* cycle0; const int* budget;
  int* buf; int* buf_n; const int* amq; int* amq_head; const int* amq_len;
  int* pend; int* pend_h; int* pend_n; int* mem_val; const int* mem_meta;
  unsigned char* stream_on; int* stream_msg; int* stream_base;
  int* stream_left; int* swq; int* swq_h; int* swq_n; int* rr; int* cycle;
  int* st_busy; int* st_exec; int* st_enroute; int* st_stall; int* st_hops;
  int* st_inj;
  int n, p_rows, qcap, pend_cap, swq_cap, m_words, mw, max_cycles, ticks,
      fast_forward, throttle;
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
// floor division (b != 0), in int64 so that INT_MIN / -1 wraps
__device__ __forceinline__ int fdiv(int a, int b) {
  long long q = (long long)a / b, r = (long long)a % b;
  if (r != 0 && ((r < 0) != (b < 0))) --q;
  return (int)(uint32_t)(unsigned long long)q;
}
// Python's remainder (the sign of the divisor; b != 0)
__device__ __forceinline__ int pmod(int a, int b) {
  long long r = (long long)a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return (int)r;
}
__device__ __forceinline__ bool is_alu(int op) {
  return op >= OP_MUL && op <= OP_MAC;
}
__device__ __forceinline__ bool is_mem(int op) {
  return op >= OP_LOAD2 && op <= OP_CHECKSET;
}

// `_pick_one`: the candidate (bit i of `cand`, i < p) with the least
// (i - r) mod p, -1 when there is none.
__device__ __forceinline__ int pick_one(uint32_t cand, int r, int p) {
  int best = -1, best_prio = 0x7FFFFFFF;
  for (int i = 0; i < p; ++i) {
    if ((cand >> i) & 1u) {
      const int prio = pmod(wsub(i, r), p);
      if (prio < best_prio) { best_prio = prio; best = i; }
    }
  }
  return best;
}

__device__ __forceinline__ void copy_msg(int* dst, const int* src) {
#pragma unroll
  for (int f = 0; f < MSG_F; ++f) dst[f] = src[f];
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

// the cycle's `route`: west-first, credit-adaptive output port
__device__ __forceinline__ int route(int dest, const bool* credit_ok, int w,
                                     int xs, int ys) {
  const int dx = wsub(pmod(dest, w), xs);
  const int dy = wsub(fdiv(dest, w), ys);
  const int ns = dy < 0 ? P_N : P_S;
  const bool east_ok = credit_ok[P_E], ns_ok = credit_ok[ns];
  const bool both = dx > 0 && dy != 0;
  const bool e_only = east_ok && !ns_ok, ns_only = !east_ok && ns_ok;
  const bool prefer_e = e_only || (!ns_only && iabs(dx) >= iabs(dy));
  if (dx < 0) return P_W;
  if (both) return prefer_e ? P_E : ns;
  if (dx > 0) return P_E;
  return dy != 0 ? ns : OUT_LOCAL;
}

// fastforward.path_position: the lone flight's position after t hops
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
  const int a_e = s >= m2 ? a_hi : fdiv(s, 2);
  const int b_e = s >= m2 ? b_hi : fdiv(wadd(s, 1), 2);
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
    case OP_DIV: return b == 0 ? 0 : fdiv(a, b);
    case OP_MAC: return wadd(res, wmul(a, b));
    default: return 0;
  }
}

template <int MAXT, bool SMEM_BUF>
__global__ void __launch_bounds__(MAXT) cycle_kernel(const Args a) {
  extern __shared__ __align__(16) int smem[];
  const int n = a.n, np = blockDim.x, lane = blockIdx.x, p = threadIdx.x;
  const bool real = p < n;
  // shared memory: [buf] | buf_n | sub-lane sums | lone flights | grants
  int* s_bufn = smem + (SMEM_BUF ? np * PE_WORDS : 0);
  int* s_sum = s_bufn + np * PORTS;
  int* s_msg = s_sum + N_SUMS * np;
  int* s_hold = s_msg + np * MSG_F;
  signed char* s_grant = reinterpret_cast<signed char*>(s_hold + np);
  const size_t row = (size_t)lane * n + (p < n ? p : 0);   // (B, N) index
  int* gbuf = a.buf + (size_t)lane * n * PE_WORDS;
  int* buf = SMEM_BUF ? smem : gbuf;
  const int* prog = a.prog + (size_t)lane * a.p_rows * CFG_F;
  const int mode = a.modes[lane];
  const int w = a.geoms[2 * lane], gh = a.geoms[2 * lane + 1];
  const bool opp_on = (mode & MODE_OPPORTUNISTIC) != 0;
  const bool dual_on = (mode & MODE_DUAL_ISSUE) != 0;
  const bool val_on = (mode & MODE_VALIANT) != 0;
  const bool ff = a.fast_forward != 0;
  const int mw = a.mw;

  // --- this PE's constants and registers ------------------------------------
  int sub = 0, lid = 0, c0 = 0, bud = 0;
  int xs = 0, ys = 0, nbr[4] = {-1, -1, -1, -1};
  bool active = false;
  int amq_head = 0, amq_len = 0, pend_h = 0, pend_n = 0, stream_on = 0;
  int stream_base = 0, stream_left = 0, swq_h = 0, swq_n = 0, rr = 0, cyc = 0;
  int st_busy = 0, st_exec = 0, st_enroute = 0, st_hops = 0, st_inj = 0;
  int st_stall[PORTS] = {0, 0, 0, 0, 0}, smsg[MSG_F];
  int* pend = a.pend + row * a.pend_cap * MSG_F;
  int* swq = a.swq + row * a.swq_cap * MSG_F;
  const int* amq = a.amq + row * a.qcap * MSG_F;
  int* memv = a.mem_val + row * a.m_words;
  const int* meta = a.mem_meta + row * a.m_words * 2;
  int* mine = buf + (size_t)p * PE_WORDS;
  if (real) {
    sub = a.sub_ids[row]; lid = a.local_ids[row];
    c0 = a.cycle0[row]; bud = a.budget[row];
    xs = pmod(p, w); ys = fdiv(p, w);
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
    for (int q = 0; q < PORTS; ++q) {
      st_stall[q] = a.st_stall[row * PORTS + q];
      s_bufn[p * PORTS + q] = a.buf_n[row * PORTS + q];
    }
    copy_msg(smsg, a.stream_msg + row * MSG_F);
    if (SMEM_BUF)
      for (int i = 0; i < PE_WORDS; ++i) mine[i] = gbuf[(size_t)p * PE_WORDS + i];
  } else {
    for (int f = 0; f < MSG_F; ++f) smsg[f] = 0;
  }
  for (int k = 0; k < N_SUMS; ++k) s_sum[k * np + p] = 0;
  __syncthreads();

  for (int tick = 0; tick < a.ticks; ++tick) {
    // ===== 1. this PE's outstanding work into its sub-lane's sums =====
    int bn[PORTS];
    if (real) {
      int flits = 0;
      for (int q = 0; q < PORTS; ++q) {
        bn[q] = s_bufn[p * PORTS + q];
        flits = wadd(flits, bn[q]);
      }
      atomicAdd(&s_sum[0 * np + sub], flits);
      atomicAdd(&s_sum[1 * np + sub], pend_n);
      atomicAdd(&s_sum[2 * np + sub], swq_n);
      atomicAdd(&s_sum[3 * np + sub], stream_on);
      atomicAdd(&s_sum[4 * np + sub], amq_head < amq_len ? 1 : 0);
    }
    __syncthreads();

    // ===== 2. everything PE-local, from the state before the tick =====
    bool lone = false, alive = false, act = false;
    int spent = 0;
    int sel_mem = -1, sel_alu = -1, icept_port = -1;
    bool was_icept = false, mv = false, mv_alu = false, can_emit = false;
    uint32_t removed = 0;       // bit port * DEPTH + slot
    uint32_t clear_via = 0;     // bit port
    int n_grants = 0;
    int nxt_a[MSG_F];
    if (real) {
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
        for (int q = 0; q < PORTS; ++q) {
          if (bn[q] > 0) {
            copy_msg(s_msg + sub * MSG_F, mine + q * PORT_WORDS);
            s_hold[sub] = p;
          }
        }
      }

      // --- downstream credit, from the neighbours' occupancy ---
      bool credit_ok[4];
      const int opp[4] = {P_S, P_W, P_N, P_E};
      for (int q = 0; q < 4; ++q) {
        const int down = nbr[q] >= 0 ? s_bufn[nbr[q] * PORTS + opp[q]] : DEPTH;
        credit_ok[q] = nbr[q] >= 0 && wsub(DEPTH, down) >= 2;
      }

      // --- route computation over the heads ---
      int out_port[PORTS];
      bool head_v[PORTS];
      for (int q = 0; q < PORTS; ++q) {
        const int* h = mine + q * PORT_WORDS;
        const int via = h[F_VIA];
        const int dest = via >= 0 ? via : h[F_DST0];
        out_port[q] = route(dest, credit_ok, w, xs, ys);
        head_v[q] = bn[q] > 0;
        if (head_v[q] && via >= 0 && dest == p && act) clear_via |= 1u << q;
      }

      // --- execution selection (dual-issue or one trigger) ---
      const int pend_free = wsub(a.pend_cap, pend_n);
      const bool swq_ok = swq_n < a.swq_cap - 1;
      uint32_t mem_cand = 0, alu_cand = 0, mem_slot = 0;
      for (int q = 0; q < PORTS; ++q) {
        for (int d = 0; d < DEPTH; ++d) {
          const int* m = mine + q * PORT_WORDS + d * MSG_F;
          const int op = m[F_OP];
          const int i = q * DEPTH + d;
          if (is_mem(op)) mem_slot |= 1u << i;
          const bool local = d < bn[q] && m[F_DST0] == p && m[F_VIA] < 0 &&
                             act && active;
          if (!local) continue;
          const bool stream = op == OP_STREAM;
          const bool no_emit = op == OP_STORE_ADD || op == OP_STORE_SET ||
                               (stream && swq_ok);
          if (is_mem(op) && (pend_free >= 1 || no_emit) &&
              (!stream || swq_ok))
            mem_cand |= 1u << i;
          if (is_alu(op) && pend_free >= 2) alu_cand |= 1u << i;
        }
      }
      constexpr int K = PORTS * DEPTH;
      if (dual_on) {
        sel_mem = pick_one(mem_cand, rr, K);
        sel_alu = pick_one(alu_cand, wadd(rr, 2), K);
      } else {
        const int one = pick_one(mem_cand | alu_cand, rr, K);
        if (one >= 0) {
          if ((mem_slot >> one) & 1u) sel_mem = one; else sel_alu = one;
        }
      }
      if (opp_on) {
        // in-network computing on a passing ALU-class head
        uint32_t icand = 0;
        for (int q = 0; q < PORTS; ++q) {
          const int* h = mine + q * PORT_WORDS;
          const int pc = iclamp(h[F_PC], 0, a.p_rows - 1);
          if (head_v[q] && h[F_DST0] != p && h[F_VIA] < 0 &&
              is_alu(h[F_OP]) && h[F_OP1C] == 1 && h[F_OP2C] == 1 &&
              prog[pc * CFG_F + C_OP] != OP_NOP && sel_alu < 0 && act &&
              active)
            icand |= 1u << q;
        }
        icept_port = pick_one(icand, wadd(rr, 1), PORTS);
      }
      was_icept = icept_port >= 0;
      if (was_icept) sel_alu = icept_port * DEPTH;
      mv = sel_mem >= 0;
      mv_alu = sel_alu >= 0;
      if (mv) removed |= 1u << sel_mem;
      if (mv_alu && !was_icept) removed |= 1u << sel_alu;

      // ===== decode unit (memory-class) =====
      int msg[MSG_F], nxt[MSG_F];
      bool emits = false, starts_stream = false, write_mask = false;
      int addr_res = 0, new_word = 0;
      if (mv) {
        copy_msg(msg, mine + sel_mem * MSG_F);
        const int op = msg[F_OP];
        const int* crow = prog + iclamp(msg[F_PC], 0, a.p_rows - 1) * CFG_F;
        addr_res = iclamp(msg[F_RES], 0, mw - 1);
        const int addr_op1 = iclamp(msg[F_OP1], 0, mw - 1);
        const int addr_op2 = iclamp(msg[F_OP2], 0, mw - 1);
        const int mem_r1 = memv[addr_op1], mem_r2 = memv[addr_op2];
        const int mem_rr = memv[addr_res];
        const int meta_r0 = meta[addr_res * 2], meta_r1 = meta[addr_res * 2 + 1];
        const int msg_op1 = msg[F_OP1];
        const bool do_add = op == OP_STORE_ADD, do_set = op == OP_STORE_SET;
        const bool improved = msg_op1 < mem_rr;
        const bool do_min = op == OP_STORE_MIN && improved;
        const bool was_unset = mem_rr == UNSET;
        const bool do_chk = op == OP_CHECKSET && was_unset;
        new_word = do_add ? wadd(mem_rr, msg_op1)
                          : (do_set || do_min || do_chk) ? msg_op1 : mem_rr;
        write_mask = do_add || do_set || do_min || do_chk;
        copy_msg(nxt, msg);
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
        starts_stream = op == OP_STREAM;
        emits = !terminal && !cond_no && !starts_stream &&
                crow[C_OP] != OP_NOP;
        nxt[F_VALID] = emits ? 1 : 0;
      }

      // ===== compute unit (ALU-class) =====
      bool emits_a = false;
      if (mv_alu) {
        int msg_alu[MSG_F];
        copy_msg(msg_alu, mine + sel_alu * MSG_F);
        const int* crow = prog + iclamp(msg_alu[F_PC], 0, a.p_rows - 1) * CFG_F;
        const int res = alu(msg_alu[F_OP], msg_alu[F_OP1], msg_alu[F_OP2],
                            msg_alu[F_RES]);
        copy_msg(nxt_a, msg_alu);
        nxt_a[F_OP] = crow[C_OP];
        nxt_a[F_PC] = crow[C_NEXT_PC];
        nxt_a[F_OP1] = res;
        nxt_a[F_OP1C] = 1;
        if (crow[C_ROTATE] == 1 || msg_alu[F_VIA] == -2) rotate_dsts(nxt_a);
        nxt_a[F_VIA] = -1;
        if (!opp_on) anchor_tia(nxt_a, p);
        emits_a = crow[C_OP] != OP_NOP;
        nxt_a[F_VALID] = emits_a ? 1 : 0;
      }

      // ===== stream accept, then issue (memory before the write) =====
      if (starts_stream) {
        copy_msg(swq + pmod(wadd(swq_h, swq_n), a.swq_cap) * MSG_F, msg);
        swq_n = wadd(swq_n, 1);
      }
      if (!stream_on && swq_n > 0 && act) {
        const int* task = swq + (size_t)swq_h * MSG_F;
        const int t_res = iclamp(task[F_RES], 0, mw - 1);
        const int t_op2 = iclamp(task[F_OP2], 0, mw - 1);
        const int desc = task[F_OP2C] == 1 ? t_res : t_op2;
        const int s_cnt = meta[desc * 2], s_base = memv[desc];
        copy_msg(smsg, task);
        if (s_cnt > 0) stream_on = 1;
        stream_base = s_base;
        stream_left = s_cnt;
        swq_h = pmod(wadd(swq_h, 1), a.swq_cap);
        swq_n = wsub(swq_n, 1);
      }

      // ===== the decode unit's memory write, then the pending pushes =====
      if (write_mask) memv[addr_res] = new_word;
      if (emits) {
        copy_msg(pend + pmod(wadd(pend_h, pend_n), a.pend_cap) * MSG_F, nxt);
        pend_n = wadd(pend_n, 1);
      }
      if (emits_a && !was_icept) {
        copy_msg(pend + pmod(wadd(pend_h, pend_n), a.pend_cap) * MSG_F, nxt_a);
        pend_n = wadd(pend_n, 1);
      }

      // ===== streaming decode: one spawned message (memory after) =====
      can_emit = stream_on && pend_n < a.throttle && act;
      if (can_emit) {
        const int e_addr = iclamp(stream_base, 0, mw - 1);
        const int e_val = memv[e_addr];
        const int e_m0 = meta[e_addr * 2], e_m1 = meta[e_addr * 2 + 1];
        const int* tc = prog + iclamp(smsg[F_PC], 0, a.p_rows - 1) * CFG_F;
        const int sel1 = tc[C_OP1SEL], sel2 = tc[C_OP2SEL];
        const int rsel = tc[C_RESSEL];
        int sp[MSG_F];
        copy_msg(sp, smsg);
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
        copy_msg(pend + pmod(wadd(pend_h, pend_n), a.pend_cap) * MSG_F, sp);
        pend_n = wadd(pend_n, 1);
        stream_base = wadd(stream_base, 1);
        stream_left = wsub(stream_left, 1);
      }
      if (!(stream_left > 0)) stream_on = 0;

      // ===== output arbitration over the heads before the tick =====
      uint32_t req = 0, granted = 0, stall_local = 0;
      for (int q = 0; q < PORTS; ++q) {
        const bool taken = sel_mem == q * DEPTH || sel_alu == q * DEPTH;
        const bool live = head_v[q] && !taken && act;
        if (live && out_port[q] < 4) req |= 1u << q;
        if (live && out_port[q] == OUT_LOCAL) stall_local |= 1u << q;
      }
      for (int o = 0; o < 4; ++o) {
        uint32_t cand = 0;
        if (credit_ok[o])
          for (int q = 0; q < PORTS; ++q)
            if (((req >> q) & 1u) && out_port[q] == o) cand |= 1u << q;
        const int g = pick_one(cand, wadd(rr, o), PORTS);
        s_grant[p * 4 + o] = (signed char)g;
        if (g >= 0) {
          granted |= 1u << g;
          removed |= 1u << (g * DEPTH);
          ++n_grants;
        }
      }
      // head-of-line stalls (network and local), counted where alive
      if (alive) {
        const uint32_t stall = (req & ~granted) | stall_local;
        for (int q = 0; q < PORTS; ++q)
          if ((stall >> q) & 1u) st_stall[q] = wadd(st_stall[q], 1);
      }
    }
    __syncthreads();

    // ===== 3. what the neighbours granted (their FIFOs before the tick) =====
    int inbox[4][MSG_F], snap[PORTS][MSG_F];
    uint32_t has_in = 0;
    if (real) {
      const int opp[4] = {P_S, P_W, P_N, P_E};
      for (int q = 0; q < 4; ++q) {
        const int s = nbr[q];
        if (s < 0) continue;
        const int g = s_grant[s * 4 + opp[q]];
        if (g < 0) continue;
        copy_msg(inbox[q], buf + (size_t)s * PE_WORDS + g * PORT_WORDS);
        inbox[q][F_HOPS] = wadd(inbox[q][F_HOPS], 1);
        has_in |= 1u << q;
      }
      if (ff && lone)
        for (int q = 0; q < PORTS; ++q) copy_msg(snap[q], mine + q * PORT_WORDS);
    }
    if (p < np)
      for (int k = 0; k < N_SUMS; ++k) s_sum[k * np + p] = 0;
    __syncthreads();

    // ===== 4. own FIFOs, injection, statistics, freeze, teleport =====
    if (real) {
      int bn2[PORTS];
      for (int q = 0; q < PORTS; ++q) {
        // stable compaction of the kept slots
        int* f = mine + q * PORT_WORDS;
        int kept = 0;
        for (int d = 0; d < DEPTH; ++d) {
          const bool keep = d < bn[q] && !((removed >> (q * DEPTH + d)) & 1u);
          if (!keep) continue;
          if (kept != d) copy_msg(f + kept * MSG_F, f + d * MSG_F);
          ++kept;
        }
        for (int d = kept; d < DEPTH; ++d)
          for (int k = 0; k < MSG_F; ++k) f[d * MSG_F + k] = 0;
        bn2[q] = kept;
        if (((clear_via >> q) & 1u) && !((removed >> (q * DEPTH)) & 1u))
          f[F_VIA] = -1;
      }
      if (was_icept) copy_msg(mine + icept_port * PORT_WORDS, nxt_a);
      for (int q = 0; q < 4; ++q) {
        if (!((has_in >> q) & 1u)) continue;
        copy_msg(mine + q * PORT_WORDS + iclamp(bn2[q], 0, DEPTH - 1) * MSG_F,
                 inbox[q]);
        bn2[q] = wadd(bn2[q], 1);
      }

      // --- injection (AM NIC) ---
      const bool inj_space = bn2[P_INJ] < DEPTH && act && active;
      const bool inj_dyn = inj_space && pend_n > 0;
      const bool inj_stat = inj_space && !(pend_n > 0) && amq_head < amq_len;
      if (inj_dyn || inj_stat) {
        int im[MSG_F];
        copy_msg(im, inj_dyn ? pend + (size_t)pend_h * MSG_F
                             : amq + iclamp(amq_head, 0, a.qcap - 1) * MSG_F);
        if (val_on) {
          // ROMM waypoint: the reference's uint32 hash
          const uint32_t h = (uint32_t)lid * 2654435761u +
                             (uint32_t)cyc * 40503u;
          const int dstp = imax(im[F_DST0], 0);
          const int dx = wsub(pmod(dstp, w), xs), dy = wsub(fdiv(dstp, w), ys);
          int rx = (int)((long long)h % ((long long)iabs(dx) + 1));
          const int ry = (int)((long long)(h >> 8) % ((long long)iabs(dy) + 1));
          if (dx < 0) rx = iabs(dx);
          const int via_pe = wadd(wmul(wadd(ys, wmul(isign(dy), ry)), w),
                                  wadd(xs, wmul(isign(dx), rx)));
          if (im[F_VIA] == -1 && im[F_DST0] != p && via_pe != p &&
              via_pe != im[F_DST0])
            im[F_VIA] = via_pe;
        }
        copy_msg(mine + P_INJ * PORT_WORDS +
                 iclamp(bn2[P_INJ], 0, DEPTH - 1) * MSG_F, im);
        bn2[P_INJ] = wadd(bn2[P_INJ], 1);
      }
      if (inj_dyn) {
        pend_h = pmod(wadd(pend_h, 1), a.pend_cap);
        pend_n = wsub(pend_n, 1);
      }
      if (inj_stat) amq_head = wadd(amq_head, 1);

      // --- statistics, frozen where the PE is not alive ---
      const int cyc_pre = cyc, rr_pre = rr, hops_pre = st_hops;
      if (alive) {
        rr = pmod(wadd(rr, 1), PORTS);
        cyc = wadd(cyc, 1);
        if (mv || mv_alu || can_emit) st_busy = wadd(st_busy, 1);
        st_exec = wadd(st_exec, (mv ? 1 : 0) + (mv_alu ? 1 : 0));
        if (was_icept) st_enroute = wadd(st_enroute, 1);
        st_hops = wadd(st_hops, n_grants);
        if (inj_dyn || inj_stat) st_inj = wadd(st_inj, 1);
      }

      // --- the lone flight's teleport, from the state before the tick ---
      if (ff && lone) {
        const int* m = s_msg + sub * MSG_F;
        const int hold = s_hold[sub];
        const int via = m[F_VIA];
        const int de = via >= 0 ? via : m[F_DST0];
        const bool in_mesh = de >= 0 && de < wmul(w, gh);
        const int dec = imax(de, 0);
        const int ex = pmod(dec, w), ey = fdiv(dec, w);
        const int hx = pmod(hold, w), hy = fdiv(hold, w);
        const int na = iabs(wsub(ex, hx)), nb = iabs(wsub(ey, hy));
        const int sx = isign(wsub(ex, hx)), sy = isign(wsub(ey, hy));
        const int dist = wadd(na, nb);
        const int nxt_op = prog[iclamp(m[F_PC], 0, a.p_rows - 1) * CFG_F + C_OP];
        const bool icept = is_alu(m[F_OP]) && m[F_OP1C] == 1 &&
                           m[F_OP2C] == 1 && nxt_op != OP_NOP && via < 0 &&
                           opp_on;
        const int remaining = wsub(bud, spent);
        const int cap_left = wsub(a.max_cycles, cyc_pre);
        const int delta = imin(imin(dist, remaining), cap_left);
        if (in_mesh && !icept && delta >= 2) {
          int pxd, pyd, pxp, pyp, pxk, pyk;
          path_position(hx, hy, ex, ey, delta, &pxd, &pyd);
          path_position(hx, hy, ex, ey, wsub(delta, 1), &pxp, &pyp);
          const int stepx = wsub(pxd, pxp), stepy = wsub(pyd, pyp);
          const int aport = stepx > 0 ? P_W : stepx < 0 ? P_E
                          : stepy > 0 ? P_N : P_S;
          const int fp = wadd(wmul(pyd, w), pxd);
          const int rx = pmod(p, w), ry = fdiv(p, w);
          const int a_r = wsub(na, wmul(sx, wsub(rx, hx)));
          const int b_r = wsub(nb, wmul(sy, wsub(ry, hy)));
          const int k_r = wsub(dist, wadd(a_r, b_r));
          const int k_c = imin(imax(k_r, 0), dist);
          path_position(hx, hy, ex, ey, k_c, &pxk, &pyk);
          const bool on_path = pxk == rx && pyk == ry && k_r == k_c;
          for (int q = 0; q < PORTS; ++q) {
            const bool holder = bn[q] > 0;
            const bool put = p == fp && q == aport;
            int* slot0 = mine + q * PORT_WORDS;
            if (put) {
              copy_msg(slot0, m);
              slot0[F_HOPS] = wadd(m[F_HOPS], delta);
            } else if (holder) {
              for (int k = 0; k < MSG_F; ++k) slot0[k] = 0;
            } else {
              copy_msg(slot0, snap[q]);
            }
            bn2[q] = wadd(wsub(bn[q], holder ? 1 : 0), put ? 1 : 0);
          }
          cyc = wadd(cyc_pre, delta);
          rr = pmod(wadd(rr_pre, delta), PORTS);
          st_hops = wadd(hops_pre, on_path && k_r < delta ? 1 : 0);
        }
      }
      for (int q = 0; q < PORTS; ++q) s_bufn[p * PORTS + q] = bn2[q];
    }
    __syncthreads();
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
    for (int q = 0; q < PORTS; ++q) {
      a.st_stall[row * PORTS + q] = st_stall[q];
      a.buf_n[row * PORTS + q] = s_bufn[p * PORTS + q];
    }
    copy_msg(a.stream_msg + row * MSG_F, smsg);
    if (SMEM_BUF)
      for (int i = 0; i < PE_WORDS; ++i) gbuf[(size_t)p * PE_WORDS + i] = mine[i];
  }
}

size_t smem_bytes(int np, bool smem_buf) {
  return sizeof(int) * ((smem_buf ? (size_t)np * PE_WORDS : 0) +
                        (size_t)np * (PORTS + N_SUMS + MSG_F + 1)) +
         (size_t)np * 4;
}

template <int MAXT, bool SMEM_BUF>
int launch(const Args& a, int lanes, int np, void* stream) {
  const size_t smem = smem_bytes(np, SMEM_BUF);
  cudaError_t err = cudaFuncSetAttribute(
      cycle_kernel<MAXT, SMEM_BUF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cycle_kernel<MAXT, SMEM_BUF><<<lanes, np, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `ticks` engine ticks of `lanes` lanes of `n` PEs, every state leaf
// updated in place; returns cudaGetLastError() of the launch (or of the
// attribute call before it), or cudaErrorInvalidValue (1) for a PE axis
// outside 1..MAX_PES.
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
  const int np = (n + 31) / 32 * 32;
  if (n <= SMEM_BUF_PES) return launch<256, true>(a, lanes, np, stream);
  return launch<MAX_PES, false>(a, lanes, np, stream);
}

}  // extern "C"
