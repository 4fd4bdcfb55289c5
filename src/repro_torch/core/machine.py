"""Nexus Machine cycle-level simulator (paper §3, Fig. 8) — in PyTorch.

A port of the JAX reference engine (``repro.core.machine``) that is
bit-identical to it: the whole PE array of every lane advances one clock
per call of the cycle function, and all state lives in fixed-shape int32 /
bool tensors (struct-of-arrays messages, see :mod:`repro_torch.core.am`).

Where the reference ``jax.vmap``s one lane's cycle over a batch, this port
writes the lane axis out: every :class:`MachineState` leaf carries a
leading ``B`` axis, and the per-lane fabric mode ``(B,)`` and mesh
geometry ``(B, 2)`` are runtime tensors, so one engine steps a whole
(workload x mode x size) grid.  PE axes are padded to the batch-wide
``N_max``; PEs at index >= width*height are inactive, exactly as in the
reference's traced-geometry engine.  Where the reference runs a
``lax.while_loop`` over ``lax.scan`` chunks, this port runs a Python loop
over chunks with one host synchronisation per chunk.  Sub-mesh lane
packing (``run_many(pack=True)``, waves of super-lanes), per-lane
deadlines and the event-compressed engine (``cfg.fast_forward``, see
:mod:`repro_torch.core.fastforward`) are ported as in the reference;
sharding the lane axis over several cards is not yet.

Only the reference's traced engine axes are ported
(``traced_modes=True``, ``traced_geometry=True``); the static golden
paths raise :class:`NotImplementedError`.  The integer semantics follow
the reference exactly: floor division and Python-style modulo on possibly
negative operands, first-index ``argmin``/``argmax`` tie-breaking, stable
compaction, uint32 wraparound in the Valiant waypoint hash (emulated in
int64), and int32 for every state leaf.

The cycle updates the large queue tensors (``pend``, ``swq``) and the data
memory (``mem_val``) of the state it is given in place, so a caller that
needs the previous state keeps a copy; every other leaf is a new tensor.

Every entry point runs on the card (``device="cuda"``) unless the caller
asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.am import (
    C_DSTSEL, C_NEXT_PC, C_OP, C_OP1SEL, C_OP2SEL, C_RESSEL, C_ROTATE, CFG_F,
    F_DST0, F_DST1, F_DST2, F_HOPS, F_OP, F_OP1, F_OP1C, F_OP2, F_OP2C, F_PC,
    F_RES, F_VALID, F_VIA, MSG_F, OP_ADD, OP_CHECKSET, OP_DIV, OP_LOAD1,
    OP_LOAD2, OP_MAC, OP_MAX, OP_MIN, OP_MUL, OP_NOP, OP_STORE_ADD,
    OP_STORE_MIN, OP_STORE_SET, OP_STREAM, OP_SUB, UNSET, is_alu_op,
    is_mem_op,
)

DEPTH = 3          # input-buffer registers per port (§3.3.2)
PORTS = 5          # N, E, S, W, INJECT
P_N, P_E, P_S, P_W, P_INJ = range(5)
OUT_LOCAL = 4      # "output port" id meaning ejection to the Input NI
# Deep pending FIFO + backpressure-throttled stream emission: the same
# consumption guarantee as the reference (see repro.core.machine).
PEND_CAP = 512
STREAM_THROTTLE = 8   # stream unit pauses while pending queue is this deep
assert STREAM_THROTTLE <= PEND_CAP - 3, "stream throttle must sit below cap"

# --- fabric execution modes (per-lane runtime data) -------------------------
MODE_OPPORTUNISTIC = 1   # in-network execution on idle PEs en route (§3.1.3)
MODE_DUAL_ISSUE = 2      # decode + compute units retire in the same cycle
MODE_VALIANT = 4         # randomized minimal-path (ROMM) injection routing

MODE_NEXUS = MODE_OPPORTUNISTIC | MODE_DUAL_ISSUE
MODE_TIA = 0
MODE_TIA_VALIANT = MODE_VALIANT

#: The paper's three fabric architectures, by name, in Fig. 11-14 order.
FABRIC_MODES = {
    "nexus": MODE_NEXUS,
    "tia": MODE_TIA,
    "tia_valiant": MODE_TIA_VALIANT,
}

_U32 = 0xFFFFFFFF


def resolve_mode(mode) -> int:
    """Mode name (``FABRIC_MODES`` key) or raw bitmask -> int code."""
    if isinstance(mode, str):
        try:
            return FABRIC_MODES[mode]
        except KeyError:
            raise ValueError(f"unknown fabric mode {mode!r}; known: "
                             f"{sorted(FABRIC_MODES)}") from None
    code = int(mode)
    if not 0 <= code < 8:
        raise ValueError(f"mode bitmask out of range: {code}")
    return code


def mode_code(cfg: "MachineConfig") -> int:
    """The mode bitmask a config's flags describe (its default lane mode)."""
    return ((MODE_OPPORTUNISTIC if cfg.opportunistic else 0)
            | (MODE_DUAL_ISSUE if cfg.dual_issue else 0)
            | (MODE_VALIANT if cfg.valiant else 0))


@dataclasses.dataclass(frozen=True)
class MachineConfig:
    """Machine parameters (the reference's fields and defaults).

    ``opportunistic`` / ``valiant`` / ``dual_issue`` and ``width`` /
    ``height`` only name the default lane mode and geometry: the engine
    reads both per lane at run time.  ``traced_modes=False`` and
    ``traced_geometry=False`` (the reference's static golden paths) are
    not ported and raise :class:`NotImplementedError`.

    ``fast_forward=True`` (the default) runs the event-compressed engine
    of :mod:`repro_torch.core.fastforward`: a sub-lane whose only event
    is one message in uncontended flight advances by the message's
    remaining hop distance in one masked step.  ``fast_forward=False``
    keeps the plain tick loop.  Both give the same bits.
    """

    width: int = 4
    height: int = 4
    mem_words: int = 512          # 1 KB of 16-bit words per PE (Table 1)
    queue_cap: int = 2048         # AM-queue entries held per PE
    stream_wait_cap: int = 2048   # stream-task scheduler queue
    opportunistic: bool = True    # False => TIA baseline
    valiant: bool = False         # True  => TIA-Valiant baseline
    dual_issue: bool = True       # False => TIA single-trigger dispatch
    max_cycles: int = 200_000
    traced_modes: bool = True
    traced_geometry: bool = True
    fast_forward: bool = True

    @property
    def n_pes(self) -> int:
        return self.width * self.height


def _require_traced(cfg: MachineConfig) -> None:
    if not (cfg.traced_modes and cfg.traced_geometry):
        raise NotImplementedError(
            "the static golden engines (traced_modes=False / "
            "traced_geometry=False) are not ported; the port steps the "
            "traced engine axes only")


class MachineState(NamedTuple):
    """Complete fabric state: int32/bool tensors with a leading lane axis B
    (field names and order as in the reference)."""

    buf: torch.Tensor        # (B, N, 5, DEPTH, MSG_F) input-port FIFOs
    buf_n: torch.Tensor      # (B, N, 5) occupancy
    amq: torch.Tensor        # (B, N, QCAP, MSG_F) static AM queues (read-only)
    amq_head: torch.Tensor   # (B, N)
    amq_len: torch.Tensor    # (B, N)
    pend: torch.Tensor       # (B, N, PEND_CAP, MSG_F) output FIFO to inject
    pend_h: torch.Tensor     # (B, N) circular-buffer head (oldest entry)
    pend_n: torch.Tensor     # (B, N)
    mem_val: torch.Tensor    # (B, N, MEM) local data memory (values)
    mem_meta: torch.Tensor   # (B, N, MEM, 2) per-word metadata
    stream_on: torch.Tensor  # (B, N) bool: streaming decode active
    stream_msg: torch.Tensor  # (B, N, MSG_F) template message being streamed
    stream_base: torch.Tensor  # (B, N) current element address
    stream_left: torch.Tensor  # (B, N) elements remaining
    swq: torch.Tensor        # (B, N, SWQ, MSG_F) stream-task wait queue
    swq_h: torch.Tensor      # (B, N) circular-buffer head (oldest entry)
    swq_n: torch.Tensor      # (B, N)
    rr: torch.Tensor         # (B, N) round-robin priority pointer
    cycle: torch.Tensor      # (B, N) per-PE cycle counter
    st_busy: torch.Tensor       # (B, N) cycles each PE executed/streamed
    st_exec: torch.Tensor       # (B, N) instructions executed per PE
    st_enroute: torch.Tensor    # (B, N) executed opportunistically en route
    st_stall: torch.Tensor      # (B, N, 5) head-of-line stall cycles per port
    st_hops: torch.Tensor       # (B, N) link traversals (sender-attributed)
    st_inj: torch.Tensor        # (B, N) messages injected


def init_state(cfg: MachineConfig, static_ams, amq_len, mem_val, mem_meta,
               *, device="cuda") -> MachineState:
    """Build the initial state from compiler outputs, on ``device``.

    Args:
      static_ams: (..., N, QCAP, MSG_F) per-PE compiled static AMs.
      amq_len:    (..., N) number of valid entries per queue.
      mem_val/mem_meta: initial data-memory images.

    Leading axes (the lane axis ``B``) are kept as they are.  The PE-axis
    length is taken from ``static_ams`` (padded lanes start, and stay,
    all-zero).
    """
    def t(a):
        # a copy: the cycle updates ``mem_val`` in place, and on the CPU
        # ``as_tensor`` would share the caller's numpy memory
        return torch.tensor(np.asarray(a, np.int32), device=device)

    static_ams = t(static_ams)
    lead = tuple(static_ams.shape[:-3])
    n = int(static_ams.shape[-3])

    def z(*shape, dtype=torch.int32):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    return MachineState(
        buf=z(n, PORTS, DEPTH, MSG_F),
        buf_n=z(n, PORTS),
        amq=static_ams,
        amq_head=z(n),
        amq_len=t(amq_len),
        pend=z(n, PEND_CAP, MSG_F),
        pend_h=z(n),
        pend_n=z(n),
        mem_val=t(mem_val),
        mem_meta=t(mem_meta),
        stream_on=z(n, dtype=torch.bool),
        stream_msg=z(n, MSG_F),
        stream_base=z(n),
        stream_left=z(n),
        swq=z(n, cfg.stream_wait_cap, MSG_F),
        swq_h=z(n),
        swq_n=z(n),
        rr=z(n),
        cycle=z(n),
        st_busy=z(n),
        st_exec=z(n),
        st_enroute=z(n),
        st_stall=z(n, PORTS),
        st_hops=z(n),
        st_inj=z(n),
    )


# ----------------------------------------------------------------------------
# Small integer helpers (the reference's jnp semantics, made explicit)
# ----------------------------------------------------------------------------
def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _fdiv(a, b):
    """Floor division (Python/JAX ``//``) on integer tensors."""
    return torch.div(a, b, rounding_mode="floor")


def _select(conds, vals, default):
    """``jnp.select``: the FIRST true condition wins (nested in reverse)."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


def _onehot_take(m: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``einsum('...kf,...k->...f', m, sel)`` for an at-most-one-hot bool
    ``sel``, as a masked integer sum (CUDA has no integer einsum)."""
    return _i32((m * sel[..., None]).sum(-2))


def _take_row(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[b, p, idx[b, p]]`` for a (B, N, L, ...) tensor and (B, N) idx."""
    b, n = idx.shape
    rest = a.shape[3:]
    g = idx.long().reshape(b, n, 1, *([1] * len(rest))).expand(
        b, n, 1, *rest)
    return torch.gather(a, 2, g).squeeze(2)


def _put_row(a: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
             mask: torch.Tensor) -> None:
    """In place: ``a[b, p, idx[b, p]] = val[b, p]`` where ``mask[b, p]``
    (elsewhere the row keeps its value).  One index per (b, p), so the
    scatter has no duplicate-index hazard."""
    b, n = idx.shape
    rest = a.shape[3:]
    g = idx.long().reshape(b, n, 1, *([1] * len(rest))).expand(
        b, n, 1, *rest)
    cur = torch.gather(a, 2, g)
    m = mask.reshape(b, n, 1, *([1] * len(rest)))
    a.scatter_(2, g, torch.where(m, val.unsqueeze(2), cur))


def _prog_rows(prog: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Config-memory rows ``prog[b, clip(pc)]`` for (B, ...) pcs."""
    b = prog.shape[0]
    idx = pc.clamp(0, prog.shape[1] - 1).long().reshape(b, -1)
    rows = torch.gather(prog, 1, idx[..., None].expand(b, idx.shape[1],
                                                       CFG_F))
    return rows.reshape(*pc.shape, CFG_F)


# ----------------------------------------------------------------------------
# ALU
# ----------------------------------------------------------------------------
def _alu(op, a, b, res):
    """Vectorized ALU (op may be any opcode; result valid for ALU-class)."""
    zero = torch.zeros_like(a)
    div = torch.where(b == 0, zero, _fdiv(a, torch.where(b == 0, 1, b)))
    return _select(
        [op == OP_MUL, op == OP_ADD, op == OP_SUB, op == OP_MIN,
         op == OP_MAX, op == OP_DIV, op == OP_MAC],
        [a * b, a + b, a - b, torch.minimum(a, b), torch.maximum(a, b), div,
         res + a * b],
        zero,
    )


def _pick_one(cand: torch.Tensor, rr: torch.Tensor) -> torch.Tensor:
    """Round-robin selection of one True entry along the last axis.

    cand: (..., P) bool; rr: (...) starting priority. Returns one-hot
    (..., P) bool.  ``argmin`` returns the first minimum, as in JAX.
    """
    p = cand.shape[-1]
    ar = torch.arange(p, dtype=torch.int32, device=cand.device)
    prio = torch.remainder(ar - rr[..., None], p)
    score = torch.where(cand, prio, p + 1)
    sel = torch.argmin(score, dim=-1)
    onehot = sel[..., None] == ar
    return onehot & cand.any(-1, keepdim=True) & cand


def _rotate_dsts(msg: torch.Tensor) -> torch.Tensor:
    """R1 <- R2 <- R3 <- -1 on a (..., MSG_F) message tensor."""
    out = msg.clone()
    out[..., F_DST0] = msg[..., F_DST1]
    out[..., F_DST1] = msg[..., F_DST2]
    out[..., F_DST2] = -1
    return out


def _anchor_tia(nxt: torch.Tensor, pe_ids: torch.Tensor) -> torch.Tensor:
    """TIA semantics (§2.2): compute is *anchored* with the data.

    An emitted ALU-class instruction executes on the emitting PE before the
    message moves on: retarget it to self, push the true destination down
    the list, and mark it with F_VIA = -2 so execution knows to rotate the
    list back afterwards.  ``nxt`` is (B, N, MSG_F), ``pe_ids`` (N,).
    """
    anchor = is_alu_op(nxt[..., F_OP]) & (nxt[..., F_DST0] != pe_ids) & \
        (nxt[..., F_VALID] == 1)
    out = nxt.clone()
    out[..., F_DST2] = torch.where(anchor, nxt[..., F_DST1], nxt[..., F_DST2])
    out[..., F_DST1] = torch.where(anchor, nxt[..., F_DST0], nxt[..., F_DST1])
    out[..., F_DST0] = torch.where(anchor, pe_ids, nxt[..., F_DST0])
    out[..., F_VIA] = torch.where(anchor, -2, nxt[..., F_VIA])
    return out


# ----------------------------------------------------------------------------
# One clock cycle
# ----------------------------------------------------------------------------
def _make_cycle(cfg: MachineConfig, n_pes: int | None = None):
    """Build the batched cycle transition.

    Returns ``cycle(prog, mode, geom, st, local_ids=None, halt=None) -> st``
    where ``prog`` is the (B, P, CFG_F) config memory, ``mode`` a (B,)
    int32 mode bitmask (see :data:`FABRIC_MODES`), ``geom`` a (B, 2) int32
    ``(width, height)`` tensor and ``st`` a batched :class:`MachineState`
    whose PE axes have length ``n_pes``.

    ``local_ids`` (B, N) is the per-PE id within its own sub-mesh (default:
    the PE index); it only feeds the Valiant waypoint hash.  ``halt`` is an
    optional (B, N) bool mask of budget-halted PEs, which make no state
    transition this tick (no execution, no transit request, no
    stall/cycle/rr advance); ``halt=None`` is the unconditional tick.
    """
    _require_traced(cfg)
    n = cfg.n_pes if n_pes is None else int(n_pes)
    opp_list = [P_S, P_W, P_N, P_E]
    cache: dict = {}

    def consts(device):
        c = cache.get(device)
        if c is None:
            c = dict(pe=torch.arange(n, dtype=torch.int32, device=device),
                     opp=torch.tensor(opp_list, dtype=torch.int64,
                                      device=device),
                     dep=torch.arange(DEPTH, dtype=torch.int32,
                                      device=device))
            cache[device] = c
        return c

    def route(dest, credit_ok, w, xs, ys):
        """West-first turn-model output port for (B,N,P) dest PE ids, with
        the congestion-aware choice between the two permitted minimal
        directions (§3.3.2).  Undefined (but computed) where dest < 0."""
        w3 = w[:, :, None]
        dx = torch.remainder(dest, w3) - xs[:, :, None]
        dy = _fdiv(dest, w3) - ys[:, :, None]
        ns = torch.where(dy < 0, P_N, P_S)
        east_ok = credit_ok[:, :, P_E][:, :, None]
        ns_ok = torch.gather(credit_ok, 2, ns.long())
        both = (dx > 0) & (dy != 0)
        # adaptive: among {E, N/S} prefer the one with credit; tie -> larger
        # remaining displacement.
        e_only = east_ok & ~ns_ok
        ns_only = ~east_ok & ns_ok
        prefer_e = e_only | (~ns_only & (dx.abs() >= dy.abs()))
        port = torch.where(
            dx < 0, P_W,
            torch.where(both, torch.where(prefer_e, P_E, ns),
                        torch.where(dx > 0, P_E,
                                    torch.where(dy != 0, ns, OUT_LOCAL))))
        return _i32(port)

    def cycle(prog, mode, geom, st: MachineState, local_ids=None,
              halt=None) -> MachineState:
        dev = st.buf.device
        c = consts(dev)
        pe, dep = c["pe"], c["dep"]
        bsz = st.buf.shape[0]
        bi = torch.arange(bsz, device=dev)[:, None]          # (B,1)
        pi = torch.arange(n, device=dev)[None, :]            # (1,N)
        sub_local = pe[None, :].expand(bsz, n) if local_ids is None \
            else local_ids
        act = torch.ones((bsz, n), dtype=torch.bool, device=dev) \
            if halt is None else ~halt
        mw = min(cfg.mem_words, st.mem_val.shape[-1])

        # traced mesh: coordinates, neighbors and the active-PE mask from
        # the per-lane (width, height).
        w = geom[:, 0:1]
        gh = geom[:, 1:2]
        xs = torch.remainder(pe[None, :], w)                 # (B,N)
        ys = _fdiv(pe[None, :], w)
        active = pe[None, :] < w * gh
        nbr = torch.stack([
            torch.where(active & (ys > 0), pe - w, -1),
            torch.where(active & (xs < w - 1), pe + 1, -1),
            torch.where(active & (ys < gh - 1), pe + w, -1),
            torch.where(active & (xs > 0), pe - 1, -1),
        ], dim=2)                                            # (B,N,4)

        opp_on = (mode & MODE_OPPORTUNISTIC) != 0            # (B,)
        dual_on = (mode & MODE_DUAL_ISSUE) != 0
        val_on = (mode & MODE_VALIANT) != 0

        def maybe_anchor(msgs):
            # TIA anchoring applies exactly when the lane is NOT
            # opportunistic.
            return torch.where(opp_on[:, None, None], msgs,
                               _anchor_tia(msgs, pe))

        heads = st.buf[:, :, :, 0, :]                        # (B,N,5,F)
        head_v = st.buf_n > 0                                # (B,N,5)

        # --- downstream credit (ON/OFF flow control, T_OFF=1) -------------
        nbr_c = nbr.clamp(min=0).long()
        flat_idx = (nbr_c * PORTS + c["opp"]).reshape(bsz, n * 4)
        down_n = torch.gather(st.buf_n.reshape(bsz, n * PORTS), 1,
                              flat_idx).reshape(bsz, n, 4)
        down_n = torch.where(nbr >= 0, down_n, DEPTH)
        credit_ok = (nbr >= 0) & (DEPTH - down_n >= 2)

        # --- route computation --------------------------------------------
        via = heads[..., F_VIA]
        dest_eff = torch.where(via >= 0, via, heads[..., F_DST0])
        out_port = route(dest_eff, credit_ok, w, xs, ys)     # (B,N,5)
        at_dest = dest_eff == pe[None, :, None]
        clear_via = head_v & (via >= 0) & at_dest & act[:, :, None]
        real_dest = heads[..., F_DST0] == pe[None, :, None]

        # --- execution selection (dual-issue, Fig. 8b) ----------------------
        pend_free = PEND_CAP - st.pend_n                     # (B,N)
        slot_v = dep < st.buf_n[..., None]                   # (B,N,5,D)
        all_m = st.buf
        opn_a = all_m[..., F_OP]
        local_a = slot_v & (all_m[..., F_DST0] == pe[None, :, None, None]) \
            & (all_m[..., F_VIA] < 0) & active[:, :, None, None] \
            & act[:, :, None, None]
        swq_ok = (st.swq_n < cfg.stream_wait_cap - 1)[:, :, None, None]
        stream_a = opn_a == OP_STREAM
        no_emit_a = (opn_a == OP_STORE_ADD) | (opn_a == OP_STORE_SET) | \
            (stream_a & swq_ok)
        mem_cand = local_a & is_mem_op(opn_a) & \
            ((pend_free >= 1)[:, :, None, None] | no_emit_a) & \
            (~stream_a | swq_ok)
        alu_cand = local_a & is_alu_op(opn_a) & \
            (pend_free >= 2)[:, :, None, None]

        k = PORTS * DEPTH
        shape3 = (bsz, n, PORTS, DEPTH)
        # separate decode + compute units (Fig. 8b) ...
        dual_mem = _pick_one(mem_cand.reshape(bsz, n, k), st.rr)
        dual_alu = _pick_one(alu_cand.reshape(bsz, n, k), st.rr + 2)
        # ... or TIA triggered dispatch: ONE ready instruction per PE.
        sel_one = _pick_one((mem_cand | alu_cand).reshape(bsz, n, k), st.rr)
        dual = dual_on[:, None, None]
        sel_mem3 = torch.where(
            dual, dual_mem, sel_one & is_mem_op(opn_a).reshape(bsz, n, k)
        ).reshape(shape3)
        sel_alu3 = torch.where(
            dual, dual_alu, sel_one & is_alu_op(opn_a).reshape(bsz, n, k)
        ).reshape(shape3)
        any_alu_local = sel_alu3.any(3).any(2)
        opn = heads[..., F_OP]

        # in-network computing: an idle compute unit intercepts a passing
        # ALU-class message whose operands are complete (head only).
        head_next_op = _prog_rows(prog, heads[..., F_PC])[..., C_OP]
        icand = (head_v & ~real_dest & (via < 0) & is_alu_op(opn)
                 & (heads[..., F_OP1C] == 1) & (heads[..., F_OP2C] == 1)
                 & (head_next_op != OP_NOP))
        icand = icand & (~any_alu_local)[:, :, None] & active[:, :, None] \
            & act[:, :, None]
        sel_icept = _pick_one(icand, st.rr + 1) & opp_on[:, None, None]
        icept3 = sel_icept[..., None] & (dep == 0)
        sel_alu3 = sel_alu3 | icept3
        sel_exec3 = (sel_mem3 | sel_alu3) & ~icept3
        flat = all_m.reshape(bsz, n, k, MSG_F)
        msg = _onehot_take(flat, sel_mem3.reshape(bsz, n, k))
        msg_alu = _onehot_take(flat, sel_alu3.reshape(bsz, n, k))
        was_icept = sel_icept.any(2)                         # (B,N)
        head_taken = (sel_mem3 | sel_alu3)[..., 0]
        mv = sel_mem3.any(3).any(2)                          # decode fires
        mv_alu = sel_alu3.any(3).any(2)                      # compute fires

        # ============== EXECUTE: DECODE UNIT (memory-class) ================
        op = torch.where(mv, msg[..., F_OP], OP_NOP)
        cfg_row = _prog_rows(prog, msg[..., F_PC])           # (B,N,CFG_F)
        addr_res = msg[..., F_RES].clamp(0, mw - 1)
        addr_op1 = msg[..., F_OP1].clamp(0, mw - 1)
        addr_op2 = msg[..., F_OP2].clamp(0, mw - 1)
        mem_r1 = _take_row(st.mem_val, addr_op1)
        mem_r2 = _take_row(st.mem_val, addr_op2)
        mem_rr = _take_row(st.mem_val, addr_res)
        meta_r = _take_row(st.mem_meta, addr_res)            # (B,N,2)

        # -- memory writes (stores execute at the owner PE: <=1 per PE);
        # applied below, after the stream issue reads the old memory.
        msg_op1 = msg[..., F_OP1]
        do_add = mv & (op == OP_STORE_ADD)
        do_set = mv & (op == OP_STORE_SET)
        improved = msg_op1 < mem_rr
        do_min = mv & (op == OP_STORE_MIN) & improved
        was_unset = mem_rr == int(UNSET)
        do_chk = mv & (op == OP_CHECKSET) & was_unset
        new_word = torch.where(
            do_add, mem_rr + msg_op1,
            torch.where(do_set | do_min | do_chk, msg_op1, mem_rr))
        write_mask = do_add | do_set | do_min | do_chk

        # -- outgoing dynamic AM construction --------------------------------
        nxt = msg.clone()
        nxt[..., F_OP] = cfg_row[..., C_OP]
        nxt[..., F_PC] = cfg_row[..., C_NEXT_PC]
        is_l1, is_l2 = op == OP_LOAD1, op == OP_LOAD2
        nxt[..., F_OP1] = torch.where(is_l1, mem_r1, nxt[..., F_OP1])
        nxt[..., F_OP1C] = torch.where(is_l1, 1, nxt[..., F_OP1C])
        nxt[..., F_OP2] = torch.where(is_l2, mem_r2, nxt[..., F_OP2])
        nxt[..., F_OP2C] = torch.where(is_l2, 1, nxt[..., F_OP2C])
        rot = cfg_row[..., C_ROTATE] == 1
        nxt = torch.where(rot[..., None], _rotate_dsts(nxt), nxt)
        nxt[..., F_VIA] = -1  # execution starts a fresh leg
        nxt = maybe_anchor(nxt)
        # conditional continuations read the stored word's metadata
        cont = do_min | do_chk
        nxt[..., F_OP1] = torch.where(
            do_chk, msg_op1 + 1, torch.where(do_min, msg_op1, nxt[..., F_OP1]))
        nxt[..., F_OP2] = torch.where(cont, meta_r[..., 0], nxt[..., F_OP2])
        nxt[..., F_OP2C] = torch.where(cont, 0, nxt[..., F_OP2C])
        nxt[..., F_DST0] = torch.where(cont, meta_r[..., 1], nxt[..., F_DST0])
        nxt[..., F_DST1] = torch.where(cont, -1, nxt[..., F_DST1])
        nxt[..., F_DST2] = torch.where(cont, -1, nxt[..., F_DST2])

        terminal = (op == OP_STORE_ADD) | (op == OP_STORE_SET)
        cond_no = ((op == OP_STORE_MIN) & ~improved) | \
                  ((op == OP_CHECKSET) & ~was_unset)
        starts_stream = mv & (op == OP_STREAM)
        emits = mv & ~terminal & ~cond_no & ~starts_stream & \
            (cfg_row[..., C_OP] != OP_NOP)
        nxt[..., F_VALID] = _i32(emits)

        # ============== EXECUTE: COMPUTE UNIT (ALU-class) ==================
        op_a = torch.where(mv_alu, msg_alu[..., F_OP], OP_NOP)
        cfg_row_a = _prog_rows(prog, msg_alu[..., F_PC])
        alu_res = _alu(op_a, msg_alu[..., F_OP1], msg_alu[..., F_OP2],
                       msg_alu[..., F_RES])
        nxt_a = msg_alu.clone()
        nxt_a[..., F_OP] = cfg_row_a[..., C_OP]
        nxt_a[..., F_PC] = cfg_row_a[..., C_NEXT_PC]
        nxt_a[..., F_OP1] = torch.where(mv_alu, alu_res, nxt_a[..., F_OP1])
        nxt_a[..., F_OP1C] = torch.where(mv_alu, 1, nxt_a[..., F_OP1C])
        # an anchored message (F_VIA == -2, TIA mode) has executed its local
        # ALU op: resume the pushed-down destination list by rotating.
        anchored_exec = mv_alu & (msg_alu[..., F_VIA] == -2)
        rot_a = (cfg_row_a[..., C_ROTATE] == 1) | anchored_exec
        nxt_a = torch.where(rot_a[..., None], _rotate_dsts(nxt_a), nxt_a)
        nxt_a[..., F_VIA] = -1
        nxt_a = maybe_anchor(nxt_a)
        emits_a = mv_alu & (cfg_row_a[..., C_OP] != OP_NOP)
        nxt_a[..., F_VALID] = _i32(emits_a)

        # -- STREAM accept: push the stream task into the wait queue ---------
        swq = st.swq
        swq_cap = cfg.stream_wait_cap
        wpos = torch.remainder(st.swq_h + st.swq_n, swq_cap)
        _put_row(swq, wpos, msg, starts_stream)
        swq_n = st.swq_n + _i32(starts_stream)

        # -- STREAM issue: an idle decode unit pops the next waiting task.
        issue = (~st.stream_on) & (swq_n > 0) & act
        task = _take_row(swq, st.swq_h)
        t_res = task[..., F_RES].clamp(0, mw - 1)
        t_op2 = task[..., F_OP2].clamp(0, mw - 1)
        desc_a = torch.where(task[..., F_OP2C] == 1, t_res, t_op2)
        meta_d = _take_row(st.mem_meta, desc_a)
        s_base = _take_row(st.mem_val, desc_a)   # memory before the write
        s_cnt = meta_d[..., 0]
        stream_on = st.stream_on | (issue & (s_cnt > 0))
        stream_msg = torch.where(issue[..., None], task, st.stream_msg)
        stream_base = torch.where(issue, s_base, st.stream_base)
        stream_left = torch.where(issue, s_cnt, st.stream_left)
        swq_h = torch.remainder(st.swq_h + _i32(issue), swq_cap)
        swq_n = swq_n - _i32(issue)

        # the decode unit's memory write, in place
        mem_val = st.mem_val
        _put_row(mem_val, addr_res, new_word, write_mask)

        # -- push executed-output AMs into the pending FIFO ------------------
        pend = st.pend
        pend_h = st.pend_h
        pos = torch.remainder(pend_h + st.pend_n, PEND_CAP)
        _put_row(pend, pos, nxt, emits)
        pend_n = st.pend_n + _i32(emits)
        emits_a_pend = emits_a & ~was_icept      # intercepted: in-place
        pos_a = torch.remainder(pend_h + pend_n, PEND_CAP)
        _put_row(pend, pos_a, nxt_a, emits_a_pend)
        pend_n = pend_n + _i32(emits_a_pend)

        # -- streaming decode: emit one spawned AM per cycle -----------------
        can_emit = stream_on & (pend_n < STREAM_THROTTLE) & act
        e_addr = stream_base.clamp(0, mw - 1)
        e_val = _take_row(mem_val, e_addr)
        e_meta = _take_row(st.mem_meta, e_addr)
        e_m0 = e_meta[..., 0]
        t = stream_msg
        t_cfg = _prog_rows(prog, t[..., F_PC])
        sel1, sel2 = t_cfg[..., C_OP1SEL], t_cfg[..., C_OP2SEL]
        sp = t.clone()
        sp[..., F_VALID] = 1
        sp[..., F_OP] = t_cfg[..., C_OP]
        sp[..., F_PC] = t_cfg[..., C_NEXT_PC]
        o1 = _select([sel1 == 1, sel1 == 2],
                     [e_val, t[..., F_OP1] + e_val], t[..., F_OP1])
        o2 = _select([sel2 == 1, sel2 == 2, sel2 == 3],
                     [e_val, e_m0 + t[..., F_OP2], e_m0 + t[..., F_OP1]],
                     t[..., F_OP2])
        rsel = t_cfg[..., C_RESSEL]
        rs = _select([rsel == 1, rsel == 2],
                     [t[..., F_RES] + e_m0, e_m0], t[..., F_RES])
        sp[..., F_OP1] = o1
        sp[..., F_OP1C] = 1
        sp[..., F_OP2] = o2
        sp[..., F_OP2C] = torch.where(sel2 > 0, _i32(sel2 == 1),
                                      t[..., F_OP2C])
        sp[..., F_RES] = rs
        use_meta_dst = t_cfg[..., C_DSTSEL] == 1
        rot_t = _rotate_dsts(t)
        sp[..., F_DST0] = torch.where(use_meta_dst, e_meta[..., 1],
                                      rot_t[..., F_DST0])
        sp[..., F_DST1] = torch.where(use_meta_dst, t[..., F_DST1],
                                      rot_t[..., F_DST1])
        sp[..., F_DST2] = torch.where(use_meta_dst, t[..., F_DST2],
                                      rot_t[..., F_DST2])
        sp[..., F_VIA] = -1
        sp = maybe_anchor(sp)
        pos2 = torch.remainder(pend_h + pend_n, PEND_CAP)
        _put_row(pend, pos2, sp, can_emit)
        pend_n = pend_n + _i32(can_emit)
        stream_base = stream_base + _i32(can_emit)
        stream_left = stream_left - _i32(can_emit)
        stream_on = stream_on & (stream_left > 0)

        # ==================== ALLOCATE & TRANSFER ==========================
        req = head_v & ~head_taken & (out_port < 4) & act[:, :, None]
        stall_local = head_v & (out_port == OUT_LOCAL) & ~head_taken & \
            act[:, :, None]
        grants = torch.zeros((bsz, n, PORTS), dtype=torch.bool, device=dev)
        sel_out = []
        for o in range(4):  # separable output-side arbitration
            cand_o = req & (out_port == o) & credit_ok[:, :, o][:, :, None]
            g = _pick_one(cand_o, st.rr + o)
            sel_out.append(g)
            grants = grants | g
        stall_net = req & ~grants

        # removals: granted heads + the executed slot; stable compaction of
        # each (pe, port) FIFO.
        removed = sel_exec3 | (grants[..., None] & (dep == 0))
        keep = slot_v & ~removed                             # (B,N,5,D)
        order = torch.argsort(torch.where(keep, dep, DEPTH + 1), dim=3,
                              stable=True)
        buf = torch.gather(st.buf, 3,
                           order[..., None].expand(*order.shape, MSG_F))
        n_keep = _i32(keep.sum(3))
        buf = torch.where((dep < n_keep[..., None])[..., None], buf, 0)
        buf_n = n_keep
        # clear reached Valiant waypoints in place on remaining heads.
        popped0 = removed[..., 0]
        buf[:, :, :, 0, F_VIA] = torch.where(clear_via & ~popped0, -1,
                                             buf[:, :, :, 0, F_VIA])
        # in-place interception write-back: the transformed message
        # replaces the (un-removed, un-granted) head.
        icept_port = torch.argmax(_i32(sel_icept), dim=2)    # (B,N)
        cur_head = buf[bi, pi, icept_port, 0]
        buf[bi, pi, icept_port, 0] = torch.where(was_icept[..., None], nxt_a,
                                                 cur_head)

        # transfers: sender-side view — the message leaving each PE through
        # each directional output port (<= 1 grant per output).
        send_v = torch.stack([g.any(2) for g in sel_out], dim=2)   # (B,N,4)
        send_m = torch.stack([_onehot_take(heads, g) for g in sel_out],
                             dim=2)                          # (B,N,4,F)
        # receiver-side gather: input port q of PE r is fed by neighbor
        # nbr[r, q] transmitting through its output opp[q].
        for q in range(4):
            s = nbr_c[:, :, q]
            o = opp_list[q]
            has = (nbr[:, :, q] >= 0) & send_v[bi, s, o]
            m_in = send_m[bi, s, o].clone()
            m_in[..., F_HOPS] += 1
            pos_d = buf_n[:, :, q].clamp(0, DEPTH - 1).long()
            cur = buf[bi, pi, q, pos_d]
            buf[bi, pi, q, pos_d] = torch.where(has[..., None], m_in, cur)
            buf_n[:, :, q] += _i32(has)

        # ==================== INJECTION (AM NIC, §3.3.1) ====================
        inj_space = (buf_n[:, :, P_INJ] < DEPTH) & active & act
        have_dyn = pend_n > 0
        have_stat = st.amq_head < st.amq_len
        inj_dyn = inj_space & have_dyn
        inj_stat = inj_space & ~have_dyn & have_stat
        dyn_msg = _take_row(pend, pend_h)
        stat_msg = _take_row(st.amq,
                             st.amq_head.clamp(0, st.amq.shape[2] - 1))
        inj_msg = torch.where(inj_dyn[..., None], dyn_msg, stat_msg)

        # TIA-Valiant: ROMM-style randomized minimal-path routing.  The
        # reference's uint32 hash (wraparound multiply, unsigned %, logical
        # >> 8) is computed in int64 masked to 32 bits.
        h = ((sub_local.long() & _U32) * 2654435761
             + (st.cycle.long() & _U32) * 40503) & _U32
        dstp = inj_msg[..., F_DST0].clamp(min=0)
        dx = torch.remainder(dstp, w) - xs
        dy = _fdiv(dstp, w) - ys
        rx = _i32(torch.remainder(h, dx.abs().long() + 1))
        ry = _i32(torch.remainder(h >> 8, dy.abs().long() + 1))
        # west-first legality across the two legs: westbound traffic pins
        # via_x = dst_x and randomizes only y.
        rx = torch.where(dx < 0, dx.abs(), rx)
        via_pe = (ys + torch.sign(dy) * ry) * w + (xs + torch.sign(dx) * rx)
        eligible = (inj_msg[..., F_VIA] == -1) & \
            (inj_msg[..., F_DST0] != pe) & (via_pe != pe) & \
            (via_pe != inj_msg[..., F_DST0])
        inj_val = inj_msg.clone()
        inj_val[..., F_VIA] = torch.where(eligible, via_pe,
                                          inj_msg[..., F_VIA])
        inj_msg = torch.where(val_on[:, None, None], inj_val, inj_msg)
        do_inj = inj_dyn | inj_stat
        posi = buf_n[:, :, P_INJ].clamp(0, DEPTH - 1).long()
        cur = buf[bi, pi, P_INJ, posi]
        buf[bi, pi, P_INJ, posi] = torch.where(do_inj[..., None], inj_msg,
                                               cur)
        buf_n[:, :, P_INJ] += _i32(do_inj)
        # consume sources
        pend_h = torch.remainder(pend_h + _i32(inj_dyn), PEND_CAP)
        pend_n = pend_n - _i32(inj_dyn)
        amq_head = st.amq_head + _i32(inj_stat)

        # ==================== STATS =========================================
        busy = mv | mv_alu | can_emit
        tick = _i32(act)
        return MachineState(
            buf=buf, buf_n=buf_n, amq=st.amq, amq_head=amq_head,
            amq_len=st.amq_len, pend=pend, pend_h=pend_h, pend_n=pend_n,
            mem_val=mem_val, mem_meta=st.mem_meta, stream_on=stream_on,
            stream_msg=stream_msg, stream_base=stream_base,
            stream_left=stream_left, swq=swq, swq_h=swq_h, swq_n=swq_n,
            rr=torch.remainder(st.rr + tick, PORTS),
            cycle=st.cycle + tick,
            st_busy=st.st_busy + _i32(busy),
            st_exec=st.st_exec + _i32(mv) + _i32(mv_alu),
            st_enroute=st.st_enroute + _i32(was_icept),
            st_stall=st.st_stall + _i32(stall_net | stall_local),
            st_hops=st.st_hops + _i32(grants.sum(2)),
            st_inj=st.st_inj + _i32(do_inj))

    return cycle


def lane_work(st: MachineState) -> torch.Tensor:
    """(B, N) outstanding-work count per PE: buffered flits + pending
    outputs + queued/active streams + un-injected static AMs."""
    return _i32(st.buf_n.sum(2) + st.pend_n + st.swq_n
                + _i32(st.stream_on) + _i32(st.amq_head < st.amq_len))


def group_idle(st: MachineState, sub_ids: torch.Tensor) -> torch.Tensor:
    """(B, N) bool: True where the PE's own sub-lane has no work anywhere.

    ``sub_ids`` (B, N) assigns each PE a sub-lane slot (all-zero for
    unpacked lanes, where this is the global idle test broadcast).  The
    per-slot sum is an integer ``scatter_add``, so its order is immaterial.
    """
    idx = sub_ids.long()
    gw = torch.zeros(idx.shape, dtype=torch.int32, device=idx.device)
    gw.scatter_add_(1, idx, lane_work(st))
    return torch.gather(gw == 0, 1, idx)


@dataclasses.dataclass
class RunResult:
    cycles: int
    mem_val: np.ndarray
    utilization: float          # instructions issued / (cycles × N)
    busy_frac: float            # fraction of PE-cycles with ≥1 unit active
    per_pe_busy: np.ndarray     # (N,) busy-cycle counts (load-balance map)
    executed: int
    enroute: int                # opportunistically executed (Fig. 11 r-axis)
    enroute_frac: float
    hops: int
    injected: int
    stall_per_port: np.ndarray  # (N,5) congestion proxy (Fig. 14)
    completed: bool

    def to_json(self) -> dict:
        """JSON-serializable metrics row, in the reference's format
        (``mem_val`` omitted, ``stall_per_port`` reduced to per-port
        totals)."""
        stall = np.asarray(self.stall_per_port)
        return dict(
            cycles=int(self.cycles),
            utilization=float(self.utilization),
            busy_frac=float(self.busy_frac),
            executed=int(self.executed),
            enroute=int(self.enroute),
            enroute_frac=float(self.enroute_frac),
            hops=int(self.hops),
            injected=int(self.injected),
            stall_total=int(stall.sum()),
            stall_per_port=[int(v) for v in stall.sum(axis=0)],
            per_pe_busy=[int(v) for v in np.asarray(self.per_pe_busy)],
            completed=bool(self.completed),
        )


# "run to completion" per-PE cycle budget (max_cycles always caps first).
ENGINE_UNBOUNDED = np.int32(np.iinfo(np.int32).max)


def unbounded_budget(batch: int, n_pes: int) -> np.ndarray:
    """A ``(B, N)`` engine budget that never halts anything: every PE may
    retire up to INT32_MAX cycles this call (``cfg.max_cycles`` always
    caps first).  The budget is per PE so that a caller can bound one
    (sub-)lane — a deadline — while its co-tenants keep stepping."""
    return np.full((batch, n_pes), ENGINE_UNBOUNDED, np.int32)


def _step(cyc, cfg, prog, modes, geoms, sub_ids, local_ids, c0, budget, st,
          ffwd=None):
    """One engine tick: step every lane, then freeze the cycle counters,
    round-robin pointers and statistics of PEs whose sub-lane is idle,
    capped or out of budget (the transition itself is a no-op there).
    With ``ffwd`` (a :func:`repro_torch.core.fastforward.make_fast_forward`
    function) the tick then advances every sub-lane in lone flight by its
    message's remaining hops, bounded by the budget left."""
    spent = st.cycle - c0
    halt = spent >= budget
    alive = (~group_idle(st, sub_ids)) & (st.cycle < cfg.max_cycles) & ~halt
    st2 = cyc(prog, modes, geoms, st, local_ids, halt=halt)

    def keep(new, old):
        return torch.where(alive, new, old)

    st2 = st2._replace(
        rr=keep(st2.rr, st.rr),
        cycle=keep(st2.cycle, st.cycle),
        st_busy=keep(st2.st_busy, st.st_busy),
        st_exec=keep(st2.st_exec, st.st_exec),
        st_enroute=keep(st2.st_enroute, st.st_enroute),
        st_stall=torch.where(alive[..., None], st2.st_stall, st.st_stall),
        st_hops=keep(st2.st_hops, st.st_hops),
        st_inj=keep(st2.st_inj, st.st_inj),
    )
    if ffwd is not None:
        st2 = ffwd(prog, modes, geoms, sub_ids, budget - spent, st, st2)
    return st2


def run_engine(cfg: MachineConfig, prog, modes, geoms, sub_ids, local_ids,
               st: MachineState, budget, *, chunk: int = 512):
    """Step the batch until every lane is idle, capped or out of budget, or
    a lane trips the pending-FIFO guard.

    The loop runs ``chunk`` ticks between checks, and the check is the one
    host synchronisation per chunk.  ``budget`` is a (B, N) bound on the
    simulated cycles each PE may retire in this call, so running budget b
    then b' gives the bits of one call with b + b'.  Returns ``(st, over,
    idle, ticks)`` as the reference engine does: the final state, the (B,)
    overflow flag, the (B, N) per-PE group-idle mask and the wall ticks
    stepped (chunks run x ``chunk``).

    With ``cfg.fast_forward`` the chunk has two speeds, as in the
    reference: a chunk runs the compressed tick only when, at its start,
    some live sub-lane is in lone flight.  The probe rides on the check's
    one host synchronisation, and both speeds give the same bits, so it
    only steers the ticks a run steps.
    """
    _require_traced(cfg)
    n_max = st.cycle.shape[1]
    cyc = _make_cycle(cfg, n_max)
    if cfg.fast_forward:
        from repro_torch.core.fastforward import (make_fast_forward,
                                                  make_lone_probe)
        ffwd = make_fast_forward(cfg, n_max)
        lone_probe = make_lone_probe()
    cycle0 = st.cycle.clone()
    over = torch.zeros((st.cycle.shape[0],), dtype=torch.bool,
                       device=st.cycle.device)
    chunks = 0
    while True:
        # a lane is live while any of its PEs still advances: its
        # sub-lane has work left, its cycle counter is below the cap and
        # it has budget left this call.
        room = (st.cycle < cfg.max_cycles) & (st.cycle - cycle0 < budget)
        go = ((~group_idle(st, sub_ids)) & room).any() & ~over.any()
        if cfg.fast_forward:
            lone = (lone_probe(sub_ids, st) & room).any()
            go, lone = torch.stack([go, lone]).tolist()
        else:
            go, lone = bool(go), False
        if not go:
            break
        use = ffwd if lone else None
        for _ in range(chunk):
            st = _step(cyc, cfg, prog, modes, geoms, sub_ids, local_ids,
                       cycle0, budget, st, use)
        # pending-FIFO high-water check at chunk granularity; PEs frozen at
        # max_cycles are exempt.
        high = (st.pend_n >= PEND_CAP - 2) & (st.cycle < cfg.max_cycles)
        over = over | high.any(1)
        chunks += 1
    return st, over, group_idle(st, sub_ids), chunks * chunk


def _pe_slice_result(st_host: dict, done: bool, b: int,
                     ids: np.ndarray) -> RunResult:
    """Metrics of the PE set ``ids`` of batch lane ``b`` (host arrays)."""
    n = ids.shape[0]
    cycles = int(st_host["cycle"][b][ids].max())
    per_pe_busy = st_host["st_busy"][b][ids]
    executed = int(st_host["st_exec"][b][ids].sum())
    enroute = int(st_host["st_enroute"][b][ids].sum())
    return RunResult(
        cycles=cycles,
        mem_val=st_host["mem_val"][b][ids],
        utilization=executed / max(1, cycles * n),
        busy_frac=float(per_pe_busy.sum()) / max(1, cycles * n),
        per_pe_busy=per_pe_busy,
        executed=executed,
        enroute=enroute,
        enroute_frac=enroute / max(1, executed),
        hops=int(st_host["st_hops"][b][ids].sum()),
        injected=int(st_host["st_inj"][b][ids].sum()),
        stall_per_port=st_host["st_stall"][b][ids],
        completed=done,
    )


def _host_stats(st: MachineState) -> dict:
    """Pull the result-bearing state leaves to host numpy once."""
    names = ("cycle", "st_busy", "st_exec", "st_enroute", "st_hops",
             "st_inj", "st_stall", "mem_val")
    return {k: getattr(st, k).cpu().numpy() for k in names}


def _validate_deadlines(deadlines, n: int) -> list:
    """Normalize a per-lane deadline sequence: length n, entries None or
    a positive cycle count (int32 range)."""
    dls = list(deadlines)
    if len(dls) != n:
        raise ValueError(f"{len(dls)} deadlines for {n} lanes")
    out = []
    for i, d in enumerate(dls):
        if d is None:
            out.append(None)
            continue
        d = int(d)
        if not 0 < d <= int(ENGINE_UNBOUNDED):
            raise ValueError(f"deadline[{i}]={d}: expected a positive "
                             "int32 cycle count (or None)")
        out.append(d)
    return out


def _run_many_impl(cfg: MachineConfig, workloads, *, modes=None, geoms=None,
                   chunk: int = 512, pack: bool = False,
                   super_geom=None, pack_stats: dict | None = None,
                   shard: bool = False, cycle_hints=None,
                   shard_stats: dict | None = None,
                   telemetry: dict | None = None,
                   deadlines=None, device="cuda") -> list[RunResult]:
    """Simulate B workloads in one batched run on ``device``.

    The plumbing behind :func:`run_many` and
    :func:`repro_torch.core.sweep.sweep`, as in the reference.

    Args:
      cfg: shared machine parameters.  ``mem_words`` is widened
        automatically when a lane's padded memory image is larger.
      workloads: a :class:`repro_torch.core.batch.BatchedWorkloads`, or a
        sequence of compiled workloads (anything with ``prog`` /
        ``static_ams`` / ``amq_len`` / ``mem_val`` / ``mem_meta``) to stack
        and pad.
      modes: optional per-lane fabric modes (:data:`FABRIC_MODES` names
        and/or bitmasks).  Defaults to the batch's own ``modes``, else the
        mode ``cfg``'s flags describe.
      geoms: optional per-lane ``(width, height)`` pairs.  Defaults to the
        batch's own ``geoms``, else ``cfg``'s mesh.
      chunk: ticks between the engine's idle checks.
      pack: co-schedule small lanes as disjoint sub-meshes of shared
        super-lanes (:func:`repro_torch.core.batch.pack_schedule`), in a
        few sequential waves on the same engine.  Needs compiled
        workloads (each records its mesh); results come back one per
        input workload, in input order, bit-identical to solo runs.
        Every packed batch is certified rectangle-confined
        (:func:`repro_torch.analysis.checks.check_packed_batch`) before
        any cycle runs.
      super_geom: optional ``(width, height)`` of the packing mesh
        (default: the batch's widest x tallest lane).
      pack_stats: optional dict that ``pack=True`` fills with the
        schedule's ``n_waves`` / ``n_super_lanes`` /
        ``packing_efficiency`` / ``unpacked_efficiency`` / ``plan``.
      shard: lane-axis sharding over several cards; not ported yet
        (raises :class:`NotImplementedError`).
      cycle_hints: optional per-input-lane cycle counts replacing the
        static cost model in the wave planner (``pack=True``).
      shard_stats: optional dict filled with the one-card plan
        (``n_devices`` 1, no pad lanes).
      telemetry: optional dict accumulating, over every engine call of the
        run (one per wave), ``stepped_pe_ticks`` (PE-steps the engine
        stepped), ``plain_pe_ticks`` (what the plain engine steps for the
        same final cycle counts, rounded up to the chunk) and
        ``engine_calls``.
      deadlines: optional per-input-lane cycle deadlines (None entries =
        unbounded).  A lane makes no state transition past its deadline
        and comes back frozen there with ``completed=False``; co-tenant
        sub-lanes and other lanes are unaffected (the budget is per PE).
      device: where the state lives and the engine runs.

    Returns:
      One :class:`RunResult` per lane, in input order, bit-identical to the
      reference's.  A lane that hits ``cfg.max_cycles`` without reaching
      idle returns ``completed=False``.

    Raises:
      RuntimeError: if any lane trips the pending-FIFO overflow guard; its
        ``lanes`` attribute names the lanes (input lanes under ``pack``).
    """
    from repro_torch.core.batch import (BatchedWorkloads, pack_schedule,
                                        stack_workloads, validate_hints)
    if shard:
        raise NotImplementedError("run_many(shard=True) is not ported yet "
                                  "(ROADMAP.md, Queue 1 item 6)")
    if pack:
        if isinstance(workloads, BatchedWorkloads):
            raise ValueError(
                "pack=True needs the raw sequence of compiled workloads; "
                "this batch is already stacked (packing re-bases lanes "
                "into super-meshes, which stacking discards)")
        if not (cfg.traced_geometry and cfg.traced_modes):
            raise ValueError("pack=True requires the traced engine axes "
                             "(cfg.traced_geometry and cfg.traced_modes)")
        if geoms is not None:
            raise ValueError("pack=True places lanes itself; per-lane "
                             "geoms cannot be overridden")
        wls = list(workloads)
        if deadlines is not None:
            deadlines = _validate_deadlines(deadlines, len(wls))
        if cycle_hints is not None:
            cycle_hints = validate_hints(cycle_hints, len(wls))
        else:
            # no measured hints: the static cost model supplies the
            # planner's load signal (hints steer scheduling only).
            from repro_torch.core.batch import static_cycle_hints
            cycle_hints = static_cycle_hints(wls)
        batches, waves, stats = pack_schedule(wls, modes=modes,
                                              super_geom=super_geom,
                                              cycle_hints=cycle_hints)
        # certify rectangle confinement before any cycle runs: no rebased
        # AM or meta_pe word may target a PE outside its own sub-lane.
        from repro_torch.analysis.checks import (check_packed_batch,
                                                 raise_on_findings)
        for wb in batches:
            raise_on_findings(
                check_packed_batch(wb),
                context="packed batch failed rectangle-confinement "
                        "certification")
        if pack_stats is not None:
            pack_stats.update(stats)
        results: list = [None] * len(wls)
        wave_shard_stats: list[dict] = []
        for wb, wave in zip(batches, waves):
            hints_w = None
            if cycle_hints is not None:
                # a super-lane runs for its slowest co-tenant
                hints_w = [0.0] * wb.batch
                for p in wb.plan.placements:
                    hints_w[p.super_lane] = max(
                        hints_w[p.super_lane],
                        float(cycle_hints[wave[p.lane]]))
            # per-wave deadlines, in the wave's own lane order; the inner
            # (packed) call maps them onto sub-lane PE rows
            dls_w = (None if deadlines is None
                     else [deadlines[i] for i in wave])
            ws: dict | None = {} if shard_stats is not None else None
            try:
                wave_res = _run_many_impl(cfg, wb, chunk=chunk,
                                          cycle_hints=hints_w,
                                          shard_stats=ws,
                                          telemetry=telemetry,
                                          deadlines=dls_w, device=device)
            except RuntimeError as e:
                supers = getattr(e, "lanes", None)
                if supers is None:
                    raise
                # translate the failing super-lanes into input workloads
                culprits = sorted(
                    wave[p.lane] for p in wb.plan.placements
                    if p.super_lane in supers)
                err = RuntimeError(
                    "pending-FIFO overflow: consumption guarantee "
                    "violated (simulator invariant; packed input lanes "
                    f"{culprits})")
                err.lanes = culprits
                raise err from e
            if ws is not None:
                wave_shard_stats.append(ws)
            for i, r in zip(wave, wave_res):
                results[i] = r
        if shard_stats is not None:
            # aggregated over waves, as in the reference
            shard_stats.update(
                n_devices=max(w["n_devices"] for w in wave_shard_stats),
                lanes_per_device=max(w["lanes_per_device"]
                                     for w in wave_shard_stats),
                n_pad_lanes=sum(w["n_pad_lanes"]
                                for w in wave_shard_stats),
                plan=[w["plan"] for w in wave_shard_stats])
        return results
    _require_traced(cfg)
    if not isinstance(workloads, BatchedWorkloads):
        workloads = stack_workloads(list(workloads), geoms=geoms)
        geoms = None        # now carried on the batch
    n_max = workloads.n_pes
    if geoms is None:
        geoms = workloads.geoms
    if geoms is None:
        if n_max != cfg.n_pes:
            raise ValueError(f"batch compiled for {n_max} PEs but cfg "
                             f"has {cfg.n_pes}")
        lane_geoms = np.tile(np.array([[cfg.width, cfg.height]], np.int32),
                             (workloads.batch, 1))
    else:
        lane_geoms = np.asarray(geoms, np.int32)
        if lane_geoms.shape != (workloads.batch, 2):
            raise ValueError(f"geoms shape {lane_geoms.shape} for "
                             f"{workloads.batch} lanes (want (B, 2))")
        if (lane_geoms[:, 0] * lane_geoms[:, 1] > n_max).any():
            raise ValueError("lane geometry exceeds the batch PE axis "
                             f"({n_max} PEs)")
    if workloads.mem_words > cfg.mem_words:
        cfg = dataclasses.replace(cfg, mem_words=workloads.mem_words)

    if modes is None:
        modes = workloads.modes
    if modes is None:
        lane_modes = np.full((workloads.batch,), mode_code(cfg), np.int32)
    else:
        lane_modes = np.asarray([resolve_mode(m) for m in modes], np.int32)
        if lane_modes.shape[0] != workloads.batch:
            raise ValueError(f"{lane_modes.shape[0]} modes for "
                             f"{workloads.batch} lanes")

    if workloads.sub_ids is not None:
        sub_ids = np.asarray(workloads.sub_ids, np.int32)
        local_ids = np.asarray(workloads.local_ids, np.int32)
    else:
        sub_ids = np.zeros((workloads.batch, n_max), np.int32)
        local_ids = np.tile(np.arange(n_max, dtype=np.int32),
                            (workloads.batch, 1))
    if cycle_hints is not None:
        validate_hints(cycle_hints, workloads.batch)

    # --- per-PE cycle budget (deadlines) ------------------------------
    # INT32_MAX everywhere by default, a lane's own deadline on its rows
    # otherwise; a packed batch maps each deadline onto its sub-lane
    # rectangle, so a frozen sub-lane never stalls its co-tenants.
    budget = unbounded_budget(workloads.batch, n_max)
    if deadlines is not None:
        if workloads.plan is not None:
            deadlines = _validate_deadlines(
                deadlines, len(workloads.plan.placements))
            for sub in workloads.plan.placements:
                dl = deadlines[sub.lane]
                if dl is not None:
                    w_sup = workloads.plan.super_geoms[sub.super_lane][0]
                    budget[sub.super_lane, sub.pe_ids(w_sup)] = dl
        else:
            deadlines = _validate_deadlines(deadlines, workloads.batch)
            for b, dl in enumerate(deadlines):
                if dl is not None:
                    budget[b, :] = dl
    if shard_stats is not None:
        shard_stats.update(n_devices=1, lanes_per_device=workloads.batch,
                           n_pad_lanes=0,
                           plan=[list(range(workloads.batch))])

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    st = init_state(cfg, workloads.static_ams, workloads.amq_len,
                    workloads.mem_val, workloads.mem_meta, device=device)
    st, over, idle, ticks = run_engine(
        cfg, t(workloads.prog), t(lane_modes), t(lane_geoms), t(sub_ids),
        t(local_ids), st, t(budget), chunk=chunk)
    host = _host_stats(st)
    if telemetry is not None:
        # PE-steps stepped vs what the plain tick-per-cycle engine steps
        # to reach the same final cycle counts (chunk granularity).
        bsz = workloads.batch
        want = int(host["cycle"].max())
        telemetry["stepped_pe_ticks"] = (
            telemetry.get("stepped_pe_ticks", 0) + ticks * bsz * n_max)
        telemetry["plain_pe_ticks"] = (
            telemetry.get("plain_pe_ticks", 0)
            + -(-want // chunk) * chunk * bsz * n_max)
        telemetry["engine_calls"] = telemetry.get("engine_calls", 0) + 1
    over = over.cpu().numpy()
    idle = idle.cpu().numpy()                    # (B, N) per-PE group idle
    if over.any():
        bad = np.nonzero(over)[0].tolist()
        err = RuntimeError("pending-FIFO overflow: consumption guarantee "
                           f"violated (simulator invariant; lanes {bad})")
        err.lanes = bad  # structured, so pack=True can name input lanes
        raise err
    if workloads.plan is not None:
        # un-pack: one result per original lane, from its sub-mesh
        # rectangle (plan order is input order by construction).
        out = []
        for sub in workloads.plan.placements:
            w_sup = workloads.plan.super_geoms[sub.super_lane][0]
            ids = sub.pe_ids(w_sup)
            out.append(_pe_slice_result(
                host, bool(idle[sub.super_lane, ids[0]]),
                sub.super_lane, ids))
        return out
    return [_pe_slice_result(
        host, bool(idle[b, 0]), b,
        np.arange(int(lane_geoms[b, 0] * lane_geoms[b, 1])))
            for b in range(workloads.batch)]


def run_many(cfg: MachineConfig, workloads, *, modes=None, geoms=None,
             chunk: int = 512, pack: bool = False,
             super_geom=None, pack_stats: dict | None = None,
             shard: bool = False, cycle_hints=None,
             shard_stats: dict | None = None,
             deadlines=None, device="cuda") -> list[RunResult]:
    """Simulate B workloads in one batched run on ``device``.

    See :func:`_run_many_impl` for the argument contract.  Prefer the
    structured surface, :class:`repro_torch.core.sweep.SweepRequest` in,
    :class:`repro_torch.core.sweep.SweepReport` out::

        from repro_torch.core.sweep import SweepRequest, sweep
        report = sweep(cfg, SweepRequest(workloads=wls, pack=True))

    The out-param dicts ``pack_stats=`` / ``shard_stats=`` are deprecated
    in favour of ``SweepReport.pack`` / ``SweepReport.shard``: passing
    either emits a :class:`DeprecationWarning` (both surfaces call the
    same implementation, so the results are the same bits).
    ``shard=True`` is not ported yet and raises
    :class:`NotImplementedError`.
    """
    if pack_stats is not None or shard_stats is not None:
        import warnings
        warnings.warn(
            "run_many(pack_stats=..., shard_stats=...) out-param dicts are "
            "deprecated; use repro_torch.core.sweep.sweep(cfg, "
            "SweepRequest(...)) and read SweepReport.pack / "
            "SweepReport.shard instead",
            DeprecationWarning, stacklevel=2)
    return _run_many_impl(cfg, workloads, modes=modes, geoms=geoms,
                          chunk=chunk, pack=pack, super_geom=super_geom,
                          pack_stats=pack_stats, shard=shard,
                          cycle_hints=cycle_hints, shard_stats=shard_stats,
                          deadlines=deadlines, device=device)


def run(cfg: MachineConfig, prog: np.ndarray, static_ams: np.ndarray,
        amq_len: np.ndarray, mem_val: np.ndarray, mem_meta: np.ndarray,
        *, chunk: int = 512, device="cuda") -> RunResult:
    """Execute until global idle (or ``cfg.max_cycles``): a B=1
    :func:`run_many`."""
    (res,) = run_many(cfg, [(prog, static_ams, amq_len, mem_val, mem_meta)],
                      chunk=chunk, device=device)
    return res
