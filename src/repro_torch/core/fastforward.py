"""Event-compressed stepping: idle-cycle fast-forward for the engine.

A port of the reference's ``repro.core.fastforward``, in torch ops over
the lane axis.  The engine is tick-based, yet on the paper's irregular
workloads many ticks are pure message transit: a single in-flight active
message crossing the mesh while every PE waits.  When a sub-lane's only
state is one buffered message in flight (nothing pending, queued,
streaming, or left to inject) and no PE along the remaining west-first
path can intercept it, every intermediate tick is determined in closed
form.  This module compresses them: it moves the message to its arrival
buffer and bumps ``cycle`` / ``rr`` / ``st_hops`` by the exact hop
distance in one masked step.

Bit-identity with the plain tick loop is by construction, as in the
reference:

* eligibility is a *conservative proof* — any sub-lane the analysis
  cannot prove quiet (more than one flit, a non-empty FIFO, a possible
  opportunistic interception en route, an out-of-mesh destination, or a
  compressed advance of < 2 cycles) steps plainly;
* the closed-form path reproduces the router's west-first +
  credit-adaptive staircase exactly under the lone-flight precondition
  (all credits available, so the adaptive tie-break degenerates to the
  deterministic ``|dx| >= |dy|`` rule);
* the advance is capped by the per-call cycle budget and ``max_cycles``.

Per-sub-lane sums are integer ``scatter_add`` over the PE axis (order
immaterial), broadcast back with ``gather``; every leaf stays int32.
"""
from __future__ import annotations

import torch

from repro_torch.core.am import (C_OP, F_DST0, F_HOPS, F_OP, F_OP1C, F_OP2C,
                                 F_PC, F_VIA, OP_NOP, is_alu_op)
from repro_torch.core.machine import (MODE_OPPORTUNISTIC, P_E, P_N, P_S, P_W,
                                      PORTS, MachineConfig, MachineState,
                                      _fdiv, _i32, _prog_rows)

__all__ = ["make_fast_forward", "make_lone_probe", "path_position"]


def path_position(xp, hx, hy, ex, ey, t):
    """Position after ``t`` hops of the lone-flight route (hx,hy)->(ex,ey).

    ``xp`` is the array namespace, ``numpy`` or ``torch``: the engine and
    the property-test reference share this one implementation.  Mirrors
    the cycle's ``route`` under the lone-flight precondition (every
    credit available):

    * westbound (dx < 0): west-first takes ALL W hops before any N/S;
    * eastbound: the adaptive tie-break degenerates to "step E iff
      remaining |dx| >= remaining |dy|" — a deterministic staircase that
      alternates (N/S first when |dy| leads) until one axis is spent,
      then runs the other straight.

    Returns ``(px, py)``.  Only meaningful for 0 <= t <= |dx|+|dy|.
    ``//`` is floor division under both namespaces.
    """
    dx = ex - hx
    dy = ey - hy
    na, nb = xp.abs(dx), xp.abs(dy)
    sx, sy = xp.sign(dx), xp.sign(dy)
    dist = na + nb
    s = dist - t                       # hops remaining after t
    # westbound: all W first -> E-axis drains before N/S starts.
    a_w = xp.clip(s - nb, 0, None)
    b_w = xp.minimum(s, nb)
    # eastbound staircase: alternating while both axes live, the
    # majority axis holding the extra hop, then straight.
    m2 = 2 * xp.minimum(na, nb)
    a_hi = xp.where(na >= nb, s - nb, na)
    b_hi = xp.where(na >= nb, nb, s - na)
    a_e = xp.where(s >= m2, a_hi, s // 2)
    b_e = xp.where(s >= m2, b_hi, (s + 1) // 2)
    a = xp.where(dx < 0, a_w, a_e)
    b = xp.where(dx < 0, b_w, b_e)
    return hx + sx * (na - a), hy + sy * (nb - b)


def _seg(x: torch.Tensor, sub_ids: torch.Tensor) -> torch.Tensor:
    """Per-sub-lane sum of ``x`` (B, N[, F]) broadcast back to every PE
    of the sub-lane: ``segment_sum(x, sub_id)[sub_id]`` for each lane."""
    idx = sub_ids.long()
    if x.dim() == 3:
        idx = idx[..., None].expand(x.shape)
    g = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    g.scatter_add_(1, idx, x)
    return torch.gather(g, 1, idx)


def make_lone_probe():
    """Build ``lone(sub_ids, st) -> (B, N) bool``: per PE, whether its
    sub-lane is in *lone flight* — exactly one buffered flit anywhere in
    the sub-lane and no other event source (pending / software-wait
    FIFOs empty, no stream engine on, every static AM injected).

    This is the precondition of the compressed advance; the engine also
    evaluates it once per chunk to steer its two-speed chunk dispatch.
    """
    def lone(sub_ids: torch.Tensor, st: MachineState) -> torch.Tensor:
        g_flits = _seg(_i32(st.buf_n.sum(2)), sub_ids)
        g_pend = _seg(st.pend_n, sub_ids)
        g_swq = _seg(st.swq_n, sub_ids)
        g_strm = _seg(_i32(st.stream_on), sub_ids)
        g_amq = _seg(_i32(st.amq_head < st.amq_len), sub_ids)
        return ((g_flits == 1) & (g_pend == 0) & (g_swq == 0)
                & (g_strm == 0) & (g_amq == 0))

    return lone


def make_fast_forward(cfg: MachineConfig, n_pes: int):
    """Build ``ff(prog, modes, geoms, sub_ids, remaining, st, st2) -> st2'``.

    Applied once per wall tick, after the plain transition ``st2`` of
    pre-state ``st``: for every *eligible* sub-lane it rewrites ``st2``'s
    message buffers, ``cycle``, ``rr`` and ``st_hops`` to the state
    ``delta`` plain ticks would produce, where ``delta = min(hops to
    arrival, remaining budget, cycles to max_cycles)``.  Ineligible
    sub-lanes keep ``st2``, and ``delta < 2`` falls back to the plain
    tick, so the compressed engine is bit-identical to the plain one.

    Shapes carry the lane axis: ``prog`` (B, P, CFG_F), ``modes`` (B,),
    ``geoms`` (B, 2), ``sub_ids`` / ``remaining`` (B, N) int32; a static
    engine's config supplies the mesh (``traced_geometry=False``) or the
    mode (``traced_modes=False``) instead, as in the reference.  Every
    value is derived from the pre-state leaves the cycle does not update
    in place, and the new ``buf`` is a new tensor.
    """
    n = int(n_pes)
    lone_probe = make_lone_probe()
    max_cycles = int(cfg.max_cycles)

    def ff(prog, modes, geoms, sub_ids, remaining, st: MachineState,
           st2: MachineState) -> MachineState:
        dev = st.cycle.device
        pe_ids = torch.arange(n, dtype=torch.int32, device=dev)
        ports = torch.arange(PORTS, dtype=torch.int32, device=dev)
        if cfg.traced_geometry:
            w, gh = geoms[:, 0:1], geoms[:, 1:2]              # (B, 1)
        else:
            w, gh = cfg.width, cfg.height
        if cfg.traced_modes:
            opp_on = ((modes & MODE_OPPORTUNISTIC) != 0)[:, None]
        else:
            opp_on = cfg.opportunistic

        # ---- lone-flight proof, per sub-lane -------------------------
        lone = lone_probe(sub_ids, st)

        # ---- the flit: holder PE, message words, effective dest ------
        # contiguity invariant: a non-empty FIFO's head is slot 0.
        holder = st.buf_n > 0                               # (B, N, PORTS)
        has = holder.any(2)                                 # (B, N)
        msg_pe = _i32((st.buf[:, :, :, 0, :] * _i32(holder)[..., None])
                      .sum(2))                              # (B, N, MSG_F)
        msg = _seg(msg_pe, sub_ids)
        hold_pe = _seg(torch.where(has, pe_ids, 0), sub_ids)
        via = msg[..., F_VIA]
        de = torch.where(via >= 0, via, msg[..., F_DST0])   # leg target
        in_mesh = (de >= 0) & (de < w * gh)
        dec = de.clamp(min=0)
        ex, ey = torch.remainder(dec, w), _fdiv(dec, w)
        hx, hy = torch.remainder(hold_pe, w), _fdiv(hold_pe, w)
        na, nb = (ex - hx).abs(), (ey - hy).abs()
        sx, sy = torch.sign(ex - hx), torch.sign(ey - hy)
        dist = na + nb

        # ---- interception veto (mirror of the cycle's icand) ---------
        nxt_op = _prog_rows(prog, msg[..., F_PC])[..., C_OP]
        icept = (is_alu_op(msg[..., F_OP]) & (msg[..., F_OP1C] == 1)
                 & (msg[..., F_OP2C] == 1) & (nxt_op != OP_NOP)
                 & (via < 0)) & opp_on

        # ---- compressed advance ---------------------------------------
        cap_left = max_cycles - st.cycle
        delta = torch.minimum(torch.minimum(dist, remaining), cap_left)
        eligible = lone & in_mesh & ~icept & (delta >= 2)

        def pos_at(t):
            return path_position(torch, hx, hy, ex, ey, t)

        # landing PE and its arrival input port (a flit leaving E lands
        # on the neighbor's W port, etc.; y grows southward).
        pxd, pyd = pos_at(delta)
        pxp, pyp = pos_at(delta - 1)
        stepx, stepy = pxd - pxp, pyd - pyp
        aport = torch.where(
            stepx > 0, P_W, torch.where(
                stepx < 0, P_E, torch.where(
                    stepy > 0, P_N, torch.full_like(stepy, P_S))))
        fp = pyd * w + pxd

        # per-PE hop attribution: PE r sent the flit iff it is the k-th
        # path position for some k < delta (recover k from coordinates,
        # then check that the closed form round-trips).
        rx, ry = torch.remainder(pe_ids, w), _fdiv(pe_ids, w)   # (B, N)
        a_r = na - sx * (rx - hx)
        b_r = nb - sy * (ry - hy)
        k_r = dist - (a_r + b_r)
        k_c = torch.minimum(k_r.clamp(min=0), dist)
        pxk, pyk = pos_at(k_c)
        on_path = (pxk == rx) & (pyk == ry) & (k_r == k_c)
        hop_inc = _i32(eligible & on_path & (k_r < delta))

        # ---- rewrite st2 for eligible sub-lanes ------------------------
        # from the PRE-state: the plain tick already moved the flit one
        # hop inside st2, so slot 0 of every port of every PE in the
        # sub-lane is rewritten (deeper slots are zero by the lone
        # invariant).
        msg_new = msg.clone()
        msg_new[..., F_HOPS] += delta
        zero_m = eligible[..., None] & holder
        put_m = ((eligible & (pe_ids == fp))[..., None]
                 & (ports == aport[..., None]))
        buf0 = torch.where(put_m[..., None], msg_new[:, :, None, :],
                           torch.where(zero_m[..., None], 0,
                                       st.buf[:, :, :, 0, :]))
        slot0 = torch.where(eligible[..., None, None], buf0,
                            st2.buf[:, :, :, 0, :])
        buf = torch.cat([slot0[:, :, :, None, :], st2.buf[:, :, :, 1:, :]],
                        dim=3)
        buf_n = torch.where(eligible[..., None],
                            st.buf_n - _i32(zero_m) + _i32(put_m),
                            st2.buf_n)
        return st2._replace(
            buf=buf, buf_n=buf_n,
            cycle=torch.where(eligible, st.cycle + delta, st2.cycle),
            rr=torch.where(eligible, torch.remainder(st.rr + delta, PORTS),
                           st2.rr),
            st_hops=torch.where(eligible, st.st_hops + hop_inc,
                                st2.st_hops))

    return ff
