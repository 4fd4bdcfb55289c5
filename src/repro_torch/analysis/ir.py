"""Lift a compiled workload into an analyzable IR.

A ``CompiledWorkload`` is four numpy images (config memory, static AM
queues, data memory, metadata memory); what the fabric *does* with them
only exists inside ``machine._make_cycle``.  This module re-implements
the architectural (not micro-architectural) semantics of the decode,
compute and stream units as an abstract interpreter over single
messages: every static AM seeds a chain, and each step either terminates
(store, NOP next-op, failed conditional) or yields successor messages
(decode/ALU morphs, stream spawns, conditional continuations).

The abstract message tracks field values as ``int | None`` where ``None``
means "data-dependent value" (e.g. the result of a LOAD or an ALU op).
Addresses — destinations, PCs, store targets, stream descriptors — are
concrete in every compiler-produced program, so the walk resolves the
complete message DAG for the static kernels and a conservative
skeleton for data-dependent ones (BFS/SSSP), where conditional
continuations are widened and memoized per ``(pe, pc, res)`` state.

The product is a :class:`ChainSummary`: findings (malformed fields,
out-of-bounds accesses, escapes), per-PE instruction/injection/spawn
counts, stream fan-in, hop-weighted message volume, and a critical-path
lower bound — the raw material for :mod:`repro_torch.analysis.checks` and
:mod:`repro_torch.analysis.cost`.

Cost-model soundness note: ALU executions are charged one cycle but ZERO
hops.  Under ``MODE_OPPORTUNISTIC`` an ALU op may be intercepted and
executed at any PE along the route, and TIA anchoring retargets ALU ops
to the emitting PE, so the only mode-independent distance a chain must
cover is between consecutive *memory* operations, which are pinned to
the PE that owns the address.  Memory legs are charged the Manhattan
distance of the west-first minimal route (which never leaves the src→dst
bounding box — the routing lemma co-tenancy rests on).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core import am

# Interpreter step budget.  Chains are linear in message count, so this
# bounds analysis work on pathological inputs; the benchmark suite peaks
# around ~10^5 events at the 8x8 fig17 sizes.
DEFAULT_MAX_EVENTS = 2_000_000

_TERMINAL_STORES = (am.OP_STORE_ADD, am.OP_STORE_SET)
_COND_STORES = (am.OP_STORE_MIN, am.OP_CHECKSET)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic from static analysis.

    ``severity`` is ``"error"`` (reject pre-dispatch), ``"warn"``
    (suspicious, lint-fatal but not dispatch-fatal) or ``"info"``
    (property worth surfacing, e.g. "safety relies on the runtime
    reservation discipline").  ``where`` pins the finding to a source:
    a static-AM queue slot, a program row, or a chain step.
    """

    code: str
    severity: str
    message: str
    lane: int | None = None
    pe: int | None = None
    where: str | None = None

    def __str__(self) -> str:
        loc = []
        if self.lane is not None:
            loc.append(f"lane={self.lane}")
        if self.pe is not None:
            loc.append(f"pe={self.pe}")
        if self.where:
            loc.append(self.where)
        at = f" [{', '.join(loc)}]" if loc else ""
        return f"{self.severity.upper()} {self.code}{at}: {self.message}"


@dataclasses.dataclass(frozen=True)
class LaneView:
    """The arrays the lifter needs, decoupled from ``CompiledWorkload``.

    Batched/packed lanes (plain arrays, no ``meta_pe``) can be analyzed
    for cost through the same interpreter by building a view directly.
    """

    prog: np.ndarray          # (P, CFG_F)
    static_ams: np.ndarray    # (N, Q, MSG_F)
    amq_len: np.ndarray       # (N,)
    mem_val: np.ndarray       # (N, MEM)
    mem_meta: np.ndarray      # (N, MEM, 2)
    geom: tuple[int, int]
    meta_pe: np.ndarray | None = None   # (N, MEM) bool
    alloc_top: np.ndarray | None = None  # (N,) compiler bump-pointer highwater
    name: str = ""

    @property
    def n_pes(self) -> int:
        return int(self.static_ams.shape[0])

    @property
    def n_prog(self) -> int:
        return int(self.prog.shape[0])

    @property
    def mem_words(self) -> int:
        return int(self.mem_val.shape[1])


def lane_view(wl: Any) -> LaneView:
    """Build a :class:`LaneView` from anything workload-shaped.

    Accepts a ``CompiledWorkload`` (or any object with the same
    attributes).  Raises ``TypeError`` when required pieces are missing
    so callers can cleanly skip non-liftable lanes (e.g. raw tuples).
    """
    try:
        prog = np.asarray(wl.prog)
        sams = np.asarray(wl.static_ams)
        alen = np.asarray(wl.amq_len)
        mv = np.asarray(wl.mem_val)
        mm = np.asarray(wl.mem_meta)
        geom = wl.geom
    except AttributeError as e:
        raise TypeError(f"not a liftable workload: {e}") from None
    if geom is None:
        # Pre-geometry workloads placed on an unknown mesh; infer a
        # degenerate 1 x N strip so bounds checks stay meaningful.
        geom = (int(sams.shape[0]), 1)
    w, h = int(geom[0]), int(geom[1])
    meta_pe = getattr(wl, "meta_pe", None)
    if meta_pe is not None:
        meta_pe = np.asarray(meta_pe)
    top = getattr(wl, "alloc_top", None)
    if top is not None:
        top = np.asarray(top)
    return LaneView(prog=prog, static_ams=sams, amq_len=alen, mem_val=mv,
                    mem_meta=mm, geom=(w, h), meta_pe=meta_pe,
                    alloc_top=top, name=str(getattr(wl, "name", "")))


@dataclasses.dataclass
class ChainSummary:
    """Everything the abstract walk learned about one lane."""

    findings: list[Finding]
    # Per-PE counters (all shape (N,), int64):
    mem_exec: np.ndarray      # memory-class ops decoded at the PE
    alu_exec: np.ndarray      # ALU ops nominally destined for the PE
    inject: np.ndarray        # messages entering the PE's inject port:
    #                           static AMs + decode emissions + spawns
    spawns: np.ndarray        # stream-unit spawns issued at the PE
    stream_fanin: np.ndarray  # STREAM tasks targeting the PE
    amq_len: np.ndarray
    hop_volume: int           # sum of nominal route Manhattan distances
    critical_path: int        # cycle lower bound along the longest chain
    n_messages: int           # abstract messages walked
    dynamic: bool             # True when conditional stores were reached
    truncated: bool           # walk hit the event budget

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]


class _Walker:
    """Iterative abstract interpreter over one lane's message chains."""

    def __init__(self, lv: LaneView, max_events: int):
        self.lv = lv
        self.n = lv.n_pes
        self.w, self.h = lv.geom
        self.max_events = max_events
        self.events = 0
        self.findings: list[Finding] = []
        self._seen_codes: set[tuple] = set()
        self._memo: set[tuple] = set()
        n = self.n
        self.mem_exec = np.zeros(n, dtype=np.int64)
        self.alu_exec = np.zeros(n, dtype=np.int64)
        self.inject = np.zeros(n, dtype=np.int64)
        self.spawns = np.zeros(n, dtype=np.int64)
        self.stream_fanin = np.zeros(n, dtype=np.int64)
        self.hop_volume = 0
        self.critical_path = 0
        self.n_messages = 0
        self.dynamic = False
        self.truncated = False

    # -- bookkeeping ---------------------------------------------------
    def emit(self, code: str, severity: str, message: str,
             pe: int | None = None, where: str | None = None) -> None:
        key = (code, pe, where)
        if key in self._seen_codes:
            return
        self._seen_codes.add(key)
        self.findings.append(Finding(code=code, severity=severity,
                                     message=message, pe=pe, where=where))

    def _manhattan(self, a: int, b: int) -> int:
        ax, ay = a % self.w, a // self.w
        bx, by = b % self.w, b // self.w
        return abs(ax - bx) + abs(ay - by)

    def _addr_ok(self, pe: int, addr: int, what: str, where: str) -> bool:
        """Bounds-check a concrete memory address at ``pe``."""
        if not 0 <= addr < self.lv.mem_words:
            self.emit("chain.addr-out-of-bounds", "error",
                      f"{what} address {addr} outside [0, "
                      f"{self.lv.mem_words}) at PE {pe}", pe=pe, where=where)
            return False
        top = self.lv.alloc_top
        if top is not None and addr >= int(top[pe]):
            self.emit("chain.addr-unallocated", "warn",
                      f"{what} address {addr} beyond PE {pe}'s allocated "
                      f"top {int(top[pe])}", pe=pe, where=where)
        return True

    def _meta_marked(self, pe: int, addr: int, what: str, where: str) -> None:
        """The program consumes mem_meta[pe, addr, 1] as a PE id; the
        word must carry the compiler's meta_pe mark or lane packing will
        relocate the workload without rebasing it (silent cross-lane
        traffic in a packed fabric)."""
        mp = self.lv.meta_pe
        if mp is None:
            self.emit("wf.meta-pe-missing", "error",
                      f"program reads a PE id from metadata ({what}) but the "
                      "workload carries no meta_pe placement mask — packing "
                      "cannot rebase it", pe=pe, where=where)
        elif not bool(mp[pe, addr]):
            self.emit("wf.meta-pe-unmarked", "error",
                      f"{what} reads a PE id from mem_meta[{pe},{addr},1] "
                      "but the word is not marked in meta_pe — packing "
                      "would relocate the lane without rebasing it",
                      pe=pe, where=where)

    # -- the walk ------------------------------------------------------
    def run(self) -> ChainSummary:
        lv = self.lv
        stack: list[tuple] = []
        for pe in range(self.n):
            k_len = int(lv.amq_len[pe])
            self.inject[pe] += k_len
            for k in range(k_len):
                msg = lv.static_ams[pe, k]
                if int(msg[am.F_VALID]) != 1:
                    self.emit("wf.invalid-queued-am", "warn",
                              f"static AM queue slot {k} within amq_len "
                              "has valid=0 (dead injection slot)",
                              pe=pe, where=f"amq[{k}]")
                    continue
                stack.append(self._seed(pe, k, msg))
        while stack:
            if self.events >= self.max_events:
                if not self.truncated:
                    self.truncated = True
                    self.emit("chain.truncated", "info",
                              f"abstract walk stopped after "
                              f"{self.max_events} events; counts and the "
                              "critical path are partial lower bounds")
                break
            self.events += 1
            stack.extend(self._step(stack.pop()))
        return ChainSummary(
            findings=self.findings, mem_exec=self.mem_exec,
            alu_exec=self.alu_exec, inject=self.inject, spawns=self.spawns,
            stream_fanin=self.stream_fanin,
            amq_len=np.asarray(lv.amq_len, dtype=np.int64).copy(),
            hop_volume=self.hop_volume, critical_path=self.critical_path,
            n_messages=self.n_messages, dynamic=self.dynamic,
            truncated=self.truncated)

    def _seed(self, pe: int, k: int, msg: np.ndarray) -> tuple:
        def v(f: int) -> int:
            return int(msg[f])

        # Every field of a *static* AM is a compile-time constant; the
        # _c flags only select value-vs-address interpretation.  Unknown
        # (None) values enter chains exclusively through LOAD/ALU
        # results and conditional-continuation widening.
        # (src, d0, d1, d2, pc, op, res, op1, op2, op2c, t, pos, where)
        return (pe, v(am.F_DST0), v(am.F_DST1), v(am.F_DST2), v(am.F_PC),
                v(am.F_OP), v(am.F_RES), v(am.F_OP1), v(am.F_OP2),
                v(am.F_OP2C), 0, pe, f"amq[{k}]")

    def _step(self, m: tuple) -> list[tuple]:
        (src, d0, d1, d2, pc, op, res, op1, op2, op2c, t, pos, where) = m
        self.n_messages += 1
        if not 0 <= d0 < self.n:
            self.emit("cotenancy.dst-escape", "error",
                      f"message dst0={d0} outside the {self.w}x{self.h} "
                      f"mesh (src PE {src}); its west-first route cannot "
                      "stay inside the lane", pe=src, where=where)
            return []
        q = d0
        if not 0 <= op < am.N_OPCODES:
            self.emit("wf.op-invalid", "error",
                      f"opcode {op} outside [0, {am.N_OPCODES})",
                      pe=q, where=where)
            return []
        if op == am.OP_NOP:
            self.emit("chain.dead-message", "warn",
                      "live message carries OP_NOP; it can never execute "
                      "or retire", pe=q, where=where)
            return []
        if not 0 <= pc < self.lv.n_prog:
            self.emit("wf.pc-out-of-range", "error",
                      f"PC {pc} outside program [0, {self.lv.n_prog}) "
                      "(the engine would clip it to a different row)",
                      pe=q, where=where)
            return []
        # One cycle to decode/execute, plus the nominal route for this leg.
        self.hop_volume += self._manhattan(src, q)
        if am.is_alu_op(op):
            return self._step_alu(m, q)
        return self._step_mem(m, q)

    def _morph(self, cfg: np.ndarray, d0: int, d1: int, d2: int,
               ) -> tuple[int, int, int, int, int]:
        """Shared decode/compute morph: next op/pc + optional rotate."""
        nop = int(cfg[am.C_OP])
        npc = int(cfg[am.C_NEXT_PC])
        if int(cfg[am.C_ROTATE]) == 1:
            d0, d1, d2 = d1, d2, -1
        return nop, npc, d0, d1, d2

    def _step_alu(self, m: tuple, q: int) -> list[tuple]:
        (src, d0, d1, d2, pc, op, res, op1, op2, op2c, t, pos, where) = m
        self.alu_exec[q] += 1
        t = t + 1
        self.critical_path = max(self.critical_path, t)
        cfg = self.lv.prog[pc]
        nop, npc, d0, d1, d2 = self._morph(cfg, d0, d1, d2)
        if nop == am.OP_NOP:
            self.emit("chain.alu-discard", "warn",
                      "ALU result is discarded (next op is NOP); the "
                      "compute was dead", pe=q, where=where)
            return []
        # op1 <- alu result (value); pos unchanged: the exec may happen
        # anywhere en route under interception, so no hop charge.
        return [(q, d0, d1, d2, npc, nop, res, None, op2, op2c, t, pos,
                 where)]

    def _step_mem(self, m: tuple, q: int) -> list[tuple]:
        (src, d0, d1, d2, pc, op, res, op1, op2, op2c, t, pos, where) = m
        # Memory ops are pinned to the PE owning the address: charge the
        # distance from the previous pinned point.
        t = t + 1 + self._manhattan(pos, q)
        self.critical_path = max(self.critical_path, t)
        self.mem_exec[q] += 1
        cfg = self.lv.prog[pc]

        if op in _TERMINAL_STORES:
            if res is None:
                self.emit("chain.unresolved-store", "info",
                          "store address is data-dependent; bounds not "
                          "statically checkable", pe=q, where=where)
            else:
                self._addr_ok(q, res, "store", where)
            return []

        if op in _COND_STORES:
            self.dynamic = True
            if res is None:
                self.emit("chain.unresolved-cond", "info",
                          "conditional-store address is data-dependent; "
                          "its continuation is not statically walkable",
                          pe=q, where=where)
                return []
            if not self._addr_ok(q, res, "conditional store", where):
                return []
            key = (q, pc, res, op)
            if key in self._memo:
                return []           # state already expanded (BFS/SSSP loops)
            self._memo.add(key)
            self._meta_marked(q, res, "continuation", where)
            # Continuation (taken branch): op <- cfg, op1 widens to the
            # stored value, op2 <- meta0 (address-typed), dst <- meta1.
            nop, npc = int(cfg[am.C_OP]), int(cfg[am.C_NEXT_PC])
            if nop == am.OP_NOP:
                return []
            meta0 = int(self.lv.mem_meta[q, res, 0])
            meta1 = int(self.lv.mem_meta[q, res, 1])
            out = (q, meta1, -1, -1, npc, nop, res, None, meta0, 0,
                   t, q, where)
            self.inject[q] += 1
            return [out]

        if op == am.OP_STREAM:
            return self._step_stream(m, q, t, cfg, where)

        if op in (am.OP_LOAD1, am.OP_LOAD2):
            if op == am.OP_LOAD1:
                addr, slot = op1, "op1"
            else:
                addr, slot = op2, "op2"
            if addr is None:
                self.emit("chain.unresolved-load", "info",
                          f"LOAD {slot} address is data-dependent",
                          pe=q, where=where)
            else:
                self._addr_ok(q, addr, f"LOAD {slot}", where)
            nop, npc, d0, d1, d2 = self._morph(cfg, d0, d1, d2)
            if nop == am.OP_NOP:
                return []
            if op == am.OP_LOAD1:
                op1 = None
            else:
                op2, op2c = None, 1
            self.inject[q] += 1     # decode emission re-injects at q
            return [(q, d0, d1, d2, npc, nop, res, op1, op2, op2c, t, q,
                     where)]

        raise AssertionError(f"unhandled mem opcode {op}")  # pragma: no cover

    def _step_stream(self, m: tuple, q: int, t: int, cfg: np.ndarray,
                     where: str) -> list[tuple]:
        (src, d0, d1, d2, pc, op, res, op1, op2, op2c, _t, pos, _w) = m
        self.stream_fanin[q] += 1
        desc = res if op2c == 1 else op2
        if desc is None:
            self.emit("chain.unresolved-stream", "info",
                      "stream descriptor address is data-dependent; "
                      "spawns not statically walkable", pe=q, where=where)
            return []
        if not self._addr_ok(q, desc, "stream descriptor", where):
            return []
        base = int(self.lv.mem_val[q, desc])
        cnt = int(self.lv.mem_meta[q, desc, 0])
        if cnt < 0:
            self.emit("chain.stream-negative-count", "error",
                      f"stream descriptor at [{q},{desc}] has negative "
                      f"element count {cnt}", pe=q, where=where)
            return []
        op1sel = int(cfg[am.C_OP1SEL])
        op2sel = int(cfg[am.C_OP2SEL])
        dstsel = int(cfg[am.C_DSTSEL])
        ressel = int(cfg[am.C_RESSEL])
        nop, npc = int(cfg[am.C_OP]), int(cfg[am.C_NEXT_PC])
        out = []
        for e in range(cnt):
            ea = base + e
            if not self._addr_ok(q, ea, f"stream element {e}", where):
                break
            e_val = int(self.lv.mem_val[q, ea])
            meta0 = int(self.lv.mem_meta[q, ea, 0])
            meta1 = int(self.lv.mem_meta[q, ea, 1])
            if op1sel == 1:
                s_op1: int | None = e_val
            elif op1sel == 2:
                s_op1 = None if op1 is None else op1 + e_val
            else:
                s_op1 = op1
            s_op2, s_op2c = op2, op2c
            if op2sel == 1:
                s_op2, s_op2c = e_val, 1
            elif op2sel == 2:
                s_op2 = None if op2 is None else meta0 + op2
                s_op2c = 0
            elif op2sel == 3:
                s_op2 = None if op1 is None else meta0 + op1
                s_op2c = 0
            s_res: int | None = res
            if ressel == 1:
                s_res = None if res is None else res + meta0
            elif ressel == 2:
                s_res = meta0
            if dstsel == 1:
                self._meta_marked(q, ea, f"stream spawn dst (element {e})",
                                  where)
                s_d = (meta1, d1, d2)
            else:
                s_d = (d1, d2, -1)
            self.spawns[q] += 1
            self.inject[q] += 1
            # Spawns issue one per cycle behind the throttle: element e
            # cannot leave before t + e.
            out.append((q, s_d[0], s_d[1], s_d[2], npc, nop, s_res, s_op1,
                        s_op2, s_op2c, t + e, q, where))
        return out


def lift(wl: Any, max_events: int = DEFAULT_MAX_EVENTS) -> ChainSummary:
    """Lift a workload and walk its full abstract message DAG (cached).

    The summary is memoized on the workload object (``_analysis_cache``
    attribute) — images are immutable post-compile in every in-repo
    flow, and the service re-submits identical objects under load.
    """
    cache = getattr(wl, "_analysis_cache", None)
    if isinstance(cache, dict) and max_events in cache:
        return cache[max_events]
    summary = _Walker(lane_view(wl), max_events).run()
    try:
        if not isinstance(cache, dict):
            cache = {}
            wl._analysis_cache = cache
        cache[max_events] = summary
    except (AttributeError, TypeError, dataclasses.FrozenInstanceError):
        pass  # slotted/frozen duck types: just skip memoization
    return summary
