"""Pre-dispatch check battery over lifted workloads.

Four families (see the package docstring): array-level well-formedness,
chain-level co-tenancy soundness (via :mod:`repro_torch.analysis.ir`),
capacity vs. the pending-FIFO reservation discipline, and packed-batch
rectangle confinement.  Everything returns :class:`Finding` lists;
:func:`raise_on_findings` turns them into a typed
:class:`WorkloadValidationError` at the dispatch boundary.

Capacity constants (``PEND_CAP``, ``STREAM_THROTTLE``) are read from
``repro_torch.core.machine`` at *call* time, not import time, so tests that
monkeypatch them to provoke overflow see the discipline check fire.
"""
from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np

from repro_torch.core import am
from repro_torch.analysis.ir import ChainSummary, Finding, lane_view, lift

__all__ = [
    "Finding", "WorkloadValidationError", "check_workload", "check_mode",
    "check_capacity", "check_packed_batch", "error_findings",
    "raise_on_findings", "validate_request",
]

# How many findings a WorkloadValidationError spells out before eliding.
_MAX_SHOWN = 12


class WorkloadValidationError(ValueError):
    """A workload failed static verification.

    Carries the full per-lane / per-instruction :attr:`findings` list;
    the message renders the first few.  Subclasses ``ValueError`` so
    legacy callers that catch argument errors keep working.
    """

    def __init__(self, findings: Sequence[Finding],
                 context: str = "workload failed static verification"):
        self.findings = tuple(findings)
        lines = [str(f) for f in self.findings[:_MAX_SHOWN]]
        extra = len(self.findings) - len(lines)
        if extra > 0:
            lines.append(f"... and {extra} more finding(s)")
        super().__init__(context + ":\n" + "\n".join("  " + s for s in lines))


def error_findings(findings: Iterable[Finding],
                   strict: bool = False) -> list[Finding]:
    """The dispatch-fatal subset: errors, plus warnings under strict."""
    bad = ("error", "warn") if strict else ("error",)
    return [f for f in findings if f.severity in bad]


def raise_on_findings(findings: Sequence[Finding], strict: bool = False,
                      context: str = "workload failed static verification",
                      ) -> None:
    fatal = error_findings(findings, strict=strict)
    if fatal:
        raise WorkloadValidationError(fatal, context=context)


def _relabel(findings: Iterable[Finding], lane: int) -> list[Finding]:
    return [Finding(code=f.code, severity=f.severity, message=f.message,
                    lane=lane, pe=f.pe, where=f.where) for f in findings]


# ---------------------------------------------------------------------------
# Well-formedness (array level)
# ---------------------------------------------------------------------------

def _check_arrays(lv) -> list[Finding]:
    """Vectorized field-range checks over the static images."""
    out: list[Finding] = []
    n, w, h = lv.n_pes, lv.geom[0], lv.geom[1]
    sams, alen = lv.static_ams, np.asarray(lv.amq_len)

    if w < 1 or h < 1 or w * h != n:
        out.append(Finding("wf.geom-mismatch", "error",
                           f"geom {w}x{h} does not cover the {n}-PE arrays"))
        return out  # every PE-range check below would be meaningless
    if alen.shape[0] != n or np.any(alen < 0) or np.any(alen > sams.shape[1]):
        out.append(Finding("wf.amq-len", "error",
                           f"amq_len outside [0, {sams.shape[1]}] or wrong "
                           f"shape {alen.shape}"))
        return out

    # Mask: queue slots the engine will actually inject.
    k_idx = np.arange(sams.shape[1])[None, :]
    queued = k_idx < alen[:, None]
    valid = queued & (sams[:, :, am.F_VALID] == 1)

    def flag(mask: np.ndarray, code: str, msg: str,
             severity: str = "error") -> None:
        if not np.any(mask):
            return
        pes, ks = np.nonzero(mask)
        shown = 0
        for p, k in zip(pes.tolist(), ks.tolist()):
            out.append(Finding(code, severity, msg.format(
                val="/".join(str(int(sams[p, k, f])) for f in
                             (am.F_DST0, am.F_DST1, am.F_DST2))),
                pe=p, where=f"amq[{k}]"))
            shown += 1
            if shown >= 4:
                if len(pes) > shown:
                    out.append(Finding(code, severity,
                                       f"... {len(pes) - shown} more static "
                                       "AMs with the same defect"))
                break

    for f in (am.F_DST0, am.F_DST1, am.F_DST2):
        d = sams[:, :, f]
        flag(valid & ((d < -1) | (d >= n)),
             "wf.dst-out-of-mesh",
             "static AM dst chain {val} targets a PE outside the "
             f"{w}x{h} mesh")
    pc = sams[:, :, am.F_PC]
    flag(valid & ((pc < 0) | (pc >= lv.n_prog)),
         "wf.pc-out-of-range",
         f"static AM PC outside program [0, {lv.n_prog})")
    op = sams[:, :, am.F_OP]
    flag(valid & ((op < 0) | (op >= am.N_OPCODES)),
         "wf.op-invalid", f"static AM opcode outside [0, {am.N_OPCODES})")
    flag(valid & (sams[:, :, am.F_VIA] != -1),
         "wf.via-preset",
         "static AM has a pre-set Valiant waypoint (F_VIA != -1); "
         "waypoints are drawn by the router, a preset one can leave the "
         "src->dst bounding box")

    prog = lv.prog
    if prog.ndim != 2 or prog.shape[1] != am.CFG_F:
        out.append(Finding("wf.prog-shape", "error",
                           f"program shape {prog.shape} != (P, {am.CFG_F})"))
        return out
    for row in range(prog.shape[0]):
        npc = int(prog[row, am.C_NEXT_PC])
        cop = int(prog[row, am.C_OP])
        if not 0 <= npc < prog.shape[0]:
            out.append(Finding("wf.pc-out-of-range", "error",
                               f"config row {row}: next_pc {npc} outside "
                               f"program [0, {prog.shape[0]})",
                               where=f"prog[{row}]"))
        if not 0 <= cop < am.N_OPCODES:
            out.append(Finding("wf.op-invalid", "error",
                               f"config row {row}: opcode {cop} outside "
                               f"[0, {am.N_OPCODES})", where=f"prog[{row}]"))
        for sel, hi in ((am.C_OP1SEL, 2), (am.C_OP2SEL, 3),
                        (am.C_DSTSEL, 1), (am.C_RESSEL, 2)):
            v = int(prog[row, sel])
            if not 0 <= v <= hi:
                out.append(Finding("wf.selector-range", "warn",
                                   f"config row {row}: selector field {sel} "
                                   f"= {v} outside [0, {hi}]",
                                   where=f"prog[{row}]"))

    mp = lv.meta_pe
    if mp is not None:
        if mp.shape != lv.mem_val.shape:
            out.append(Finding("wf.meta-pe-shape", "error",
                               f"meta_pe shape {mp.shape} != mem_val shape "
                               f"{lv.mem_val.shape}"))
        else:
            tgt = lv.mem_meta[:, :, 1]
            bad = mp & ((tgt < 0) | (tgt >= n))
            if np.any(bad):
                pes, addrs = np.nonzero(bad)
                p, a = int(pes[0]), int(addrs[0])
                out.append(Finding(
                    "wf.meta-pe-out-of-mesh", "error",
                    f"{len(pes)} meta_pe-marked word(s) hold PE ids outside "
                    f"the {w}x{h} mesh (first: mem_meta[{p},{a},1]="
                    f"{int(tgt[p, a])})", pe=p, where=f"mem[{a}]"))
    return out


# ---------------------------------------------------------------------------
# Capacity vs. the reservation discipline
# ---------------------------------------------------------------------------

def check_capacity(wl: Any, summary: ChainSummary | None = None,
                   stream_wait_cap: int | None = None) -> list[Finding]:
    """The pending-FIFO safety argument, made executable.

    The engine's overflow guard fires at ``pend_n >= PEND_CAP - 2``; the
    comment-prose proof in ``machine.py`` shows no unit can push past it
    *provided* ``STREAM_THROTTLE <= PEND_CAP - 3`` (decode reserves one
    slot, compute two, the stream gate bounds post-execution pushes).
    This check re-derives that inequality against the live module
    constants and bounds the per-PE stream wait queue, whose guarantee
    (``swq_n < stream_wait_cap - 1`` accept gate) is the one capacity
    limit the discipline does NOT cover.
    """
    from repro_torch.core import machine  # late import: constants monkeypatchable

    out: list[Finding] = []
    if machine.STREAM_THROTTLE > machine.PEND_CAP - 3:
        out.append(Finding(
            "capacity.reservation-discipline", "error",
            f"STREAM_THROTTLE={machine.STREAM_THROTTLE} > PEND_CAP-3="
            f"{machine.PEND_CAP - 3}: the stream unit can push past the "
            "decode/compute reservations and overrun the pending FIFO "
            "(provable overflow; see the discipline proof in machine.py)"))
    if summary is None:
        summary = lift(wl)
    if stream_wait_cap is None:
        from repro_torch.core.machine import MachineConfig
        stream_wait_cap = MachineConfig().stream_wait_cap
    if summary.dynamic:
        out.append(Finding(
            "capacity.dynamic", "info",
            "message volume is data-dependent (conditional continuations); "
            "in-flight bounds rely on the runtime reservation discipline, "
            "not a static certificate"))
        return out
    fanin = summary.stream_fanin
    if fanin.size and int(fanin.max()) > stream_wait_cap - 1:
        hot = int(fanin.argmax())
        out.append(Finding(
            "capacity.stream-fanin", "error",
            f"PE {hot} receives {int(fanin[hot])} STREAM tasks but the "
            f"wait queue only guarantees acceptance below "
            f"{stream_wait_cap - 1} (stream_wait_cap - 1); excess tasks "
            "can deadlock against the accept gate", pe=hot))
    press = summary.inject - summary.amq_len  # dynamically pushed at the PE
    if press.size and int(press.max()) > machine.PEND_CAP - 2:
        hot = int(press.argmax())
        out.append(Finding(
            "capacity.pend-pressure", "info",
            f"PE {hot} generates {int(press[hot])} pending-FIFO pushes "
            f"(> PEND_CAP-2 = {machine.PEND_CAP - 2} slots); safe only "
            "through the reservation discipline's backpressure, not a "
            "static in-flight bound", pe=hot))
    return out


# ---------------------------------------------------------------------------
# Whole-workload + request-level entry points
# ---------------------------------------------------------------------------

def check_workload(wl: Any, stream_wait_cap: int | None = None,
                   ) -> list[Finding]:
    """Run the full battery on one compiled workload.

    Returns the combined findings (array well-formedness, chain walk,
    capacity).  Raises ``TypeError`` if ``wl`` is not workload-shaped —
    callers decide whether unliftable lanes are acceptable.
    """
    lv = lane_view(wl)
    findings = _check_arrays(lv)
    if any(f.severity == "error" for f in findings):
        # The chain walk assumes minimally sane arrays; don't wade into
        # out-of-range indices just to duplicate the diagnostics.
        return findings
    summary = lift(wl)
    findings += summary.findings
    findings += check_capacity(wl, summary=summary,
                               stream_wait_cap=stream_wait_cap)
    return findings


def check_mode(mode: Any, lane: int | None = None) -> list[Finding]:
    """Validate a fabric-mode name/bitmask via the engine's own resolver."""
    from repro_torch.core.machine import resolve_mode
    try:
        resolve_mode(mode)
    except (ValueError, TypeError, KeyError) as e:
        return [Finding("wf.mode-invalid", "error",
                        f"fabric mode {mode!r} is not a FABRIC_MODES name "
                        f"or a valid bitmask: {e}", lane=lane)]
    return []


def _liftable(wl: Any) -> bool:
    return all(hasattr(wl, a) for a in
               ("prog", "static_ams", "amq_len", "mem_val", "mem_meta"))


def validate_request(workloads: Sequence[Any],
                     modes: Sequence[Any] | None = None,
                     strict: bool = False,
                     stream_wait_cap: int | None = None) -> None:
    """Validate a batch pre-dispatch; raise WorkloadValidationError.

    Lanes that are not workload-shaped (raw array tuples, pre-packed
    ``BatchedWorkloads``) are skipped — they come from in-repo packers
    that already operated on verified inputs, and the packed-batch
    confinement check covers them downstream.
    """
    findings: list[Finding] = []
    for lane, wl in enumerate(workloads):
        if not _liftable(wl):
            continue
        try:
            findings += _relabel(
                check_workload(wl, stream_wait_cap=stream_wait_cap), lane)
        except TypeError:
            continue
    if modes is not None:
        for lane, mode in enumerate(modes):
            findings += check_mode(mode, lane=lane)
    raise_on_findings(findings, strict=strict,
                      context="static verification rejected the sweep")


# ---------------------------------------------------------------------------
# Packed-batch rectangle confinement
# ---------------------------------------------------------------------------

def check_packed_batch(batch: Any) -> list[Finding]:
    """Certify a packed super-lane batch: no rebased AM targets a PE
    outside its own sub-lane's rectangle.

    ``pack_workloads`` relocates each small mesh into a disjoint
    rectangle of the super-lane and rebases every destination field and
    meta_pe-marked word; together with the west-first routing lemma
    (minimal routes never leave the src→dst bounding box, and a
    rectangle is bbox-closed) this is exactly the isolation property
    co-tenancy rests on.  Here we re-verify the rebased arrays instead
    of trusting the transform: every destination of every valid static
    AM must carry the same ``sub_ids`` label as its source PE.
    """
    out: list[Finding] = []
    sams = np.asarray(batch.static_ams)          # (B, N, Q, MSG_F)
    sub = np.asarray(batch.sub_ids)              # (B, N)
    bsz, n = sams.shape[0], sams.shape[1]
    k_idx = np.arange(sams.shape[2])[None, None, :]
    queued = k_idx < np.asarray(batch.amq_len)[:, :, None]
    valid = queued & (sams[:, :, :, am.F_VALID] == 1)
    src_lbl = np.broadcast_to(sub[:, :, None], valid.shape)

    # meta_pe-marked metadata words (continuation / spawn destinations)
    # must also stay inside their word's rectangle.
    mp = getattr(batch, "meta_pe", None)

    for f, fname in ((am.F_DST0, "dst0"), (am.F_DST1, "dst1"),
                     (am.F_DST2, "dst2"), (am.F_VIA, "via")):
        d = sams[:, :, :, f]
        live = valid & (d >= 0)
        if not np.any(live):
            continue
        oob = live & (d >= n)
        inb = live & (d < n)
        dst_lbl = np.take_along_axis(
            sub, np.clip(d, 0, n - 1).reshape(bsz, -1), axis=1,
        ).reshape(d.shape)
        escape = inb & (dst_lbl != src_lbl)
        for mask, code, msg in (
                (oob, "wf.dst-out-of-mesh",
                 f"packed AM {fname} targets a PE outside the super-lane"),
                (escape, "cotenancy.rect-escape",
                 f"packed AM {fname} crosses into a different sub-lane "
                 "rectangle (rebasing is broken or the lane was corrupted "
                 "post-pack)")):
            if not np.any(mask):
                continue
            bs, ps, ks = np.nonzero(mask)
            b, p, k = int(bs[0]), int(ps[0]), int(ks[0])
            out.append(Finding(
                code, "error",
                f"{msg}: batch {b} PE {p} amq[{k}] {fname}="
                f"{int(sams[b, p, k, f])} (source sub-lane "
                f"{int(sub[b, p])}); {len(bs)} AM(s) affected",
                lane=b, pe=p, where=f"amq[{k}].{fname}"))

    if mp is not None:
        mp = np.asarray(mp)
        tgt = np.asarray(batch.mem_meta)[:, :, :, 1]
        oob = mp & ((tgt < 0) | (tgt >= n))
        word_lbl = np.broadcast_to(sub[:, :, None], tgt.shape)
        tgt_lbl = np.take_along_axis(
            sub, np.clip(tgt, 0, n - 1).reshape(bsz, -1), axis=1,
        ).reshape(tgt.shape)
        escape = mp & ~oob & (tgt_lbl != word_lbl)
        for mask, code, msg in (
                (oob, "wf.meta-pe-out-of-mesh",
                 "packed meta_pe word holds a PE id outside the super-lane"),
                (escape, "cotenancy.rect-escape",
                 "packed meta_pe word points into a different sub-lane "
                 "rectangle")):
            if not np.any(mask):
                continue
            bs, ps, ads = np.nonzero(mask)
            b, p, a = int(bs[0]), int(ps[0]), int(ads[0])
            out.append(Finding(
                code, "error",
                f"{msg}: batch {b} mem_meta[{p},{a},1]={int(tgt[b, p, a])} "
                f"(word's sub-lane {int(sub[b, p])}); {len(bs)} word(s) "
                "affected", lane=b, pe=p, where=f"mem[{a}]"))
    return out
