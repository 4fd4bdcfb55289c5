"""Pre-dispatch static analysis for compiled active-message programs.

The Nexus fabric's invariants — destination PEs inside the lane's mesh,
program counters inside the config memory, west-first routes confined to
their bounding boxes (the isolation property sub-mesh lane packing
depends on), the pending-FIFO reservation discipline — are enforced at
*runtime* by clipping, guards and golden tests.  Once the sweep service
admits arbitrary client workloads into shared super-lanes, that is too
late: one malformed lane can poison co-tenants or trip the overflow
guard mid-slice with no attribution.

This package lifts a :class:`repro_torch.core.compiler.CompiledWorkload` into
an analyzable IR (:mod:`repro_torch.analysis.ir`: an abstract interpreter that
walks every static AM's morph/spawn/continuation chain against the exact
engine semantics) and runs four check families pre-dispatch
(:mod:`repro_torch.analysis.checks`):

* **well-formedness** — AM destination PEs inside the lane's ``geom``,
  PC / branch targets inside the program, opcode and mode bitmask
  ranges, ``meta_pe`` marks consistent with how the program actually
  consumes metadata words;
* **co-tenancy soundness** — every message leg's west-first minimal
  route stays inside its src→dst bounding box and therefore inside the
  lane's mesh; after packing, :func:`check_packed_batch` certifies the
  rebased arrays against the sub-lane rectangles (``sub_ids``);
* **capacity** — the pending-FIFO reservation discipline
  (``machine.py``'s comment-prose proof, made executable against the
  live module constants) plus per-PE stream fan-in vs. the wait-queue
  guarantee, flagging workloads whose message volume is only provably
  safe dynamically;
* **static cost model** (:mod:`repro_torch.analysis.cost`) — per-PE
  instruction counts, hop-weighted message volume and a critical-path
  cycle lower bound, exposed as :func:`estimate_cycles` and wired in as
  the planners' default ``cycle_hints`` source (replacing the
  inverse-mesh-area proxy).

``python -m repro_torch.analysis.lint`` audits every benchmark workload across
the fig17 geometry grid and prints a findings table (CI gates on zero
error findings).
"""
from repro_torch.analysis.checks import (Finding, WorkloadValidationError,
                                   check_capacity, check_mode,
                                   check_packed_batch, check_workload,
                                   error_findings, validate_request)
from repro_torch.analysis.cost import (cost_report, estimate_cycles,
                                 fast_forward_bound, rank_correlation,
                                 static_hints)
from repro_torch.analysis.ir import ChainSummary, lift

__all__ = [
    "Finding", "WorkloadValidationError", "ChainSummary", "lift",
    "check_workload", "check_mode", "check_capacity",
    "check_packed_batch", "error_findings", "validate_request",
    "estimate_cycles", "static_hints", "cost_report", "rank_correlation",
    "fast_forward_bound",
]
