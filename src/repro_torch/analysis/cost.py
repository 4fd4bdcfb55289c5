"""Static cost model over lifted workloads.

:func:`estimate_cycles` is a mode-independent cycle lower bound built
from three structural throughput limits plus the chain critical path:

* a PE's decode unit retires at most one memory-class op per cycle
  (dual-issue pairs a *compute* op with it, never a second memory op);
* a PE's stream unit issues at most one spawn per cycle;
* a PE's inject port accepts at most one message per cycle, and static
  AMs, decode emissions, conditional continuations and stream spawns
  all funnel through their source PE's port in every fabric mode
  (opportunistic interception only elides *compute* emissions);
* the critical path charges one cycle per op plus the west-first
  Manhattan distance between consecutive memory-pinned executions
  (see the soundness note in :mod:`repro_torch.analysis.ir`).

The estimate is meant for *relative* load balancing — wave planning,
shard balancing, service admission — where it replaces the
inverse-mesh-area proxy; rank agreement with measured cycles is tracked
as a BENCH artifact line (``static_cycle_rank_corr``).
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from repro_torch.analysis.ir import ChainSummary, lift

__all__ = ["estimate_cycles", "fast_forward_bound", "static_hints",
           "cost_report", "rank_correlation"]


def fast_forward_bound(width: int, height: int) -> int:
    """Mesh-diameter ceiling on any single event-compressed advance.

    The fast-forward engine (:mod:`repro_torch.core.fastforward`) teleports a
    lone in-flight message by its remaining west-first hop distance —
    which can never exceed the mesh diameter ``(width-1) + (height-1)``
    (a Valiant waypoint splits the trip into two legs, each compressed
    separately, so the per-advance bound still holds).  The property
    suite cross-checks every compressed delta against this static bound.
    """
    return max(0, int(width) - 1) + max(0, int(height) - 1)


def estimate_cycles(wl: Any, summary: ChainSummary | None = None) -> float:
    """Lower-bound the lane's completion cycles from static structure."""
    if summary is None:
        summary = lift(wl)
    bounds = [float(summary.critical_path)]
    for arr in (summary.mem_exec, summary.spawns, summary.inject):
        if arr.size:
            bounds.append(float(arr.max()))
    return max(bounds)


def static_hints(workloads: Sequence[Any]) -> list[float]:
    """Per-lane :func:`estimate_cycles`, for planner ``cycle_hints``."""
    return [estimate_cycles(wl) for wl in workloads]


def cost_report(wl: Any) -> dict[str, Any]:
    """Structured cost summary for one lane (lint/CLI consumption)."""
    s = lift(wl)
    return {
        "name": str(getattr(wl, "name", "")),
        "estimate_cycles": estimate_cycles(wl, summary=s),
        "critical_path": int(s.critical_path),
        "hop_volume": int(s.hop_volume),
        "messages": int(s.n_messages),
        "static_ams": int(np.asarray(s.amq_len).sum()),
        "max_pe_mem_ops": int(s.mem_exec.max()) if s.mem_exec.size else 0,
        "max_pe_inject": int(s.inject.max()) if s.inject.size else 0,
        "max_pe_spawns": int(s.spawns.max()) if s.spawns.size else 0,
        "dynamic": bool(s.dynamic),
        "truncated": bool(s.truncated),
    }


def rank_correlation(xs: Sequence[float], ys: Sequence[float]) -> float:
    """Spearman rank correlation (average ranks for ties), no scipy."""
    x = np.asarray(xs, dtype=np.float64)
    y = np.asarray(ys, dtype=np.float64)
    if x.shape != y.shape or x.size < 2:
        return float("nan")

    def ranks(v: np.ndarray) -> np.ndarray:
        order = np.argsort(v, kind="mergesort")
        r = np.empty_like(v)
        r[order] = np.arange(1, v.size + 1, dtype=np.float64)
        # average ranks over ties
        for u in np.unique(v):
            m = v == u
            if m.sum() > 1:
                r[m] = r[m].mean()
        return r

    rx, ry = ranks(x), ranks(y)
    sx, sy = rx.std(), ry.std()
    if sx == 0.0 or sy == 0.0:
        return float("nan")
    return float(((rx - rx.mean()) * (ry - ry.mean())).mean() / (sx * sy))
