"""Batch padding / stacking helpers for :func:`repro_torch.core.machine.run_many`.

A copy of the padding part of the reference's ``repro.core.batch``.

The paper's headline results are design-space sweeps (Figs. 11–17): many
workload / configuration points, possibly on *different* fabric sizes.  To
evaluate B compiled workloads in one batched device call their
arrays must share shapes, so this module pads each lane to the common
maximum:

  * ``prog``       -> (B, P, CFG_F); zero (= NOP) rows appended, and P is
    rounded up to a multiple of :data:`PROG_BUCKET` so different programs
    land on the same compiled engine shape.
  * ``static_ams`` -> (B, N, Q, MSG_F); entries beyond ``amq_len`` are
    never injected, and PEs beyond a lane's own mesh are inactive (all
    their queues/buffers stay zero — see traced geometry in
    :mod:`repro_torch.core.machine`).
  * ``mem_val`` / ``mem_meta`` -> (B, N, M, ...); words beyond a lane's
    compiled ``mem_words`` are never addressed (the compiler's bump
    allocator raises before emitting an out-of-range address).

Padding is therefore semantically inert: a padded lane steps through
exactly the same per-cycle transitions as its solo run, so batched metrics
are bit-identical to sequential ones (asserted for the reference in
tests/test_batch.py and tests/test_traced_geometry.py).

Besides the workload arrays a batch may carry:

  * a per-lane **fabric mode** vector (``modes``, (B,) int32 bitmasks —
    see :data:`repro_torch.core.machine.FABRIC_MODES`), and
  * a per-lane **mesh geometry** matrix (``geoms``, (B, 2) int32
    ``(width, height)`` rows).

Both are runtime data to the compiled engine, so one batch can mix Nexus /
TIA / TIA-Valiant lanes across 2x2 … 8x8 meshes and still run in a single
device call on a single compiled engine.  Compiled workloads record the
geometry they were placed for (``CompiledWorkload.geom``), so stacking a
mixed-size sequence needs no extra arguments.

Sub-mesh lane packing and multi-device lane sharding (the reference's
planners) are not ported yet; see ROADMAP.md.
"""
from __future__ import annotations

import dataclasses

import numpy as np


# Programs are tiny (a handful of config rows); bucketing their padded
# length keeps every workload on one jit specialization per fabric config.
PROG_BUCKET = 8


@dataclasses.dataclass
class BatchedWorkloads:
    """B workloads padded to common shapes, ready for ``run_many``."""

    prog: np.ndarray        # (B, P, CFG_F)
    static_ams: np.ndarray  # (B, N, Q, MSG_F)
    amq_len: np.ndarray     # (B, N)
    mem_val: np.ndarray     # (B, N, M)
    mem_meta: np.ndarray    # (B, N, M, 2)
    modes: np.ndarray | None = None  # (B,) fabric-mode bitmasks, or None
                                     # (= every lane runs the cfg default)
    geoms: np.ndarray | None = None  # (B, 2) per-lane (width, height), or
                                     # None (= every lane on the cfg mesh)

    @property
    def batch(self) -> int:
        return self.prog.shape[0]

    @property
    def n_pes(self) -> int:
        """The padded PE-axis length (``N_max``, >= every lane's mesh)."""
        return self.static_ams.shape[1]

    @property
    def mem_words(self) -> int:
        return self.mem_val.shape[2]


def pad_axis(a: np.ndarray, size: int, axis: int) -> np.ndarray:
    """Zero-pad ``a`` up to ``size`` along ``axis`` (no-op when already
    there)."""
    grow = size - a.shape[axis]
    if grow < 0:
        raise ValueError(f"cannot shrink axis {axis}: {a.shape[axis]} -> "
                         f"{size}")
    if grow == 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, grow)
    return np.pad(a, widths)


def bucket(n: int, step: int = PROG_BUCKET) -> int:
    """Round ``n`` up to a multiple of ``step`` (minimum one bucket)."""
    return max(step, -(-n // step) * step)


def stack_workloads(workloads, modes=None, geoms=None) -> BatchedWorkloads:
    """Stack compiled workloads into one padded batch.

    Accepts anything with ``prog`` / ``static_ams`` / ``amq_len`` /
    ``mem_val`` / ``mem_meta`` attributes (e.g.
    :class:`repro_torch.core.compiler.CompiledWorkload`) or bare 5-tuples in that
    order.

    ``modes`` optionally assigns each lane a fabric mode — a sequence of
    :data:`repro_torch.core.machine.FABRIC_MODES` names and/or mode bitmasks,
    one per workload — carried on the batch for ``run_many``.

    ``geoms`` optionally assigns each lane its mesh geometry as a
    ``(width, height)`` pair.  When omitted, each workload's own recorded
    ``geom`` attribute is used (compiled workloads know the mesh they were
    placed for); lanes then may mix fabric sizes freely and every PE axis
    is padded to the batch maximum.  Bare tuples carry no geometry, so a
    tuple-only batch must target ONE fabric size (the run config's mesh).
    """
    rows, wl_geoms = [], []
    for wl in workloads:
        if hasattr(wl, "prog"):
            rows.append((wl.prog, wl.static_ams, wl.amq_len,
                         wl.mem_val, wl.mem_meta))
            wl_geoms.append(getattr(wl, "geom", None))
        else:
            rows.append(tuple(wl))
            wl_geoms.append(None)
    if not rows:
        raise ValueError("empty workload batch")

    mode_arr = None
    if modes is not None:
        from repro_torch.core.machine import resolve_mode
        mode_arr = np.asarray([resolve_mode(m_) for m_ in modes], np.int32)
        if mode_arr.shape[0] != len(rows):
            raise ValueError(f"{mode_arr.shape[0]} modes for {len(rows)} "
                             "workloads")

    n_max = max(r[1].shape[0] for r in rows)
    if geoms is not None:
        geom_arr = np.asarray([(int(g[0]), int(g[1])) for g in geoms],
                              np.int32)
        if geom_arr.shape[0] != len(rows):
            raise ValueError(f"{geom_arr.shape[0]} geoms for {len(rows)} "
                             "workloads")
    elif all(g is not None for g in wl_geoms):
        geom_arr = np.asarray(wl_geoms, np.int32)
    else:
        # no per-lane geometry: require one fabric size across the batch
        # (run_many then uses the run config's mesh for every lane).
        for i, r in enumerate(rows):
            if r[1].shape[0] != n_max:
                raise ValueError(
                    f"lane {i} compiled for {r[1].shape[0]} PEs, another "
                    f"for {n_max}: fabric sizes must match unless every "
                    "lane carries a geometry (compile via "
                    "repro_torch.core.compiler, which records wl.geom, or pass "
                    "geoms=)")
        geom_arr = None
    if geom_arr is not None:
        for i, r in enumerate(rows):
            n_lane = int(geom_arr[i, 0] * geom_arr[i, 1])
            if n_lane < r[1].shape[0]:
                raise ValueError(
                    f"lane {i}: geometry {tuple(geom_arr[i])} has {n_lane} "
                    f"PEs but the workload was compiled for "
                    f"{r[1].shape[0]} (placement would target inactive "
                    "PEs)")
        n_max = max(n_max, int((geom_arr[:, 0] * geom_arr[:, 1]).max()))

    p = bucket(max(r[0].shape[0] for r in rows))
    q = max(r[1].shape[1] for r in rows)
    m = max(r[3].shape[1] for r in rows)
    return BatchedWorkloads(
        prog=np.stack([pad_axis(np.asarray(r[0], np.int32), p, 0)
                       for r in rows]),
        static_ams=np.stack(
            [pad_axis(pad_axis(np.asarray(r[1], np.int32), q, 1), n_max, 0)
             for r in rows]),
        amq_len=np.stack([pad_axis(np.asarray(r[2], np.int32), n_max, 0)
                          for r in rows]),
        mem_val=np.stack(
            [pad_axis(pad_axis(np.asarray(r[3], np.int32), m, 1), n_max, 0)
             for r in rows]),
        mem_meta=np.stack(
            [pad_axis(pad_axis(np.asarray(r[4], np.int32), m, 1), n_max, 0)
             for r in rows]),
        modes=mode_arr,
        geoms=geom_arr,
    )
