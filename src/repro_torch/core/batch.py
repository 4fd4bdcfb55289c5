"""Batch padding / stacking helpers for :func:`repro_torch.core.machine.run_many`.

A copy of the reference's ``repro.core.batch``: the padding helpers and
the packing, wave and shard planners.

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

Sub-mesh lane packing
---------------------
Padding every lane's PE axis to the batch maximum makes small lanes pay
for PEs they never use: a 2x2 lane in a batch with an 8x8 lane steps 64
PE rows per cycle for 4 PEs of work.  :func:`plan_packing` +
:func:`pack_workloads` remove that dead cost by co-scheduling several
small lanes as **disjoint rectangular sub-meshes of one super-lane**:

  * the planner is a deterministic 2-D shelf packer (first-fit decreasing
    height, with column stacking inside shelves — the guillotine split)
    over the lane geometries; lanes that do not fit the super mesh fall
    back to a dedicated lane of their own native geometry;
  * :func:`pack_workloads` rebases every packed workload into its
    rectangle: PE ids in AM destination fields and compiler-placed
    metadata (``CompiledWorkload.meta_pe``) are remapped through the
    rectangle's coordinate shift, and each sub-lane's program rows are
    concatenated with rebased PC offsets so co-tenants keep their own
    config memories.

Isolation needs no new mechanism: west-first minimal routing keeps every
message inside the src->dst bounding box, which lies inside the sub-mesh
rectangle, so disjoint rectangles never share a link, a buffer or a
credit that matters.  The engine only needs per-sub-lane *accounting*
(idle detection, cycle freeze, stats) — carried by the ``sub_ids`` /
``local_ids`` per-PE vectors this module emits (see
:mod:`repro_torch.core.machine`).

Multi-device lane sharding
--------------------------
Lanes are embarrassingly parallel, so the reference's ``run_many(...,
shard=True)`` splits the lane axis over its devices; the port runs
``shard=True`` on one device (the plain engine) and does not split the
lane axis over several yet (ROADMAP.md, Queue 1), but keeps the planner.
:func:`plan_shards` balances lanes across devices by the same runtime
estimate the wave planner uses (:func:`shard_loads`: mesh area without
an oracle, measured ``cycle_hints`` with one) and pads the batch to a
multiple of the device count with *inert* lanes (an empty 1x1 workload
is idle at cycle 0), so every shard carries the same ``(B/D, P, Q, M,
N)`` shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.am import (
    F_DST0, F_DST1, F_DST2, F_PC, F_VALID, C_NEXT_PC,
)

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
    sub_ids: np.ndarray | None = None    # (B, N) sub-lane slot per PE
                                         # (packed batches only)
    local_ids: np.ndarray | None = None  # (B, N) PE id within the
                                         # sub-mesh (packed batches only)
    plan: "PackPlan | None" = None       # how to un-pack per-lane results

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


# ----------------------------------------------------------------------------
# Sub-mesh lane packing
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SubLane:
    """One lane's rectangle inside a super-lane's mesh."""

    lane: int                  # index into the original workload sequence
    super_lane: int            # output lane hosting this sub-mesh
    origin: tuple[int, int]    # (x, y) of the rectangle's NW corner
    geom: tuple[int, int]      # (width, height) of the sub-mesh

    def pe_ids(self, super_width: int) -> np.ndarray:
        """Super-mesh PE ids of the rectangle, in the sub-mesh's own
        row-major order (index k is the sub-mesh's local PE k)."""
        ox, oy = self.origin
        w, h = self.geom
        return (((oy + np.arange(h))[:, None] * super_width
                 + ox + np.arange(w)[None, :]).ravel().astype(np.int64))


@dataclasses.dataclass(frozen=True)
class PackPlan:
    """Where every input lane lives in the packed batch.

    ``placements[i]`` is input lane ``i``'s rectangle; ``super_geoms[s]``
    is output lane ``s``'s mesh (the shared packing mesh for co-tenanted
    supers, a lane's own geometry for fallback solo lanes).
    """

    super_geoms: tuple[tuple[int, int], ...]
    placements: tuple[SubLane, ...]

    @property
    def n_supers(self) -> int:
        return len(self.super_geoms)

    @property
    def n_lanes(self) -> int:
        return len(self.placements)

    def lanes_of(self, super_lane: int) -> list[SubLane]:
        return [p for p in self.placements if p.super_lane == super_lane]

    def occupied_pes(self) -> int:
        return sum(p.geom[0] * p.geom[1] for p in self.placements)

    def efficiency(self) -> float:
        """Occupied / padded PE fraction of the packed batch: every output
        lane's PE axis pads to the batch maximum, so the denominator is
        ``n_supers * max(super area)``.  1.0 = no dead PE rows stepped."""
        n_max = max(w * h for (w, h) in self.super_geoms)
        return self.occupied_pes() / float(self.n_supers * n_max)


def unpacked_efficiency(geoms) -> float:
    """Occupied/padded PE fraction of the plain (one lane per workload)
    batch — the baseline :func:`PackPlan.efficiency` is gated against."""
    areas = [int(w) * int(h) for (w, h) in geoms]
    return sum(areas) / float(len(areas) * max(areas))


def plan_packing(geoms, *, super_geom=None, groups=None) -> PackPlan:
    """Deterministic 2-D shelf/guillotine packing of lane meshes.

    Args:
      geoms: sequence of per-lane ``(width, height)`` pairs.
      super_geom: the shared packing mesh; defaults to
        ``(max width, max height)`` over the lanes, so the largest lane
        fits exactly and the padded PE axis never grows past what the
        unpacked batch would have used.
      groups: optional per-lane hashable keys; only lanes with equal keys
        may share a super-lane (used to keep fabric modes per-lane:
        co-tenants share the engine's per-lane mode word).

    Placement is first-fit decreasing height onto shelves, with column
    stacking inside each shelf (a short lane opens a column under the
    shelf ceiling and later equally-narrow lanes stack into it — the
    guillotine split that keeps e.g. two 2x2s inside a height-4 shelf).
    Lanes wider or taller than ``super_geom`` fall back to a dedicated
    super-lane of their own native geometry.  The plan is a pure function
    of the arguments (stable sort, first fit): every lane is placed
    exactly once and no two rectangles of a super-lane overlap
    (tests/test_lane_packing.py holds these invariants under hypothesis).
    """
    geoms = [(int(w), int(h)) for (w, h) in geoms]
    if not geoms:
        raise ValueError("empty geometry list")
    if super_geom is None:
        super_geom = (max(w for w, _ in geoms), max(h for _, h in geoms))
    sw, sh = int(super_geom[0]), int(super_geom[1])
    if sw < 1 or sh < 1:
        raise ValueError(f"bad super geometry {super_geom}")
    group_list = [None] * len(geoms) if groups is None else list(groups)
    if len(group_list) != len(geoms):
        raise ValueError(f"{len(group_list)} groups for {len(geoms)} lanes")
    # group rank by first appearance keeps the plan independent of key
    # types (modes may be ints, names, None) yet fully deterministic.
    rank: dict = {}
    for g in group_list:
        rank.setdefault(g, len(rank))

    order = sorted(
        range(len(geoms)),
        key=lambda i: (rank[group_list[i]], -geoms[i][1], -geoms[i][0], i))

    # super-lane build state: list of dicts
    #   {group, shelves: [{y, h, x_used, cols: [{x, w, y_used}]}], y_used}
    supers: list[dict] = []
    super_geoms: list[tuple[int, int]] = []
    placements: list[SubLane | None] = [None] * len(geoms)

    def place(i: int, s: int, x: int, y: int) -> None:
        placements[i] = SubLane(lane=i, super_lane=s, origin=(x, y),
                                geom=geoms[i])

    for i in order:
        w, h = geoms[i]
        if w < 1 or h < 1:
            raise ValueError(f"lane {i}: bad geometry {(w, h)}")
        if w > sw or h > sh:
            # fallback: oversized lane gets its own super of native shape
            super_geoms.append((w, h))
            supers.append(dict(group=object(), shelves=[], y_used=sh + 1))
            place(i, len(supers) - 1, 0, 0)
            continue
        done = False
        for s, sup in enumerate(supers):
            if sup["group"] != group_list[i]:
                continue
            for shelf in sup["shelves"]:
                # stack into an existing column of sufficient width/room
                for col in shelf["cols"]:
                    if w <= col["w"] and col["y_used"] + h <= shelf["h"]:
                        place(i, s, col["x"], shelf["y"] + col["y_used"])
                        col["y_used"] += h
                        done = True
                        break
                if done:
                    break
                # open a new column on this shelf
                if h <= shelf["h"] and shelf["x_used"] + w <= sw:
                    shelf["cols"].append(dict(x=shelf["x_used"], w=w,
                                              y_used=h))
                    place(i, s, shelf["x_used"], shelf["y"])
                    shelf["x_used"] += w
                    done = True
                    break
            if done:
                break
            # open a new shelf in this super
            if sup["y_used"] + h <= sh:
                shelf = dict(y=sup["y_used"], h=h, x_used=w,
                             cols=[dict(x=0, w=w, y_used=h)])
                sup["shelves"].append(shelf)
                place(i, s, 0, sup["y_used"])
                sup["y_used"] += h
                done = True
            if done:
                break
        if not done:
            # open a new super-lane
            super_geoms.append((sw, sh))
            supers.append(dict(
                group=group_list[i], y_used=h,
                shelves=[dict(y=0, h=h, x_used=w,
                              cols=[dict(x=0, w=w, y_used=h)])]))
            place(i, len(supers) - 1, 0, 0)
    return PackPlan(super_geoms=tuple(super_geoms),
                    placements=tuple(placements))  # type: ignore[arg-type]


class RectPool:
    """Incremental free-rectangle allocator over ONE super mesh.

    The batch-mode planner (:func:`plan_packing`) places a *closed* lane
    set once; the sweep service instead needs mid-wave refill — a
    retired sub-lane's rectangle must become allocatable again while its
    co-tenants keep running.  This is the free-list that supports it:
    guillotine allocation (place at the candidate rect's NW corner,
    split the L-shaped remainder) with greedy edge-merging on release.

    Invariants (held by construction, pinned in tests):

    * free rectangles are pairwise disjoint and inside the mesh;
    * allocated rectangles are pairwise disjoint and disjoint from every
      free rectangle;
    * releasing the last allocation restores the single full-mesh free
      rectangle, so an emptied super always re-admits any lane that fits
      the mesh (fragmentation cannot outlive the tenants that caused it).

    ``alloc`` is best-area-fit (smallest free rect that holds the lane)
    and deterministic; it returns ``None`` — rather than raising — when
    nothing fits, because "stay pending until a co-tenant retires" is
    the caller's normal flow, not an error.
    """

    def __init__(self, geom):
        w, h = int(geom[0]), int(geom[1])
        if w < 1 or h < 1:
            raise ValueError(f"bad pool geometry {geom}")
        self.geom = (w, h)
        self.free: list[tuple[int, int, int, int]] = [(0, 0, w, h)]
        self._allocated: dict[tuple[int, int], tuple[int, int]] = {}

    def alloc(self, geom) -> tuple[int, int] | None:
        """Reserve a ``(width, height)`` rectangle; returns its ``(x, y)``
        NW origin, or None when no free rectangle holds it."""
        w, h = int(geom[0]), int(geom[1])
        if w < 1 or h < 1:
            raise ValueError(f"bad lane geometry {geom}")
        fits = [(fw * fh, fx, fy, k)
                for k, (fx, fy, fw, fh) in enumerate(self.free)
                if w <= fw and h <= fh]
        if not fits:
            return None
        _, _, _, k = min(fits)
        fx, fy, fw, fh = self.free.pop(k)
        # guillotine split of the L-shaped remainder: cut along the
        # longer leftover axis so the bigger piece stays one rectangle
        if fw - w >= fh - h:
            pieces = [(fx + w, fy, fw - w, fh), (fx, fy + h, w, fh - h)]
        else:
            pieces = [(fx + w, fy, fw - w, h), (fx, fy + h, fw, fh - h)]
        self.free.extend(p for p in pieces if p[2] > 0 and p[3] > 0)
        self._merge()
        self._allocated[(fx, fy)] = (w, h)
        return (fx, fy)

    def release(self, origin, geom) -> None:
        """Return a previously-allocated rectangle to the pool."""
        x, y = int(origin[0]), int(origin[1])
        w, h = int(geom[0]), int(geom[1])
        if self._allocated.get((x, y)) != (w, h):
            # reject WITHOUT mutating: a mismatched geometry must not
            # silently drop the live allocation it collided with
            raise ValueError(f"release of unallocated rect "
                             f"{(x, y, w, h)}")
        del self._allocated[(x, y)]
        if not self._allocated:
            # emptied: collapse whatever fragmentation the tenant mix
            # left behind (pairwise merging alone cannot always undo an
            # interleaved release order)
            self.free = [(0, 0) + self.geom]
            return
        self.free.append((x, y, w, h))
        self._merge()

    def _merge(self) -> None:
        # greedy pairwise merge of free rects sharing a full edge;
        # O(n^3) worst case on a handful of rects — irrelevant next to a
        # single engine chunk
        merged = True
        while merged:
            merged = False
            self.free.sort()
            for i in range(len(self.free)):
                ax, ay, aw, ah = self.free[i]
                for j in range(i + 1, len(self.free)):
                    bx, by, bw, bh = self.free[j]
                    if ay == by and ah == bh and ax + aw == bx:
                        self.free[i] = (ax, ay, aw + bw, ah)
                    elif ax == bx and aw == bw and ay + ah == by:
                        self.free[i] = (ax, ay, aw, ah + bh)
                    else:
                        continue
                    self.free.pop(j)
                    merged = True
                    break
                if merged:
                    break

    @property
    def n_allocated(self) -> int:
        return len(self._allocated)

    def used_area(self) -> int:
        return sum(w * h for (w, h) in self._allocated.values())

    def free_area(self) -> int:
        return sum(w * h for (_, _, w, h) in self.free)


def _rebase_into_super(wl, sub: SubLane, super_width: int, n_super: int,
                       pc_off: int):
    """Relocate one compiled workload into its sub-mesh rectangle.

    Returns ``(static_ams, amq_len, mem_val, mem_meta)`` arrays on the
    ``n_super``-PE axis with every PE reference remapped through the
    rectangle's coordinate shift and every program counter offset by
    ``pc_off`` (the sub-lane's slice of the concatenated super program).
    """
    ids = sub.pe_ids(super_width)                       # solo pe -> super pe
    remap = np.asarray(ids, np.int32)
    n_lane = remap.shape[0]
    ams = np.array(wl.static_ams, np.int32, copy=True)
    if ams.shape[0] != n_lane:
        raise ValueError(
            f"lane {sub.lane}: compiled for {ams.shape[0]} PEs but placed "
            f"as a {sub.geom[0]}x{sub.geom[1]} sub-mesh ({n_lane} PEs)")
    valid = ams[..., F_VALID] == 1
    for f in (F_DST0, F_DST1, F_DST2):
        d = ams[..., f]
        if (valid & (d >= n_lane)).any():
            raise ValueError(
                f"lane {sub.lane}: AM destination PE id out of range "
                f"(>= {n_lane}); workload inconsistent with its geometry")
        ams[..., f] = np.where(valid & (d >= 0),
                               remap[np.clip(d, 0, n_lane - 1)], d)
    ams[..., F_PC] = np.where(valid, ams[..., F_PC] + pc_off,
                              ams[..., F_PC])

    q = ams.shape[1]
    sup_ams = np.zeros((n_super, q, ams.shape[2]), np.int32)
    sup_ams[ids] = ams
    sup_alen = np.zeros((n_super,), np.int32)
    sup_alen[ids] = np.asarray(wl.amq_len, np.int32)

    m = wl.mem_val.shape[1]
    sup_val = np.zeros((n_super, m), np.int32)
    sup_val[ids] = np.asarray(wl.mem_val, np.int32)
    meta = np.array(wl.mem_meta, np.int32, copy=True)
    meta_pe = getattr(wl, "meta_pe", None)
    if meta_pe is not None:
        tgt = meta[..., 1]
        meta[..., 1] = np.where(
            np.asarray(meta_pe, bool),
            remap[np.clip(tgt, 0, n_lane - 1)], tgt)
    sup_meta = np.zeros((n_super, m, 2), np.int32)
    sup_meta[ids] = meta
    return sup_ams, sup_alen, sup_val, sup_meta


def _lane_geoms(workloads) -> list[tuple[int, int]]:
    """Per-lane (width, height) from compiled workloads; packing cannot
    place a lane that does not know its mesh."""
    geoms = []
    for i, wl in enumerate(workloads):
        g = getattr(wl, "geom", None)
        if g is None:
            raise ValueError(
                f"lane {i} carries no geometry; packing needs compiled "
                "workloads (repro_torch.core.compiler records wl.geom)")
        geoms.append((int(g[0]), int(g[1])))
    return geoms


def _resolve_modes(modes, n: int) -> list[int] | None:
    if modes is None:
        return None
    from repro_torch.core.machine import resolve_mode
    out = [resolve_mode(m_) for m_ in modes]
    if len(out) != n:
        raise ValueError(f"{len(out)} modes for {n} workloads")
    return out


def pack_workloads(workloads, modes=None, *, super_geom=None
                   ) -> BatchedWorkloads:
    """Stack compiled workloads with sub-mesh lane packing.

    Like :func:`stack_workloads`, but lanes are first bin-packed into
    disjoint rectangles of shared super-lanes (:func:`plan_packing`), and
    each workload's arrays are rebased into its rectangle
    (:func:`_rebase_into_super`).  Programs of co-tenants are
    concatenated with per-sub-lane PC offsets.  The result carries
    ``sub_ids`` / ``local_ids`` per-PE vectors (the engine's sub-lane
    accounting) and the :class:`PackPlan` (``plan``) used to un-pack
    per-lane results back into input order.

    ``modes`` (names/bitmasks, one per workload) both selects each lane's
    fabric mode and constrains packing: only same-mode lanes co-tenant a
    super-lane (the engine's mode word is per-lane).
    """
    wls = list(workloads)
    if not wls:
        raise ValueError("empty workload batch")
    geoms = _lane_geoms(wls)
    mode_list = _resolve_modes(modes, len(wls))
    mode_arr = (None if mode_list is None
                else np.asarray(mode_list, np.int32))

    plan = plan_packing(geoms, super_geom=super_geom, groups=mode_list)

    n_max = max(w * h for (w, h) in plan.super_geoms)
    rows, sub_ids, local_ids, super_modes = [], [], [], []
    for s, (sw, sh) in enumerate(plan.super_geoms):
        subs = plan.lanes_of(s)
        n_super = sw * sh
        # concatenated super program: each sub-lane's rows at its offset
        pc_offs, p_total = [], 0
        for sub in subs:
            pc_offs.append(p_total)
            p_total += wls[sub.lane].prog.shape[0]
        prog = np.zeros((max(p_total, 1), wls[subs[0].lane].prog.shape[1]),
                        np.int32)
        sid = np.zeros((n_max,), np.int32)
        lid = np.zeros((n_max,), np.int32)
        parts = []
        for k, (sub, off) in enumerate(zip(subs, pc_offs)):
            wl = wls[sub.lane]
            p = np.array(wl.prog, np.int32, copy=True)
            p[:, C_NEXT_PC] += off
            prog[off:off + p.shape[0]] = p
            parts.append(_rebase_into_super(wl, sub, sw, n_super, off))
            ids = sub.pe_ids(sw)
            sid[ids] = k
            lid[ids] = np.arange(ids.shape[0], dtype=np.int32)
        if mode_arr is not None:
            # co-tenants were grouped by mode, so one word covers them all
            super_modes.append(int(mode_arr[subs[0].lane]))
        q = max(a.shape[1] for a, _, _, _ in parts)
        m = max(v.shape[1] for _, _, v, _ in parts)
        ams = np.zeros((n_super, q, parts[0][0].shape[2]), np.int32)
        alen = np.zeros((n_super,), np.int32)
        val = np.zeros((n_super, m), np.int32)
        meta = np.zeros((n_super, m, 2), np.int32)
        for a, al, v, mt in parts:
            ams[:, :a.shape[1]] += a
            alen += al
            val[:, :v.shape[1]] += v
            meta[:, :mt.shape[1]] += mt
        rows.append((prog, ams, alen, val, meta))
        sub_ids.append(sid)
        local_ids.append(lid)

    stacked = stack_workloads(
        rows, geoms=list(plan.super_geoms))
    return dataclasses.replace(
        stacked,
        modes=(np.asarray(super_modes, np.int32)
               if mode_arr is not None else None),
        sub_ids=np.stack(sub_ids),
        local_ids=np.stack(local_ids),
        plan=plan,
    )


def validate_hints(cycle_hints, n_lanes: int) -> list[float]:
    """Coerce + validate a ``cycle_hints`` sequence (the measured
    per-lane runtime oracle): one non-negative number per lane.  The
    single checkpoint for every path that accepts hints, so a malformed
    list fails identically whether or not the planner that would
    consume it ends up running."""
    import math
    hints = [float(h) for h in cycle_hints]
    if len(hints) != n_lanes:
        raise ValueError(f"{len(hints)} cycle hints for {n_lanes} lanes")
    if any(h < 0 or not math.isfinite(h) for h in hints):
        raise ValueError("cycle hints must be non-negative finite "
                         "numbers")
    return hints


def shard_loads(geoms, cycle_hints=None) -> list[float]:
    """Per-lane runtime estimate used by the wave and shard planners.

    With ``cycle_hints`` (measured per-lane cycle counts from a prior
    run — the runtime *oracle*) the hint IS the load.  Without one, the
    mesh-area proxy the Fig. 17 regime justifies applies: the same
    problem on a smaller mesh runs longer, so load is the inverse mesh
    area (scaled by the largest lane so the smallest-area lane — the
    longest-running one — gets the largest load).
    """
    geoms = [(int(w), int(h)) for (w, h) in geoms]
    if cycle_hints is not None:
        return validate_hints(cycle_hints, len(geoms))
    a_max = max(w * h for (w, h) in geoms)
    return [a_max / float(w * h) for (w, h) in geoms]


def plan_shards(geoms, n_devices: int, *, cycle_hints=None
                ) -> list[list[int]]:
    """Assign lanes to devices for the sharded engine (lane-axis
    ``shard_map``).

    Every device must carry the SAME number of lanes (shard_map splits
    the lane axis evenly), so the batch is padded up to
    ``ceil(B / n_devices) * n_devices`` with **inert** pad lanes —
    marked ``-1`` in the returned plan; ``run_many`` materializes them
    as empty 1x1 workloads that are idle at cycle 0 and touch no
    statistics.  Real lanes are balanced by :func:`shard_loads` (the
    mesh-area runtime proxy, or measured ``cycle_hints``): a greedy
    longest-first (LPT) assignment under the per-device capacity, kept
    only when its makespan beats the round-robin deal — so the plan is
    never worse-balanced than round-robin, deterministically.

    Returns ``n_devices`` lists of exactly ``ceil(B / n_devices)``
    entries each (lane index or ``-1``); every lane appears exactly
    once, ascending within its device.
    """
    geoms = [(int(w), int(h)) for (w, h) in geoms]
    if not geoms:
        raise ValueError("empty geometry list")
    if n_devices < 1:
        raise ValueError(f"bad device count {n_devices}")
    if cycle_hints is not None:
        cycle_hints = validate_hints(cycle_hints, len(geoms))
    load = shard_loads(geoms, cycle_hints)
    b = len(geoms)
    cap = -(-b // n_devices)                     # lanes per device
    # LPT: longest lane first onto the least-loaded device with room.
    order = sorted(range(b), key=lambda i: (-load[i], i))
    lpt: list[list[int]] = [[] for _ in range(n_devices)]
    tot = [0.0] * n_devices
    for i in order:
        d = min((d for d in range(n_devices) if len(lpt[d]) < cap),
                key=lambda d: (tot[d], d))
        lpt[d].append(i)
        tot[d] += load[i]
    # Round-robin baseline (deal in input order): keep LPT only when it
    # is at least as balanced, so the planner provably never regresses.
    rr = [[i for i in range(b) if i % n_devices == d]
          for d in range(n_devices)]

    def makespan(plan):
        return max(sum(load[i] for i in dev) for dev in plan)

    best = lpt if makespan(lpt) <= makespan(rr) else rr
    return [sorted(dev) + [-1] * (cap - len(dev)) for dev in best]


def plan_waves(geoms, *, super_geom=None, groups=None, cycle_hints=None,
               parallel: int = 1) -> list[list[int]]:
    """Partition lanes into co-scheduling *waves* (device-call batches).

    Each wave holds at most ONE super-lane per group and is packed tight
    by :func:`plan_packing`; waves run sequentially on the same compiled
    engine.  Rationale: the padded engine steps ``B x N_max`` PE rows per
    cycle whether they carry work or not, so the total run cost is
    ``sum over waves of makespan x supers``.  Lanes with similar runtimes
    should share a wave; lanes with dissimilar runtimes should serialize
    (a short lane in a long wave steps dead rows for the difference).
    With no runtime oracle, mesh area is the proxy the Fig. 17 regime
    justifies: the same problem on a smaller mesh runs longer, and
    same-size lanes run comparably.  Lanes are therefore taken longest-
    first by :func:`shard_loads` (area-ascending without hints) and
    first-fit into the earliest wave whose super still has room.
    ``cycle_hints`` (measured per-lane cycles from a prior run) replace
    the area proxy, so a re-planned sweep co-tenants lanes by their
    MEASURED runtimes — dissimilar-runtime same-area lanes stop sharing
    a wave's makespan.

    ``parallel`` widens a wave for the sharded engine: a wave may carry
    up to ``max(parallel, n_groups)`` super-lanes in total — 1 per
    group (the classic rule) on the single-device engine, up to one
    per DEVICE on a D-device schedule.  Rationale: serialization
    exists because co-scheduled supers in ONE device call step the
    wave's max makespan; super-lanes on *different devices* do not
    couple, so up to D dissimilar supers run side by side
    (``plan_shards`` puts them one per device) and the dissimilar-
    runtime waves merge instead of running back to back.  The bound is
    TOTAL supers, not per group — D+1 supers on D devices would
    co-locate two (load-blind, since same-geom supers carry no area
    signal) and re-couple what the wave split exists to separate;
    above-D group counts keep the one-per-group rule, whose co-tenants
    host the same lane set across groups (similar runtimes).

    Returns the list of waves, each a list of lane indices (every lane in
    exactly one wave).
    """
    geoms = [(int(w), int(h)) for (w, h) in geoms]
    parallel = max(1, int(parallel))
    if cycle_hints is not None:
        # Validate up front: the homogeneous shortcut below may never
        # consume the hints, but a malformed list should fail loudly
        # either way (not deep inside a later planner).
        cycle_hints = validate_hints(cycle_hints, len(geoms))
    if super_geom is None:
        super_geom = (max(w for w, _ in geoms), max(h for _, h in geoms))
    group_list = [None] * len(geoms) if groups is None else list(groups)
    if len(set(geoms)) == 1:
        # Homogeneous batch (every lane the same mesh): the area proxy
        # has no relative-runtime signal at all, and serializing gains
        # nothing in PE rows while paying per-wave overhead — so packing
        # degrades to the identity plan: ONE wave, every lane its own
        # (co-tenanted where possible) super-lane, i.e. the plain
        # batched call.  In MIXED batches, by contrast, full-mesh lanes
        # deliberately serialize even against each other: same-area
        # different-workload lanes routinely differ 10-30x in cycles
        # (fig17's three 8x8 lanes: 2565/798/86), and one slow lane in a
        # parallel-super wave makes every co-scheduled super step its
        # makespan.  cycle_hints are the exception: measured runtimes
        # carry the signal area cannot, so hinted same-size lanes split
        # at factor-of-2 runtime boundaries — a lane joins the current
        # (longest-first) wave only while it runs at least half the
        # wave's makespan, so short lanes stop stepping dead rows inside
        # a long wave (cost B*max per wave vs the one-wave B*max).
        # Sharded schedules (parallel > 1) skip the split: plan_shards
        # consumes the same hints to balance lanes across devices, each
        # device terminates at its own shard's makespan, and LPT pairs
        # similar loads — serializing would only add dispatches.
        if cycle_hints is None or parallel > 1:
            return [list(range(len(geoms)))]
        load = shard_loads(geoms, cycle_hints)
        order = sorted(range(len(geoms)), key=lambda i: (-load[i], i))
        waves = []
        for i in order:
            if waves and 2 * load[i] >= max(load[j] for j in waves[-1]):
                waves[-1].append(i)
            else:
                waves.append([i])
        return [sorted(w) for w in waves]
    load = shard_loads(geoms, cycle_hints)
    order = sorted(range(len(geoms)), key=lambda i: (-load[i], i))
    waves: list[list[int]] = []
    for i in order:
        placed = False
        for wave in waves:
            cand = wave + [i]
            plan = plan_packing([geoms[j] for j in cand],
                                super_geom=super_geom,
                                groups=[group_list[j] for j in cand])
            n_groups = len({group_list[j] for j in cand})
            if plan.n_supers <= max(parallel, n_groups) and \
                    all(g == tuple(super_geom) for g in plan.super_geoms):
                wave.append(i)
                placed = True
                break
        if not placed:
            waves.append([i])
    return waves


def _pad_batch(wb: BatchedWorkloads, p: int, q: int, m: int, n: int,
               b: int) -> BatchedWorkloads:
    """Pad one wave's batch to the schedule-wide shapes (so every wave
    reuses ONE compiled engine specialization): program rows to ``p``, AM
    queue depth to ``q``, memory words to ``m``, PE axis to ``n``, and the
    lane axis to ``b`` with inert dummy lanes (a 1x1 mesh with an empty
    workload is idle at cycle 0)."""
    grow = b - wb.batch
    prog = pad_axis(pad_axis(wb.prog, p, 1), b, 0)
    static_ams = pad_axis(pad_axis(pad_axis(wb.static_ams, q, 2), n, 1), b, 0)
    amq_len = pad_axis(pad_axis(wb.amq_len, n, 1), b, 0)
    mem_val = pad_axis(pad_axis(pad_axis(wb.mem_val, m, 2), n, 1), b, 0)
    mem_meta = pad_axis(pad_axis(pad_axis(wb.mem_meta, m, 2), n, 1), b, 0)
    geoms = wb.geoms
    if geoms is not None and grow:
        geoms = np.concatenate(
            [geoms, np.ones((grow, 2), np.int32)])
    modes = wb.modes
    if modes is not None and grow:
        modes = np.concatenate([modes, np.zeros((grow,), np.int32)])
    sub_ids = (pad_axis(pad_axis(wb.sub_ids, n, 1), b, 0)
               if wb.sub_ids is not None else None)
    local_ids = (pad_axis(pad_axis(wb.local_ids, n, 1), b, 0)
                 if wb.local_ids is not None else None)
    return dataclasses.replace(
        wb, prog=prog, static_ams=static_ams, amq_len=amq_len,
        mem_val=mem_val, mem_meta=mem_meta, geoms=geoms, modes=modes,
        sub_ids=sub_ids, local_ids=local_ids)


def static_cycle_hints(workloads, geoms=None, *,
                       homogeneous: bool = False) -> list[float] | None:
    """Default ``cycle_hints`` from the static cost model
    (:func:`repro_torch.analysis.estimate_cycles`), replacing the
    inverse-mesh-area proxy as the planners' load signal.

    Returns None — fall back to the proxy — when the signal is
    unavailable (non-compiled lanes without liftable arrays) or useless
    (homogeneous batches keep the wave planner's identity one-wave plan
    unless ``homogeneous=True``, which shard balancing sets: LPT over
    per-lane estimates beats a uniform proxy even on same-size lanes).
    Hints only reorder scheduling — never lane results — so any
    analysis failure degrades to the proxy instead of failing the run.
    """
    wls = list(workloads)
    if not wls:
        return None
    if not homogeneous:
        if geoms is None:
            geoms = [getattr(wl, "geom", None) for wl in wls]
            if any(g is None for g in geoms):
                return None
        if len({(int(w), int(h)) for (w, h) in geoms}) <= 1:
            return None
    needed = ("prog", "static_ams", "amq_len", "mem_val", "mem_meta")
    if not all(all(hasattr(wl, a) for a in needed) for wl in wls):
        return None
    try:
        from repro_torch.analysis import static_hints
        return static_hints(wls)
    except Exception:
        return None


def pack_schedule(workloads, modes=None, *, super_geom=None,
                  cycle_hints=None, parallel: int = 1):
    """Plan + pack the full co-schedule for ``run_many(pack=True)``.

    Returns ``(batches, lane_maps, stats)``: one packed
    :class:`BatchedWorkloads` per wave (all padded to identical shapes,
    so the whole schedule shares one compiled engine), the input-lane
    indices behind each wave's plan entries, and a ``stats`` dict
    (``n_waves`` / ``n_super_lanes`` / ``packing_efficiency`` /
    ``unpacked_efficiency``).  ``packing_efficiency`` is the occupied
    fraction of all PE rows the schedule steps (1.0 = no dead rows);
    ``unpacked_efficiency`` is the same figure for the plain one-lane-
    per-workload batch the packer replaces.  ``cycle_hints`` (measured
    per-input-lane cycles from a prior run) replace the mesh-area
    runtime proxy in the wave planner; ``parallel`` (the sharded
    engine's device count) lets a wave carry that many super-lanes per
    group, since supers on different devices do not couple makespans.
    """
    wls = list(workloads)
    geoms = _lane_geoms(wls)
    mode_list = _resolve_modes(modes, len(wls))
    if super_geom is None:
        super_geom = (max(w for w, _ in geoms), max(h for _, h in geoms))
    if cycle_hints is None:
        cycle_hints = static_cycle_hints(wls, geoms)
    waves = plan_waves(geoms, super_geom=super_geom, groups=mode_list,
                       cycle_hints=cycle_hints, parallel=parallel)
    batches = [
        pack_workloads([wls[i] for i in wave],
                       modes=None if mode_list is None
                       else [mode_list[i] for i in wave],
                       super_geom=super_geom)
        for wave in waves
    ]
    p = max(wb.prog.shape[1] for wb in batches)
    q = max(wb.static_ams.shape[2] for wb in batches)
    m = max(wb.mem_words for wb in batches)
    n = max(wb.n_pes for wb in batches)
    b = max(wb.batch for wb in batches)
    batches = [_pad_batch(wb, p, q, m, n, b) for wb in batches]
    occupied = sum(w_ * h_ for (w_, h_) in geoms)
    stats = dict(
        n_waves=len(waves),
        n_super_lanes=len(batches) * b,
        packing_efficiency=occupied / float(len(batches) * b * n),
        unpacked_efficiency=unpacked_efficiency(geoms),
        plan=[  # JSON-serializable schedule description (for logs)
            dict(super_geom=list(super_geom),
                 lanes=[dict(lane=int(wave[p.lane]),
                             super_lane=int(p.super_lane),
                             origin=list(p.origin), geom=list(p.geom))
                        for p in wb.plan.placements])
            for wb, wave in zip(batches, waves)
        ],
    )
    return batches, waves, stats
