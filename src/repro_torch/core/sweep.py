"""Structured sweep surface: :class:`SweepRequest` in, :class:`SweepReport`
out — a port of the reference's ``repro.core.sweep``.

* :class:`SweepRequest` — a frozen dataclass naming everything a sweep
  needs (workloads, per-lane modes / geoms / cycle hints / deadlines,
  packing and sharding switches, the validation tier), with exactly the
  reference's fields.
* :class:`SweepReport` — the lane :class:`~repro_torch.core.machine.RunResult`
  list plus the packing (:class:`PackStats`), sharding
  (:class:`ShardStats`) and engine (:class:`EngineTelemetry`) records as
  typed fields.  Iterates and indexes like the result list.
* :func:`sweep` — the entry point, ``sweep(cfg, request, *,
  device="cuda")``.  It calls the same implementation as ``run_many``
  (:func:`repro_torch.core.machine._run_many_impl`), so the two give the
  same bits.

``shard=True`` is not ported yet (ROADMAP.md, Queue 1 item 6) and raises
:class:`NotImplementedError`.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import machine
from repro_torch.core.machine import MachineConfig, RunResult


@dataclasses.dataclass(frozen=True)
class SweepRequest:
    """One batched design-space sweep, declaratively.

    Attributes mirror :func:`repro_torch.core.machine._run_many_impl`'s
    contract (see its docstring for full semantics):

    * ``workloads`` — compiled workloads (anything with ``prog`` /
      ``static_ams`` / ``amq_len`` / ``mem_val`` / ``mem_meta``), or an
      already-stacked :class:`repro_torch.core.batch.BatchedWorkloads`.
    * ``modes`` / ``geoms`` / ``cycle_hints`` — optional per-lane mode
      names or bitmasks, ``(width, height)`` meshes, and measured-cycle
      runtime hints.
    * ``deadlines`` — optional per-lane cycle deadlines (None entries =
      unbounded).  A deadlined lane makes no state transition past its
      bound: it reports ``completed=False`` frozen exactly at the
      deadline while every other lane (co-tenant sub-lanes included)
      runs to completion — the runaway-lane watchdog of the batched
      surface.
    * ``pack`` / ``super_geom`` — sub-mesh lane packing into shared
      super-lanes (``geoms`` must then be None: the packer places lanes).
    * ``shard`` — lane-axis sharding over several cards (not ported
      yet: the sweep raises :class:`NotImplementedError`).
    * ``chunk`` — engine ticks between the engine's idle checks.
    * ``validate`` — pre-dispatch static verification tier
      (:mod:`repro_torch.analysis`): ``"static"`` (default) rejects lanes with
      error-severity findings (malformed AMs, co-tenancy escapes,
      provable capacity violations) with a
      :class:`~repro_torch.analysis.WorkloadValidationError`; ``"strict"``
      also fails on warnings; ``"off"`` dispatches unchecked.

    Sequences are frozen to tuples on construction so a request is an
    immutable value: submitting it twice (or to the sweep service and
    the blocking path) runs the same sweep.
    """
    workloads: tuple
    modes: tuple | None = None
    geoms: tuple | None = None
    cycle_hints: tuple | None = None
    pack: bool = False
    super_geom: tuple | None = None
    shard: bool = False
    chunk: int = 512
    validate: str = "static"
    deadlines: tuple | None = None

    def __post_init__(self):
        from repro_torch.core.batch import BatchedWorkloads
        if not isinstance(self.workloads, BatchedWorkloads):
            wls = tuple(self.workloads)
            if not wls:
                raise ValueError("SweepRequest needs at least one workload")
            object.__setattr__(self, "workloads", wls)
        for f in ("modes", "geoms", "cycle_hints", "deadlines"):
            v = getattr(self, f)
            if v is not None:
                object.__setattr__(self, f, tuple(v))
        if self.deadlines is not None:
            # fail the request at construction, not deep inside the
            # engine-call plumbing with an opaque shape error
            object.__setattr__(
                self, "deadlines",
                tuple(machine._validate_deadlines(self.deadlines,
                                                  self.n_lanes)))
        if self.super_geom is not None:
            w, h = self.super_geom
            object.__setattr__(self, "super_geom", (int(w), int(h)))
        if self.validate not in ("off", "static", "strict"):
            raise ValueError(
                f"validate={self.validate!r}: expected 'off', 'static' or "
                "'strict'")
        if self.cycle_hints is not None:
            # Fail the request at construction, not deep inside planning
            # with an opaque shape error.
            from repro_torch.core.batch import validate_hints
            object.__setattr__(
                self, "cycle_hints",
                tuple(validate_hints(self.cycle_hints, self.n_lanes)))

    @property
    def n_lanes(self) -> int:
        from repro_torch.core.batch import BatchedWorkloads
        if isinstance(self.workloads, BatchedWorkloads):
            return self.workloads.batch
        return len(self.workloads)


@dataclasses.dataclass(frozen=True)
class PackStats:
    """The packing schedule a ``pack=True`` sweep actually ran.

    ``plan`` is the wave list from ``pack_schedule`` (one dict per wave
    naming its super-lane geometries and sub-lane placements), kept as
    reported for artifact round-tripping.
    """
    n_waves: int
    n_super_lanes: int
    packing_efficiency: float
    unpacked_efficiency: float
    plan: tuple = ()

    def to_json(self) -> dict:
        return dict(n_waves=int(self.n_waves),
                    n_super_lanes=int(self.n_super_lanes),
                    packing_efficiency=float(self.packing_efficiency),
                    unpacked_efficiency=float(self.unpacked_efficiency),
                    plan=list(self.plan))


@dataclasses.dataclass(frozen=True)
class ShardStats:
    """The device-sharding plan a ``shard=True`` sweep actually ran.

    ``plan`` lists lanes per device (per wave, when packed).  On a
    single-device host ``n_devices`` is 1 and the plan is the trivial
    one — recorded, not omitted, so artifacts stay shape-stable across
    hosts.
    """
    n_devices: int
    lanes_per_device: int
    n_pad_lanes: int
    plan: tuple = ()

    def to_json(self) -> dict:
        return dict(n_devices=int(self.n_devices),
                    lanes_per_device=int(self.lanes_per_device),
                    n_pad_lanes=int(self.n_pad_lanes),
                    plan=list(self.plan))


@dataclasses.dataclass(frozen=True)
class EngineTelemetry:
    """Engine-efficiency counters for the sweep's engine calls.

    ``stepped_pe_ticks`` counts wall PE-steps the engine actually
    executed; ``plain_pe_ticks`` what the plain tick-per-cycle engine
    would have executed to reach the same final cycle counters (chunk
    granularity — exactly what ``fast_forward=False`` runs).  Their gap
    is the event-compression win: :attr:`dead_step_fraction` is the
    fraction of plain PE-steps the fast-forward engine skipped (0.0 by
    construction on plain engines, and on workloads with no compressible
    lone-flight stretches).
    """
    stepped_pe_ticks: int
    plain_pe_ticks: int
    engine_calls: int

    @property
    def dead_step_fraction(self) -> float:
        if self.plain_pe_ticks <= 0:
            return 0.0
        return max(0.0, 1.0 - self.stepped_pe_ticks / self.plain_pe_ticks)

    def to_json(self) -> dict:
        return dict(stepped_pe_ticks=int(self.stepped_pe_ticks),
                    plain_pe_ticks=int(self.plain_pe_ticks),
                    engine_calls=int(self.engine_calls),
                    dead_step_fraction=float(self.dead_step_fraction))


@dataclasses.dataclass(frozen=True)
class SweepReport:
    """Everything a sweep produced: per-lane results + the schedules.

    Behaves like the legacy result list (``len`` / index / iterate all
    hit ``lanes``), so migrating a call site is usually just swapping
    the call.  ``pack`` / ``shard`` are None when the corresponding
    switch was off.  ``telemetry`` carries the engine's dead-step
    accounting (always present on the ``sweep()`` path).
    """
    lanes: tuple                      # tuple[RunResult, ...] in input order
    pack: PackStats | None = None
    shard: ShardStats | None = None
    telemetry: EngineTelemetry | None = None

    def __post_init__(self):
        object.__setattr__(self, "lanes", tuple(self.lanes))

    def __len__(self) -> int:
        return len(self.lanes)

    def __iter__(self):
        return iter(self.lanes)

    def __getitem__(self, i):
        return self.lanes[i]

    @property
    def cycles(self) -> list[int]:
        """Per-lane cycle counts — feed back as ``cycle_hints`` to replan
        a follow-up sweep with measured runtimes."""
        return [r.cycles for r in self.lanes]

    def to_json(self) -> dict:
        """One JSON document for the whole sweep (lane rows via
        :meth:`RunResult.to_json`, schedules via their own ``to_json``)."""
        return dict(
            lanes=[r.to_json() for r in self.lanes],
            pack=None if self.pack is None else self.pack.to_json(),
            shard=None if self.shard is None else self.shard.to_json(),
            telemetry=(None if self.telemetry is None
                       else self.telemetry.to_json()),
        )


def sweep(cfg: MachineConfig, request: SweepRequest, *,
          device="cuda") -> SweepReport:
    """Run one :class:`SweepRequest` to completion on ``device`` and
    report it.

    Blocking, with the same bits as the ``run_many`` surface (both call
    the same implementation).  ``validate`` other than ``"off"`` runs the
    static pre-dispatch checks of :mod:`repro_torch.analysis` first.
    """
    if not isinstance(request, SweepRequest):
        raise TypeError(f"sweep() takes a SweepRequest, got "
                        f"{type(request).__name__} (legacy kwargs live on "
                        f"machine.run_many)")
    ps: dict | None = {} if request.pack else None
    ss: dict | None = {} if request.shard else None
    from repro_torch.core.batch import BatchedWorkloads
    wls = (request.workloads if isinstance(request.workloads,
                                           BatchedWorkloads)
           else list(request.workloads))
    if request.validate != "off" and not isinstance(wls, BatchedWorkloads):
        # Static pre-dispatch verification (repro_torch.analysis): reject
        # malformed lanes here, with per-lane diagnostics, instead of
        # letting them poison a shared fabric at runtime.
        from repro_torch.analysis import validate_request
        validate_request(wls, modes=request.modes,
                         strict=(request.validate == "strict"),
                         stream_wait_cap=cfg.stream_wait_cap)
    tm: dict = {}
    results = machine._run_many_impl(
        cfg, wls,
        modes=None if request.modes is None else list(request.modes),
        geoms=None if request.geoms is None else list(request.geoms),
        chunk=request.chunk, pack=request.pack,
        super_geom=request.super_geom, pack_stats=ps,
        shard=request.shard,
        cycle_hints=(None if request.cycle_hints is None
                     else list(request.cycle_hints)),
        shard_stats=ss, telemetry=tm,
        deadlines=(None if request.deadlines is None
                   else list(request.deadlines)),
        device=device)
    pack = None if ps is None else PackStats(
        n_waves=ps["n_waves"], n_super_lanes=ps["n_super_lanes"],
        packing_efficiency=ps["packing_efficiency"],
        unpacked_efficiency=ps["unpacked_efficiency"],
        plan=tuple(ps.get("plan", ())))
    shard = None if ss is None else ShardStats(
        n_devices=ss["n_devices"], lanes_per_device=ss["lanes_per_device"],
        n_pad_lanes=ss["n_pad_lanes"], plan=tuple(ss.get("plan", ())))
    telemetry = EngineTelemetry(
        stepped_pe_ticks=tm.get("stepped_pe_ticks", 0),
        plain_pe_ticks=tm.get("plain_pe_ticks", 0),
        engine_calls=tm.get("engine_calls", 0))
    return SweepReport(lanes=tuple(results), pack=pack, shard=shard,
                       telemetry=telemetry)
