"""Benchmark harness on the torch engine: run every workload on every
fabric architecture in one batched sweep, and cache the table the
per-figure scripts format.

The port of the reference's ``benchmarks/harness.py``: the workload axis
x fabric-mode axis (Nexus / TIA / TIA-Valiant) x, optionally, mesh-size
axis is stacked into the lanes of ONE :func:`repro_torch.core.sweep.sweep`
call, because the mode and the geometry are per-lane runtime data of the
engine, so the whole Figs. 11-14 suite is one engine and one batched run.
Lanes are built and ordered exactly as in the reference, so the tables
agree bit for bit (all but the wall seconds).

:func:`run_all` caches its table in ``experiments/bench_torch/results.json``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

from repro_torch.bench.workloads import Workload, make_all
from repro_torch.core import machine
from repro_torch.core.machine import FABRIC_MODES, MachineConfig, RunResult
from repro_torch.core.metrics import FREQ_HZ, POWER_MW
from repro_torch.core.sweep import SweepReport, SweepRequest, sweep

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "bench_torch")
RESULTS = os.path.join(OUT_DIR, "results.json")

# Data placement per architecture: Alg. 1 (dissimilarity) is a
# Nexus-compiler contribution the paper does not grant its baselines —
# TIA runs with standard equal-rows placement (§2.2 / §3.6).
PLACEMENT = {"nexus": "dissimilarity", "tia": "rows", "tia_valiant": "rows"}


def _placement_for(mode) -> str:
    """Placement strategy for a lane mode (name or bitmask)."""
    if isinstance(mode, str) and mode in PLACEMENT:
        return PLACEMENT[mode]
    code = machine.resolve_mode(mode)
    return "dissimilarity" if code & machine.MODE_OPPORTUNISTIC else "rows"


@dataclasses.dataclass
class GridLane:
    """One (workload, mode, size) point of a grid run."""

    mode: object
    size: tuple[int, int] | None
    workload: Workload
    compiled: object          # the CompiledWorkload the lane ran
    result: RunResult


def _run_grid(wls, modes, *, base_cfg, max_cycles, sizes, pack, shard,
              cycle_hints, device):
    """Build and run the grid's lanes in ONE sweep; returns the lanes (in
    lane order), the wall seconds of the sweep and its report."""
    modes = list(FABRIC_MODES) if modes is None else list(modes)
    base_cfg = base_cfg or MachineConfig()
    size_list = [None] if sizes is None else [tuple(s) for s in sizes]
    built, points = [], []
    lane_cache: dict = {}   # modes sharing a placement reuse built lanes
    for mode in modes:
        placement = _placement_for(mode)
        for size in size_list:
            for i, wl in enumerate(wls):
                key = (i, placement, size)
                if key not in lane_cache:
                    cfg = dataclasses.replace(
                        base_cfg, mem_words=wl.mem_words,
                        max_cycles=max_cycles)
                    if size is not None:
                        cfg = dataclasses.replace(cfg, width=size[0],
                                                  height=size[1])
                    lane_cache[key] = wl.build(cfg, placement)
                built.append(lane_cache[key])
                points.append((mode, size, wl))
    run_cfg = dataclasses.replace(
        base_cfg, mem_words=max(wl.mem_words for wl in wls),
        max_cycles=max_cycles)
    t0 = time.time()
    report = sweep(run_cfg, SweepRequest(
        workloads=built, modes=[p[0] for p in points], pack=pack,
        shard=shard, cycle_hints=cycle_hints),
        device=device)
    wall = time.time() - t0
    lanes = []
    for (mode, size, wl), b, res in zip(points, built, report.lanes):
        at = "" if size is None else f" @ {size[0]}x{size[1]}"
        if not res.completed:
            raise RuntimeError(f"{wl.name} on {mode}{at}: no idle")
        if not b.check(res.mem_val):
            raise RuntimeError(f"{wl.name} on {mode}{at}: WRONG RESULT")
        lanes.append(GridLane(mode, size, wl, b, res))
    return lanes, wall, report


def run_grid_lanes(wls: list[Workload], modes=None, *,
                   base_cfg: MachineConfig | None = None,
                   max_cycles: int = 400_000, sizes=None,
                   device="cuda", telemetry: dict | None = None
                   ) -> tuple[list[GridLane], float]:
    """Run the (workload x mode [x size]) grid in ONE batched call.

    Lanes are stacked mode-major, then size-major, as in the reference.
    Returns the lanes in that order and the wall seconds of the batched
    run (compiling the workloads excluded).  ``telemetry``, when given,
    is filled with the run's :class:`EngineTelemetry` fields.  Raises if
    a lane did not reach idle or computed a wrong result.
    """
    lanes, wall, report = _run_grid(
        wls, modes, base_cfg=base_cfg, max_cycles=max_cycles, sizes=sizes,
        pack=False, shard=False, cycle_hints=None, device=device)
    if telemetry is not None:
        telemetry.update(report.telemetry.to_json())
    return lanes, wall


def grid_table(lanes: list[GridLane], wall: float) -> dict:
    """The reference's ``run_grid`` table of grid lanes (in lane order):
    ``{mode: [row per workload]}`` when the lanes have no size, else
    ``{mode: {"WxH": [rows]}}``; each row is ``RunResult.to_json()`` plus
    the batch wall seconds ``batch_wall_s``."""
    out: dict = {}
    for ln in lanes:
        row = ln.result.to_json()
        # wall-clock of the whole batched grid this row ran in: per-workload
        # wall time is not individually measurable in a batched run
        row["batch_wall_s"] = wall
        if ln.size is None:
            out.setdefault(ln.mode, []).append(row)
        else:
            out.setdefault(ln.mode, {}).setdefault(
                f"{ln.size[0]}x{ln.size[1]}", []).append(row)
    return out


def run_grid(wls: list[Workload], modes=None, *,
             base_cfg: MachineConfig | None = None,
             max_cycles: int = 400_000, sizes=None, pack: bool = False,
             shard: bool = False, cycle_hints=None, device="cuda") -> dict:
    """Run the full (workload x fabric-mode [x mesh-size]) grid in ONE
    batched call; returns just the row table (see
    :func:`run_grid_report` for the table + the sweep's packing /
    sharding schedules)."""
    table, _ = run_grid_report(wls, modes, base_cfg=base_cfg,
                               max_cycles=max_cycles, sizes=sizes,
                               pack=pack, shard=shard,
                               cycle_hints=cycle_hints, device=device)
    return table


def run_grid_report(wls: list[Workload], modes=None, *,
                    base_cfg: MachineConfig | None = None,
                    max_cycles: int = 400_000, sizes=None,
                    pack: bool = False, shard: bool = False,
                    cycle_hints=None, device="cuda"
                    ) -> tuple[dict, SweepReport]:
    """Run the full (workload x fabric-mode [x mesh-size]) grid in ONE
    batched sweep on ``device``.

    Lanes are stacked mode-major, then size-major, with the per-lane mode
    (and, through each lane's recorded geometry, mesh) vector threaded
    through one engine, as in the reference.  ``modes`` entries may be
    ``FABRIC_MODES`` names or raw mode bitmasks; ``sizes`` entries are
    ``(width, height)`` pairs (placement is recomputed per size).

    ``pack=True`` co-schedules small lanes inside shared padded
    super-lanes (:func:`repro_torch.core.batch.pack_schedule`; metrics
    bit-identical).  ``shard=True`` splits the lane axis over every
    visible card of ``device``'s type (one card: the plain engine), with
    ``cycle_hints`` (per-lane measured cycles, grid lane order) feeding
    the shard and wave balancers.

    Returns ``(table, report)``: the table of :func:`grid_table`, and the
    :class:`SweepReport` whose ``pack`` / ``shard`` fields carry the
    schedules the grid ran with.  Raises if a lane did not reach idle or
    computed a wrong result.
    """
    lanes, wall, report = _run_grid(
        wls, modes, base_cfg=base_cfg, max_cycles=max_cycles, sizes=sizes,
        pack=pack, shard=shard, cycle_hints=cycle_hints, device=device)
    return grid_table(lanes, wall), report


def run_fabric(wl: Workload, mode: str, *, device="cuda") -> dict:
    """Single (workload, mode) point: a B=1 :func:`run_fabric_batch`."""
    return run_fabric_batch([wl], mode, device=device)[0]


def run_fabric_batch(wls: list[Workload], mode: str, *,
                     device="cuda") -> list[dict]:
    """One fabric mode over many workloads: a single-row slice of
    :func:`run_grid` (the same batched engine path)."""
    return run_grid(wls, [mode], device=device)[mode]


def build_table(wls: list[Workload], fabric_rows: dict[str, list[dict]],
                *, verbose: bool = True) -> dict:
    """Assemble the per-workload results table the fig scripts consume."""
    table: dict = {}
    for i, wl in enumerate(wls):
        entry: dict = {"useful_ops": wl.useful_ops,
                       "sparsity": wl.sparsity_note, "archs": {}}
        for mode in fabric_rows:
            r = fabric_rows[mode][i]
            entry["archs"][mode] = r
            if verbose:
                print(f"  {wl.name:<12} {mode:<12} cycles={r['cycles']:>7} "
                      f"util={r['utilization']:.2f} "
                      f"enroute={100*r['enroute_frac']:.0f}% "
                      f"(batch {r['batch_wall_s']:.1f}s)")
        if wl.cgra is not None:
            c = wl.cgra()
            entry["archs"]["cgra"] = dict(
                cycles=int(c.cycles), utilization=float(c.utilization),
                stall_total=int(c.stall_cycles),
                bank_conflicts=c.bank_conflict_histogram.tolist())
            if verbose:
                print(f"  {wl.name:<12} {'cgra':<12} cycles={c.cycles:>7} "
                      f"util={c.utilization:.2f}")
        if wl.systolic_cycles is not None:
            entry["archs"]["systolic"] = dict(
                cycles=int(wl.systolic_cycles),
                utilization=float(min(1.0, wl.useful_ops /
                                      (wl.systolic_cycles * 16))))
        table[wl.name] = entry
    return table


def run_all(*, force: bool = False, verbose: bool = True,
            device="cuda") -> dict:
    """The Figs. 11-14 table: every ``make_all()`` workload on every fabric
    mode at 4x4 in one sweep on ``device``, with the host CGRA and
    systolic models; cached in :data:`RESULTS` (``force`` re-runs)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    if os.path.exists(RESULTS) and not force:
        with open(RESULTS) as f:
            return json.load(f)

    wls = make_all()
    fabric_rows = run_grid(wls, device=device)
    table = build_table(wls, fabric_rows, verbose=verbose)

    with open(RESULTS, "w") as f:
        json.dump(table, f, indent=1)
    return table


def mops(entry: dict, arch: str) -> float:
    c = entry["archs"][arch]["cycles"]
    return entry["useful_ops"] / (c / FREQ_HZ) / 1e6


def mops_per_mw(entry: dict, arch: str) -> float:
    return mops(entry, arch) / POWER_MW[arch]


if __name__ == "__main__":
    run_all(force=True)
