"""Benchmark harness on the torch engine: run every workload on every
fabric architecture in one batched ``run_many`` call.

The port of the reference's ``benchmarks/harness.py`` ``run_grid`` /
``build_table``: the workload axis x fabric-mode axis (Nexus / TIA /
TIA-Valiant) x, optionally, mesh-size axis is stacked into the lanes of
ONE :func:`repro_torch.core.machine.run_many` call, because the mode and
the geometry are per-lane runtime data of the engine.  Lanes are built and
ordered exactly as in the reference, so the tables agree bit for bit.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.bench.workloads import Workload
from repro_torch.core import machine
from repro_torch.core.machine import FABRIC_MODES, MachineConfig, RunResult

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


def run_grid_lanes(wls: list[Workload], modes=None, *,
                   base_cfg: MachineConfig | None = None,
                   max_cycles: int = 400_000, sizes=None,
                   device="cuda") -> tuple[list[GridLane], float]:
    """Run the (workload x mode [x size]) grid in ONE batched call.

    Lanes are stacked mode-major, then size-major, as in the reference.
    Returns the lanes in that order and the wall seconds of the batched
    run (compiling the workloads excluded).  Raises if a lane did not
    reach idle or computed a wrong result.
    """
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
    results = machine.run_many(run_cfg, built,
                               modes=[p[0] for p in points], device=device)
    wall = time.time() - t0
    lanes = []
    for (mode, size, wl), b, res in zip(points, built, results):
        at = "" if size is None else f" @ {size[0]}x{size[1]}"
        if not res.completed:
            raise RuntimeError(f"{wl.name} on {mode}{at}: no idle")
        if not b.check(res.mem_val):
            raise RuntimeError(f"{wl.name} on {mode}{at}: WRONG RESULT")
        lanes.append(GridLane(mode, size, wl, b, res))
    return lanes, wall


def run_grid(wls: list[Workload], modes=None, *,
             base_cfg: MachineConfig | None = None,
             max_cycles: int = 400_000, sizes=None, device="cuda") -> dict:
    """The reference's ``run_grid`` table: ``{mode: [row per workload]}``
    when ``sizes`` is None, else ``{mode: {"WxH": [rows]}}``; each row is
    ``RunResult.to_json()`` plus the batch wall seconds.  (The reference's
    ``pack`` / ``shard`` / ``cycle_hints`` options are not ported yet.)"""
    lanes, wall = run_grid_lanes(wls, modes, base_cfg=base_cfg,
                                 max_cycles=max_cycles, sizes=sizes,
                                 device=device)
    modes = list(FABRIC_MODES) if modes is None else list(modes)
    out: dict = {}
    it = iter(lanes)
    for mode in modes:
        by_size: dict = {}
        for size in ([None] if sizes is None else [tuple(s) for s in sizes]):
            rows = []
            for _ in wls:
                row = next(it).result.to_json()
                row["batch_wall_s"] = wall
                rows.append(row)
            by_size[size] = rows
        out[mode] = (by_size[None] if sizes is None else
                     {f"{w}x{h}": by_size[w, h] for (w, h) in by_size})
    return out


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
