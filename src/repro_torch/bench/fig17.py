"""Paper Fig. 17 on the torch engine: performance scaling with PE-array
size (2x2 -> 8x8).

The grid half of the reference's ``benchmarks/fig17_scaling.py``: the
same workloads (SpMV 128 x 128, SpMSpM 40 x 40, BFS on a 96-node small
world graph) compiled at every mesh size, the whole sizes x workloads
grid run in ONE packed ``sweep`` call — small meshes co-scheduled as
disjoint sub-meshes of shared 8x8 super-lanes, in a few waves.  Lanes
are built and ordered exactly as in the reference, so the table and the
sweep report agree bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.workloads import powerlaw_sparse, small_world_graph
from repro_torch.core import compiler
from repro_torch.core.machine import MachineConfig
from repro_torch.core.sweep import SweepReport, SweepRequest, sweep

SIZES = [(2, 2), (4, 4), (8, 8)]


def _builders():
    rng = np.random.default_rng(5)
    m = 128
    a = powerlaw_sparse(m, m, rng, 0.25)
    x = rng.integers(-3, 4, size=(m,))
    aa = powerlaw_sparse(40, 40, rng, 0.4)
    bb = powerlaw_sparse(40, 40, rng, 0.4)
    rp, col = small_world_graph(96, 4, 3)
    return {
        "spmv": lambda c: compiler.build_spmv(a, x, c),
        "spmspm": lambda c: compiler.build_spmspm(aa, bb, c),
        "bfs": lambda c: compiler.build_bfs(rp, col, 0, c),
    }


def _size_cfg(w: int, h: int) -> MachineConfig:
    return MachineConfig(width=w, height=h, mem_words=8192,
                         max_cycles=400_000)


def build_grid(builders, sizes=SIZES):
    """Compile every workload at every mesh size (placement is
    size-dependent, so each (size, workload) point is its own lane)."""
    lanes = []   # [(size, name, wl)]
    for (w, h) in sizes:
        cfg = _size_cfg(w, h)
        for name, b in builders.items():
            lanes.append(((w, h), name, b(cfg)))
    return lanes


def run_grid_report(builders, sizes=SIZES, *, pack: bool = True,
                    device="cuda") -> tuple[dict, SweepReport]:
    """The entire sizes x workloads grid in ONE (packed) sweep on
    ``device``.

    Returns ``(table, report)``: {workload: {"WxH": {cycles,
    utilization}}} — the Fig. 17 table — after checking that every lane
    completed with the numpy oracle's result, plus the
    :class:`SweepReport` with the packing schedule and the engine
    telemetry.
    """
    lanes = build_grid(builders, sizes)
    report = sweep(_size_cfg(*sizes[0]), SweepRequest(
        workloads=[wl for _, _, wl in lanes], pack=pack), device=device)
    out: dict = {name: {} for name in builders}
    for ((w, h), name, wl), r in zip(lanes, report):
        if not (r.completed and wl.check(r.mem_val)):
            raise RuntimeError(f"{name} @ {w}x{h}: no idle or WRONG RESULT")
        out[name][f"{w}x{h}"] = dict(cycles=r.cycles,
                                     utilization=r.utilization)
    return out, report
