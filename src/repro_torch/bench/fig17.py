"""Paper Fig. 17 on the torch engine: performance scaling with PE-array
size (2x2 -> 8x8).

The port of the reference's ``benchmarks/fig17_scaling.py``: the same
workloads (SpMV 128 x 128, SpMSpM 40 x 40, BFS on a 96-node small world
graph) compiled at every mesh size, the whole sizes x workloads grid run
in ONE packed ``sweep`` call (small meshes co-scheduled as disjoint
sub-meshes of shared 8x8 super-lanes, in a few waves), on one cached
engine (``machine.engine_cache_size() == 1`` afterwards).  Lanes are built
and ordered exactly as in the reference, so the table and the sweep
report agree bit for bit.

``--bench`` times the packed grid against the per-size baseline (one
batched run per mesh size, each on an engine of its own) and the
unpacked one-engine grid (every lane padded to 8x8), plus a
packed+sharded leg (the lane axis split over every visible card).  A
"cold" leg here starts from an empty engine cache
(``machine.clear_engine_cache()``): torch compiles nothing, so where the
reference's cold legs also clear JAX's compile cache and pay XLA
compiles, the port's pay only the first calls of freshly built engines.
``--shard`` runs the main grid sharded (bit-identical results).

    PYTHONPATH=src python -m repro_torch.bench.fig17 [--force] [--shard] [--bench]

The table is cached in ``experiments/bench_torch/fig17.json``; every
entry point runs on the card unless ``device`` (``--device``) names
another.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.bench.workloads import powerlaw_sparse, small_world_graph
from repro_torch.core import compiler, machine
from repro_torch.core.machine import MachineConfig
from repro_torch.core.sweep import SweepReport, SweepRequest, sweep

OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "experiments", "bench_torch", "fig17.json")
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


def run_grid(builders, sizes=SIZES, *, pack: bool = True,
             shard: bool = False, device="cuda") -> dict:
    """The Fig. 17 table alone; see :func:`run_grid_report` for the
    table plus the sweep's packing / sharding schedules."""
    table, _ = run_grid_report(builders, sizes, pack=pack, shard=shard,
                               device=device)
    return table


def run_grid_report(builders, sizes=SIZES, *, pack: bool = True,
                    shard: bool = False, device="cuda"
                    ) -> tuple[dict, SweepReport]:
    """The entire sizes x workloads grid in ONE (packed) sweep on
    ``device``.

    Returns ``(table, report)``: {workload: {"WxH": {cycles,
    utilization}}} — the Fig. 17 table — after checking that every lane
    completed with the numpy oracle's result, plus the
    :class:`SweepReport` with the packing schedule, the shard plan and
    the engine telemetry.  ``shard=True`` additionally splits each wave's
    lane axis over every visible card of ``device``'s type
    (bit-identical; one card: the plain engine).
    """
    lanes = build_grid(builders, sizes)
    report = sweep(_size_cfg(*sizes[0]), SweepRequest(
        workloads=[wl for _, _, wl in lanes], pack=pack, shard=shard),
        device=device)
    out: dict = {name: {} for name in builders}
    for ((w, h), name, wl), r in zip(lanes, report):
        if not (r.completed and wl.check(r.mem_val)):
            raise RuntimeError(f"{name} @ {w}x{h}: no idle or WRONG RESULT")
        out[name][f"{w}x{h}"] = dict(cycles=r.cycles,
                                     utilization=r.utilization)
    return out, report


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench_smoke(sizes=SIZES, *, device="cuda") -> dict:
    """The engine-bound regime: the same sizes x workloads sweep
    structure on tiny (CI-smoke-sized) problems, the one-engine grid
    against the per-size baseline, each from an empty engine cache.

    Each lane finishes in a few hundred cycles, so the sweep's cost is
    the engines' first calls; in the reference, one traced-geometry
    engine instead of one per size saves compiles."""
    rng = np.random.default_rng(7)
    a = compiler.random_sparse(16, 16, 0.3, rng)
    x = rng.integers(-3, 4, size=(16,))
    rp, col = small_world_graph(24, 4, 3)
    builders = {
        "spmv": lambda c: compiler.build_spmv(a, x, c),
        "bfs": lambda c: compiler.build_bfs(rp, col, 0, c),
    }

    def cfg_for(w, h):
        return dataclasses.replace(_size_cfg(w, h), mem_words=1024)

    lanes = []
    for (w, h) in sizes:
        for b in builders.values():
            lanes.append(((w, h), b(cfg_for(w, h))))

    machine.clear_engine_cache()
    t0 = time.time()
    for (w, h) in sizes:
        machine.run_many(cfg_for(w, h),
                         [wl for sz, wl in lanes if sz == (w, h)],
                         device=device)
    _sync(device)
    t_per_size = time.time() - t0
    n_per_size = machine.engine_cache_size()

    machine.clear_engine_cache()
    t0 = time.time()
    machine.run_many(cfg_for(*sizes[0]), [wl for _, wl in lanes],
                     device=device)
    _sync(device)
    t_grid = time.time() - t0
    n_grid = machine.engine_cache_size()

    print(f"smoke sweep ({len(sizes)} sizes x {len(builders)} tiny "
          "workloads), empty engine cache each way:")
    print(f"  per-size batches: {n_per_size} engines, {t_per_size:.1f}s")
    print(f"  one-engine grid:  {n_grid} engine,  {t_grid:.1f}s  "
          f"-> {t_per_size / t_grid:.1f}x")
    return dict(per_size_cold_s=t_per_size, per_size_engines=n_per_size,
                grid_cold_s=t_grid, grid_engines=n_grid,
                speedup_cold=t_per_size / t_grid)


def _timed(fn, device):
    t0 = time.time()
    out = fn()
    _sync(device)
    return out, time.time() - t0


def bench(*, device="cuda") -> dict:
    """Time the full sizes x workloads sweep four ways: the per-size
    baseline (one batched run per mesh size, each on an engine of its
    own), the unpacked one-engine grid (every lane padded to 8x8), the
    PACKED one-call grid (the default ``run_grid`` path) and the packed
    grid sharded over every visible card.

    Each leg runs from an empty engine cache ("cold": the engines' first
    calls; no compile, see the module docstring) and again on the cached
    engines ("steady").  Every leg's per-lane cycles, executed and hops
    must agree."""
    builders = _builders()
    lanes = build_grid(builders)
    wls = [wl for _, _, wl in lanes]

    def per_size_pass():
        return {(w, h): machine.run_many(
            _size_cfg(w, h), [wl for (sz, _, wl) in lanes if sz == (w, h)],
            device=device) for (w, h) in SIZES}

    machine.clear_engine_cache()
    per_size, t_seq_cold = _timed(per_size_pass, device)
    n_seq_engines = machine.engine_cache_size()
    _, t_seq_warm = _timed(per_size_pass, device)

    def grid_pass():
        return machine.run_many(_size_cfg(2, 2), wls, device=device)

    machine.clear_engine_cache()
    grid, t_cold = _timed(grid_pass, device)
    n_grid_engines = machine.engine_cache_size()
    grid, t_warm = _timed(grid_pass, device)

    pack_req = SweepRequest(workloads=wls, pack=True)
    machine.clear_engine_cache()
    packed_rep, t_pack_cold = _timed(
        lambda: sweep(_size_cfg(2, 2), pack_req, device=device), device)
    n_pack_engines = machine.engine_cache_size()
    packed_rep, t_pack_warm = _timed(
        lambda: sweep(_size_cfg(2, 2), pack_req, device=device), device)
    packed, pack_stats = packed_rep.lanes, packed_rep.pack

    shard_req = SweepRequest(workloads=wls, pack=True, shard=True)
    machine.clear_engine_cache()
    sharded_rep, t_shard_cold = _timed(
        lambda: sweep(_size_cfg(2, 2), shard_req, device=device), device)
    n_shard_engines = machine.engine_cache_size()
    sharded_rep, t_shard_warm = _timed(
        lambda: sweep(_size_cfg(2, 2), shard_req, device=device), device)
    sharded, shard_stats = sharded_rep.lanes, sharded_rep.shard

    # per-lane metrics identical between all four paths
    it = iter(zip(grid, packed, sharded))
    for (w, h) in SIZES:
        for s in per_size[w, h]:
            for other in next(it):
                if (s.cycles, s.executed, s.hops) != (
                        other.cycles, other.executed, other.hops):
                    raise AssertionError(f"fig17 bench: a {w}x{h} lane "
                                         "differs between the paths")
    print(f"fig17 grid ({len(SIZES)} sizes x {len(builders)} workloads = "
          f"{len(lanes)} lanes), metrics identical:")
    print(f"  per-size batches, {n_seq_engines} engines, cold: "
          f"{t_seq_cold:.1f}s   (steady: {t_seq_warm:.1f}s)")
    print(f"  unpacked grid,    {n_grid_engines} engine,  cold: "
          f"{t_cold:.1f}s  -> {t_seq_cold / t_cold:.1f}x   "
          f"(steady: {t_warm:.1f}s)")
    print(f"  packed grid,      {n_pack_engines} engine,  cold: "
          f"{t_pack_cold:.1f}s  -> {t_seq_cold / t_pack_cold:.1f}x   "
          f"(steady: {t_pack_warm:.1f}s -> "
          f"{t_seq_warm / t_pack_warm:.1f}x)")
    print(f"  packed+sharded,   {n_shard_engines} engine,  cold: "
          f"{t_shard_cold:.1f}s   (steady: {t_shard_warm:.1f}s) on "
          f"{shard_stats.n_devices} device(s), "
          f"{shard_stats.lanes_per_device} lanes/device")
    print(f"  packing: {pack_stats.n_waves} waves, efficiency "
          f"{pack_stats.packing_efficiency:.2f} (unpacked "
          f"{pack_stats.unpacked_efficiency:.2f})")
    smoke = bench_smoke(device=device)
    return dict(per_size_cold_s=t_seq_cold, per_size_warm_s=t_seq_warm,
                per_size_engines=n_seq_engines,
                grid_cold_s=t_cold, grid_warm_s=t_warm,
                grid_engines=n_grid_engines,
                packed_cold_s=t_pack_cold, packed_warm_s=t_pack_warm,
                packed_engines=n_pack_engines,
                sharded_cold_s=t_shard_cold, sharded_warm_s=t_shard_warm,
                sharded_engines=n_shard_engines,
                n_devices=shard_stats.n_devices,
                lanes_per_device=shard_stats.lanes_per_device,
                speedup_cold=t_seq_cold / t_cold,
                speedup_warm=t_seq_warm / t_warm,
                packed_speedup_cold=t_seq_cold / t_pack_cold,
                packed_speedup_warm=t_seq_warm / t_pack_warm,
                sharded_speedup_warm=t_pack_warm / t_shard_warm,
                pack_stats=pack_stats.to_json(),
                smoke=smoke)


def main(force: bool = False, shard: bool = False, *, device="cuda"):
    """Print the Fig. 17 table (from the cache unless ``force`` or
    ``shard``); returns it."""
    if os.path.exists(OUT) and not force and not shard:
        with open(OUT) as f:
            data = json.load(f)
    else:
        data, report = run_grid_report(_builders(), shard=shard,
                                       device=device)
        if shard and report.shard is not None:
            print(f"sharded over {report.shard.n_devices} device(s), "
                  f"{report.shard.lanes_per_device} lanes/device")
        os.makedirs(os.path.dirname(OUT), exist_ok=True)
        with open(OUT, "w") as f:
            json.dump(data, f, indent=1)

    print("=" * 78)
    print("Fig. 17 — scaling with array size (speedup over 2x2; "
          "ideal 4x4 = 4, 8x8 = 16)")
    print("=" * 78)
    print(f"{'workload':<10}" + "".join(f"{f'{w}x{h}':>6}" for (w, h) in SIZES)
          + "    utilization @8x8")
    for name, sizes in data.items():
        base = sizes["2x2"]["cycles"]
        row = f"{name:<10}"
        for (w, h) in SIZES:
            row += f"{base / sizes[f'{w}x{h}']['cycles']:>6.1f}"
        row += f"{100 * sizes['8x8']['utilization']:>18.0f}%"
        print(row)
    print("-" * 78)
    print("scaling tracks fabric size while the problem covers it; "
          "utilization (not problem size) is the limiter — paper §5.4")
    return data


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--shard", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.bench:
        bench(device=args.device)
    else:
        main(force=args.force, shard=args.shard, device=args.device)
