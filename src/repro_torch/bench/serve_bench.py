"""Sweep-service throughput benchmark + soak driver, on the torch engine —
a port of the reference's ``benchmarks/serve_bench.py``.

Measures the resident :class:`repro_torch.serve.SweepService` (continuous
batching on the one cached engine: submit -> future, mid-wave refill of
retired rectangles) against *sequential blocking* ``machine.run_many``
calls on the SAME traffic — one call per lane, which is what a client
without the service would do between grid points.

Two canned traffic shapes:

  * ``fig17`` — the Fig. 17 sizes x workloads grid (2x2 ... 8x8 meshes,
    dissimilar runtimes: lanes of every size retire at different times,
    which is exactly the regime mid-wave refill pays for itself in).
    Defaults to the reference CI's smoke problem scale; ``--paper`` swaps
    in the paper-scale problems of :mod:`repro_torch.bench.fig17`;
  * ``smoke`` — the reference CI smoke grid's three tiny 2x2 workloads
    (uniform runtimes; records the service's overhead floor).

Every service result is checked bit-identical to the one-shot
``run_many`` reference before a number is reported, and the service must
have used exactly ONE cached engine.  ``main`` doubles as a soak driver —
seeded random interleaved submission rounds against the same reference.
The reference's persistent XLA compile-cache knobs have no counterpart:
torch compiles nothing, so a run has no compile step to cache (the warm
passes below still run, and pay the engine's first-call costs).

    PYTHONPATH=src python -m repro_torch.bench.serve_bench --traffic fig17
    PYTHONPATH=src python -m repro_torch.bench.serve_bench --soak --rounds 3

Both run on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.core import machine
from repro_torch.core.machine import MachineConfig


def fig17_traffic(copies: int = 1, *, paper: bool = False):
    """Dissimilar-runtime traffic: the Fig. 17 sizes x workloads grid
    (2x2 ... 8x8 meshes), duplicated ``copies`` times.  Returns
    ``(base_cfg, lanes)``.

    The default problem scale is the reference CI's smoke one (SpMV
    16 x 16 and BFS on a 24-node small-world graph, ``mem_words`` 1024):
    every lane retires within a few engine chunks.  ``paper=True`` swaps
    in the paper-scale problems of :mod:`repro_torch.bench.fig17`, where
    a 2x2 mesh runs ~16x longer than the 8x8 on the same input."""
    from repro_torch.bench.fig17 import SIZES, _builders, _size_cfg
    from repro_torch.bench.workloads import small_world_graph
    from repro_torch.core import compiler
    if paper:
        builders, cfg_for = _builders(), _size_cfg
    else:
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
    for _ in range(copies):
        for (w, h) in SIZES:
            cfg = cfg_for(w, h)
            for name in sorted(builders):
                lanes.append(builders[name](cfg))
    return cfg_for(*SIZES[-1]), lanes


def smoke_workloads():
    """The reference CI smoke grid's inputs (``benchmarks/bench_ci.py``'s
    ``smoke_workloads``, fixed seeds)."""
    from repro_torch.bench.workloads import Workload, small_world_graph
    from repro_torch.core import compiler
    rng = np.random.default_rng(5)
    a = compiler.random_sparse(8, 8, 0.4, rng)
    x = rng.integers(-3, 4, size=(8,))
    da = rng.integers(-3, 4, size=(4, 4))
    db = rng.integers(-3, 4, size=(4, 4))
    rp, col = small_world_graph(12, 4, 2)
    return [
        Workload(name="spmv", sparsity_note="sparse",
                 build=lambda c, s: compiler.build_spmv(a, x, c, strategy=s),
                 useful_ops=2 * int(np.count_nonzero(a)),
                 cgra=None, systolic_cycles=None, mem_words=1024),
        Workload(name="matmul", sparsity_note="dense",
                 build=lambda c, s: compiler.build_matmul(da, db, c,
                                                          strategy=s),
                 useful_ops=2 * 4 ** 3,
                 cgra=None, systolic_cycles=None, mem_words=1024),
        Workload(name="bfs", sparsity_note="graph",
                 build=lambda c, s: compiler.build_bfs(rp, col, 0, c,
                                                       strategy=s),
                 useful_ops=2 * int(col.size),
                 cgra=None, systolic_cycles=None, mem_words=1024),
    ]


def smoke_traffic(copies: int = 2):
    """Uniform traffic: the smoke grid's 2x2 workloads, duplicated
    ``copies`` times.  Returns ``(base_cfg, lanes)``."""
    from repro_torch.bench import harness
    cfg = MachineConfig(width=2, height=2, mem_words=1024,
                        max_cycles=100_000)
    placement = harness._placement_for(machine.mode_code(cfg))
    wls = smoke_workloads()
    lanes = []
    for _ in range(copies):
        for wl in wls:
            lanes.append(wl.build(cfg, placement))
    return cfg, lanes


def _same(a, b) -> bool:
    """Bit-identity of two RunResults: every scalar/stat field plus the
    final memory image."""
    return (a.to_json() == b.to_json()
            and np.array_equal(np.asarray(a.mem_val),
                               np.asarray(b.mem_val)))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def service_throughput(cfg, lanes, *, n_supers: int = 2,
                       slice_chunks: int = 2, chunk: int = 512,
                       label: str = "fig17", device="cuda") -> dict:
    """Steady-state lanes/s: sequential blocking run_many vs the service.

    Both sides run the traffic twice — the first pass is a warm-up, the
    second pass is timed.  Service results are checked bit-identical to
    the sequential ones lane by lane; any drift lands in the returned
    record's ``drift`` list.  The engine cache is cleared before the
    service is built, so ``engine_cache_size`` in the record counts the
    service's engines alone (must be 1)."""
    from repro_torch.serve import SweepService

    def seq_pass():
        return [machine.run_many(cfg, [wl], device=device)[0]
                for wl in lanes]

    seq_pass()                                 # warm-up
    _sync(device)
    t0 = time.time()
    seq_results = seq_pass()
    t_seq = time.time() - t0

    machine.clear_engine_cache()
    with SweepService(cfg, template=lanes, n_supers=n_supers,
                      chunk=chunk, slice_chunks=slice_chunks,
                      device=device) as svc:
        for f in svc.map(lanes):               # warm-up
            f.result()
        _sync(device)
        t0 = time.time()
        futs = svc.map(lanes)
        svc.drain()
        t_svc = time.time() - t0
        svc_results = [f.result() for f in futs]
        occupancy = svc.refill_occupancy
        stats = dict(svc.stats)
    engines = machine.engine_cache_size()

    drift = [f"lane {i}: service result != sequential run_many"
             for i, (a, b) in enumerate(zip(svc_results, seq_results))
             if not _same(a, b)]
    n = len(lanes)
    return dict(traffic=label, n_lanes=n, device=str(device),
                seq_wall_s=t_seq, service_wall_s=t_svc,
                seq_lanes_per_s=n / t_seq,
                service_lanes_per_s=n / t_svc,
                speedup=t_seq / t_svc,
                refill_occupancy=occupancy,
                n_refills=int(stats["n_refills"]),
                n_slices=int(stats["n_slices"]),
                engine_ticks=int(stats["engine_ticks"]),
                engine_cache_size=engines,
                drift=drift)


def soak(cfg, lanes, *, rounds: int = 3, seed: int = 0, n_supers: int = 2,
         slice_chunks: int = 2, device="cuda", results: list | None = None
         ) -> dict:
    """Seeded random interleaved submission rounds on one resident
    service; every future must come back bit-identical to the one-shot
    ``run_many`` reference, with exactly one cached engine.  ``results``,
    when given, receives each round's ``{lane: RunResult}``."""
    from repro_torch.serve import SweepService
    ref = machine.run_many(cfg, list(lanes), device=device)
    rng = np.random.default_rng(seed)
    drift: list[str] = []
    machine.clear_engine_cache()
    t0 = time.time()
    with SweepService(cfg, template=lanes, n_supers=n_supers,
                      slice_chunks=slice_chunks, device=device) as svc:
        for rd in range(rounds):
            order = [int(i) for i in rng.permutation(len(lanes))]
            futs = {i: svc.submit(lanes[i]) for i in order}
            svc.drain()
            got = {i: f.result() for i, f in futs.items()}
            if results is not None:
                results.append(got)
            for i, r in got.items():
                if not _same(r, ref[i]):
                    drift.append(f"round {rd} lane {i}: service result "
                                 "!= one-shot run_many")
        occupancy = svc.refill_occupancy
        stats = dict(svc.stats)
        telemetry = svc.telemetry
    return dict(rounds=rounds, n_lanes=len(lanes), drift=drift,
                engine_cache_size=machine.engine_cache_size(),
                refill_occupancy=occupancy,
                n_refills=int(stats["n_refills"]),
                n_retired=int(stats["n_retired"]),
                n_slices=int(stats["n_slices"]),
                engine_ticks=int(stats["engine_ticks"]),
                dead_step_fraction=telemetry.dead_step_fraction,
                service_wall_s=time.time() - t0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--traffic", choices=["fig17", "smoke"],
                    default="fig17")
    ap.add_argument("--copies", type=int, default=None,
                    help="traffic duplication factor (default: 2)")
    ap.add_argument("--paper", action="store_true",
                    help="paper-scale fig17 problems (small meshes run "
                         "16x longer than the 8x8)")
    ap.add_argument("--n-supers", type=int, default=2)
    ap.add_argument("--slice-chunks", type=int, default=None,
                    help="engine chunks per scheduler slice (default: "
                         "1 for fig17, 2 for smoke)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="service engine chunk in cycles (default: 128 "
                         "for fig17, 512 for smoke); the sequential "
                         "baseline always runs the run_many default")
    ap.add_argument("--soak", action="store_true",
                    help="run interleaved-submission soak rounds instead "
                         "of the throughput comparison")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="also write the record as JSON here")
    args = ap.parse_args()

    fig17 = args.traffic == "fig17"
    copies = args.copies or 2
    slice_chunks = args.slice_chunks or (1 if fig17 else 2)
    chunk = args.chunk or (128 if fig17 else 512)
    if fig17:
        cfg, lanes = fig17_traffic(copies=copies, paper=args.paper)
    else:
        cfg, lanes = smoke_traffic(copies=copies)

    if args.soak:
        rec = soak(cfg, lanes, rounds=args.rounds, seed=args.seed,
                   n_supers=args.n_supers, slice_chunks=slice_chunks,
                   device=args.device)
        print(f"soak [{args.traffic}]: {rec['rounds']} rounds x "
              f"{rec['n_lanes']} lanes, {rec['n_retired']} retirements, "
              f"{rec['n_refills']} mid-wave refills, occupancy "
              f"{rec['refill_occupancy']:.2f}, engines "
              f"{rec['engine_cache_size']}")
    else:
        label = args.traffic + ("-paper" if args.paper else "")
        rec = service_throughput(cfg, lanes, n_supers=args.n_supers,
                                 slice_chunks=slice_chunks,
                                 chunk=chunk, label=label,
                                 device=args.device)
        print(f"service [{args.traffic}]: {rec['n_lanes']} lanes — "
              f"sequential {rec['seq_lanes_per_s']:.3f} lanes/s, service "
              f"{rec['service_lanes_per_s']:.3f} lanes/s "
              f"({rec['speedup']:.2f}x), refill occupancy "
              f"{rec['refill_occupancy']:.2f}, {rec['n_refills']} "
              f"refills, engines {rec['engine_cache_size']}")
    print(json.dumps(rec))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    if rec["drift"]:
        print("\nSERVICE DRIFT (results not bit-identical):",
              file=sys.stderr)
        for msg in rec["drift"]:
            print(f"  - {msg}", file=sys.stderr)
        return 1
    if rec["engine_cache_size"] != 1:
        print(f"service used {rec['engine_cache_size']} engines "
              "(want 1)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
