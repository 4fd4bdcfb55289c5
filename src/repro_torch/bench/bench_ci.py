"""Benchmark-trajectory artifacts + perf-regression gate, on the torch
engine.

The port of the reference's ``benchmarks/bench_ci.py``: the same legs,
artifacts and gates, every leg on the card unless ``--device`` names
another.  Produces two JSON artifacts so the perf trajectory
accumulates run over run:

  * ``BENCH_fig11.json`` — the deterministic smoke grid (3 workloads x 3
    fabric modes on a 2x2 mesh through ``harness.run_grid``): per-lane
    cycles / utilization / executed, grid wall-clock, engine-cache size.
  * ``BENCH_fig17.json`` — the batched Fig. 17 scaling sweep (3 workloads
    x 2x2/4x4/8x8 meshes as ONE packed ``sweep`` call, small meshes
    co-scheduled as sub-meshes of shared super-lanes): per-point cycles /
    utilization, sweep wall-clock, engine-cache size, packing efficiency
    (occupied / padded-stepped PE fraction) and lanes-per-engine.

Both artifacts also carry the multi-device lane-sharding leg: the same
grid re-run with ``shard=True`` (the lane axis split over every
visible card of the device's type), recording ``n_devices`` /
``lanes_per_device`` and the shard-vs-solo wall-clock, cold-vs-cold
(the engine cache is cleared before EACH leg) — on one card the sharded
leg degrades to the plain engine, so the line doubles as an honest no-op
measurement.

Both artifacts additionally carry a ``service`` leg: the same traffic
through the resident :class:`repro_torch.serve.SweepService` (continuous
batching — mid-wave refill of retired sub-lane rectangles on the one
warm engine) vs sequential blocking per-lane ``run_many`` calls,
recording steady-state lanes/s both ways plus the service's refill
occupancy (see :mod:`repro_torch.bench.serve_bench`).

Both artifacts also carry a ``static_cost`` leg: every grid lane
estimated by the pre-dispatch verifier's cost model
(``repro_torch.analysis.estimate_cycles``) and Spearman-rank-correlated
against the measured cycles, so the artifact trail records how well the
planners' default admission / packing hints track the real machine.

Both artifacts also carry a ``fast_forward`` leg: the same sweep on the
event-compressed (default) and plain (``fast_forward=False``) engines,
recording wall-clock both ways plus the engine's ``dead_step_fraction``
telemetry (the fraction of plain PE-steps compression skipped).  The
fig17 artifact adds a ``fast_forward_chain`` leg — a scrambled pointer
chase, the serial workload class compression exists for — where the
wall-clock win is the demonstration, not just parity.

Perf-regression gates (exit 1 on violation):

  * the smoke grid's per-lane cycle counts must equal the golden
    values (``src/repro_torch/golden/bench_smoke.json``, a byte copy of
    the reference's ``benchmarks/golden/bench_smoke.json``) — the
    simulator is a deterministic integer machine, so ANY drift is a
    semantic change (drift reports name each lane's (workload, mode,
    size) coordinates next to both cycle counts — see
    :func:`diff_cycles`).  The copy is the reference's record, so
    ``--update-golden`` never rewrites it: it writes this run's cycles to
    ``bench_smoke.json`` under ``--out`` instead, for a reader to compare
    with the reference's;
  * the sharded legs must reproduce the solo cycle counts exactly
    (sharding relocates lanes across devices, never changes them);
  * ``machine.engine_cache_size()`` must be exactly 1 after each full
    grid — more means a lane silently recompiled (the mode/geometry axes
    stopped being runtime data);
  * the fig17 sweep's ``packing_efficiency`` must be at least the
    unpacked baseline's occupied/padded fraction — less means the packer
    stopped co-tenanting small meshes and the padded PE axis is dead
    cost again;
  * the service legs must be bit-identical to their sequential
    baselines on one compiled engine, and on the dissimilar-runtime
    fig17 traffic the service's steady-state throughput must not drop
    below sequential ``run_many`` — less means continuous batching
    stopped paying for its scheduling overhead;
  * the static cost model's rank correlation with measured cycles must
    not go negative — anti-correlation means ``estimate_cycles``
    stopped tracking the machine and the planners' default hints are
    actively misleading;
  * the fast-forward legs must be cycle-identical to plain (any drift
    is a compression soundness bug), must not run meaningfully slower
    than plain on the congested fig17 grid (>= 0.9x: the two-speed
    chunk dispatch keeps the ff tick off the hot path), and must beat
    plain on the pointer chase (>= 1.2x wall-clock,
    ``dead_step_fraction`` >= 0.3) — less means event compression
    stopped firing on its own workload class.

    PYTHONPATH=src python -m repro_torch.bench.bench_ci --out experiments/ci_torch
    PYTHONPATH=src python -m repro_torch.bench.bench_ci --skip-fig17 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

import torch

from repro_torch.bench.serve_bench import smoke_workloads

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(__file__)), "golden",
                      "bench_smoke.json")
OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "experiments", "ci_torch")


def _meta(device="cuda") -> dict:
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    return dict(python=platform.python_version(), torch=torch.__version__,
                backend=dev.type,
                device_name=(torch.cuda.get_device_name(dev) if on_card
                             else platform.processor() or "cpu"),
                n_devices=torch.cuda.device_count() if on_card else 1)


def _flatten_cycles(grid: dict, prefix: str = "") -> dict:
    """Flatten a nested cycles table to ``{label: cycles}``.

    Labels name every lane coordinate on the way down — workload, then
    mode and/or mesh size (``spmv/nexus``, ``spmv/nexus@2x2``,
    ``bfs@8x8`` ...) — so a drift report points at the exact grid point
    instead of a bare number.  Leaves may be plain cycle counts or
    result rows carrying a ``cycles`` field.
    """
    out = {}
    for key, v in grid.items():
        sep = "@" if "x" in str(key) and str(key)[0].isdigit() else "/"
        label = f"{prefix}{sep}{key}" if prefix else str(key)
        if isinstance(v, dict):
            if "cycles" in v and not isinstance(v["cycles"], dict):
                out[label] = v["cycles"]
            else:
                out.update(_flatten_cycles(v, label))
        else:
            out[label] = v
    return out


def diff_cycles(want: dict, got: dict, *, want_name: str = "golden",
                got_name: str = "got") -> list[str]:
    """Labeled per-lane cycle diff of two (possibly nested) grid tables.

    Every message names the lane's (workload, mode, size) coordinates —
    the flattened label — next to both cycle counts, so drift output
    reads like ``cycle drift: spmv/nexus@2x2 golden=118 got=121``.
    """
    fw, fg = _flatten_cycles(want), _flatten_cycles(got)
    # remediation advice only fits the golden gate; shard-vs-solo (or
    # any other) comparisons name the sides instead.
    hint = (" (run --update-golden)" if want_name == "golden"
            else f" (absent from {want_name})")
    errors = []
    for label in sorted(fw):
        if label not in fg:
            errors.append(f"missing lane: {label} ({want_name}="
                          f"{fw[label]}, absent from {got_name})")
        elif fg[label] != fw[label]:
            errors.append(f"cycle drift: {label} {want_name}={fw[label]} "
                          f"{got_name}={fg[label]}")
    for label in sorted(set(fg) - set(fw)):
        errors.append(f"untracked grid point: {label}{hint}")
    return errors


def static_cost_corr(points: list[tuple[str, float, int]]) -> dict:
    """Rank-correlate static cycle estimates against measured cycles.

    ``points`` rows are ``(label, estimated, measured)`` — one per grid
    lane.  The artifact keeps the per-point table next to the Spearman
    coefficient so a correlation regression names the grid points that
    moved instead of reporting a bare number (JSON-safe: a degenerate
    correlation becomes ``None``, not NaN).
    """
    from repro_torch.analysis import rank_correlation
    corr = rank_correlation([p[1] for p in points],
                            [p[2] for p in points])
    return dict(
        rank_corr=None if corr != corr else round(corr, 4),
        n_points=len(points),
        points={label: dict(estimated=int(est), measured=int(meas))
                for label, est, meas in points})


def run_smoke(device="cuda") -> dict:
    """The tiny harness grid: one engine, one batched call, deterministic
    cycle counts — run solo AND with the lane axis sharded over every
    visible card of ``device``'s type (the same grid both ways; the
    sharded leg must reproduce the identical cycle counts)."""
    from repro_torch.bench import harness
    from repro_torch.core import machine
    from repro_torch.core.machine import MachineConfig
    wls = smoke_workloads()
    machine.clear_engine_cache()
    t0 = time.time()
    grid = harness.run_grid(wls, base_cfg=MachineConfig(width=2, height=2),
                            max_cycles=100_000, device=device)
    wall = time.time() - t0
    engines_solo = machine.engine_cache_size()

    def table_of(g):
        return {
            wl.name: {
                mode: dict(cycles=rows[i]["cycles"],
                           utilization=rows[i]["utilization"],
                           executed=rows[i]["executed"])
                for mode, rows in g.items()
            }
            for i, wl in enumerate(wls)
        }

    # cold-vs-cold: the solo leg above built its engine, so the sharded
    # leg starts from a fresh cache too — otherwise one card (where shard
    # reuses the very same engine) would record its warm rerun as a
    # phantom shard speedup.
    machine.clear_engine_cache()
    t0 = time.time()
    grid_sh, report_sh = harness.run_grid_report(
        wls, base_cfg=MachineConfig(width=2, height=2),
        max_cycles=100_000, shard=True, device=device)
    wall_sh = time.time() - t0
    engines_shard = machine.engine_cache_size()
    table = table_of(grid)
    shard_drift = diff_cycles(table, table_of(grid_sh),
                              want_name="solo", got_name="sharded")
    # static cost-model leg: estimate each lane with the pre-dispatch
    # verifier's cycle model and rank-correlate against the measured
    # grid.  Lanes are rebuilt with the same per-mode placement the
    # harness used, so estimate and measurement describe the same
    # compiled program; modes sharing a placement share an estimate
    # (the model is mode-sound — see repro_torch.analysis.cost).
    from repro_torch.analysis import estimate_cycles
    est_cache: dict = {}
    points = []
    for wl in wls:
        for mode, cell in table[wl.name].items():
            placement = harness._placement_for(mode)
            key = (wl.name, placement)
            if key not in est_cache:
                cfg = MachineConfig(width=2, height=2,
                                    mem_words=wl.mem_words,
                                    max_cycles=100_000)
                est_cache[key] = estimate_cycles(wl.build(cfg, placement))
            points.append((f"{wl.name}/{mode}", est_cache[key],
                           cell["cycles"]))
    static_cost = static_cost_corr(points)
    n_lanes = len(wls) * len(grid)
    return dict(meta=_meta(device), wall_s=round(wall, 3),
                wall_shard_s=round(wall_sh, 3),
                n_devices=report_sh.shard.n_devices,
                lanes_per_device=report_sh.shard.lanes_per_device,
                shard_drift=shard_drift,
                engine_cache_size=engines_solo,
                engine_cache_size_shard=engines_shard,
                lanes_per_engine=n_lanes / engines_solo,
                static_cost=static_cost,
                grid=table)


def run_fig17(device="cuda") -> dict:
    """The batched Fig. 17 sweep: the whole sizes x workloads grid as ONE
    packed sweep on one cached engine (small meshes co-scheduled inside
    shared padded super-lanes), plus a shard-vs-solo leg — the same grid
    with the lane axis sharded over every visible card, gated to produce
    identical cycle counts."""
    from repro_torch.bench import fig17 as fig17_scaling
    from repro_torch.core import machine
    machine.clear_engine_cache()
    t0 = time.time()
    data, report = fig17_scaling.run_grid_report(fig17_scaling._builders(),
                                                 device=device)
    wall = time.time() - t0
    engines_solo = machine.engine_cache_size()
    # cold-vs-cold, like run_smoke: both legs start from an empty cache.
    machine.clear_engine_cache()
    t0 = time.time()
    data_sh, report_sh = fig17_scaling.run_grid_report(
        fig17_scaling._builders(), shard=True, device=device)
    wall_sh = time.time() - t0
    engines_shard = machine.engine_cache_size()
    shard_drift = diff_cycles(data, data_sh,
                              want_name="solo", got_name="sharded")
    # static cost-model leg over the scaling grid: every (workload,
    # mesh-size) point is its own compiled lane (placement is
    # size-dependent), estimated by the pre-dispatch verifier and
    # rank-correlated against the measured sweep.
    from repro_torch.analysis import estimate_cycles
    points = [(f"{name}@{w}x{h}", estimate_cycles(wl),
               data[name][f"{w}x{h}"]["cycles"])
              for (w, h), name, wl in
              fig17_scaling.build_grid(fig17_scaling._builders())]
    static_cost = static_cost_corr(points)
    n_lanes = sum(len(v) for v in data.values())
    return dict(meta=_meta(device), wall_s=round(wall, 3),
                wall_shard_s=round(wall_sh, 3),
                n_devices=report_sh.shard.n_devices,
                lanes_per_device=report_sh.shard.lanes_per_device,
                shard_drift=shard_drift,
                engine_cache_size=engines_solo,
                engine_cache_size_shard=engines_shard,
                lanes_per_engine=n_lanes / engines_solo,
                packing_efficiency=report.pack.packing_efficiency,
                unpacked_efficiency=report.pack.unpacked_efficiency,
                n_waves=report.pack.n_waves,
                static_cost=static_cost,
                grid=data)


def _ff_compare(cfg, lanes, labels, *, pack=False, chunk=512,
                reps=2, device="cuda") -> dict:
    """Time the same sweep on the fast-forward and plain engines.

    BOTH engines are warmed (and results captured) before any timing
    rep — clearing the cache between legs would charge one side its
    engine's first calls — then ``reps`` interleaved reps each, best-of
    (each sweep returns its lanes' results on the host, so its wall
    includes the device work).  Returns
    the wall clocks, the speedup, the fast-forward run's
    ``dead_step_fraction`` telemetry, and the per-lane cycle drift
    (must be empty: compression is bit-identity by construction).
    """
    import dataclasses

    from repro_torch.core import machine
    from repro_torch.core.sweep import SweepRequest, sweep
    req = SweepRequest(workloads=lanes, pack=pack, chunk=chunk)
    cfg_ff = dataclasses.replace(cfg, fast_forward=True)
    cfg_pl = dataclasses.replace(cfg, fast_forward=False)
    machine.clear_engine_cache()
    rep_ff = sweep(cfg_ff, req, device=device)   # warms the ff engine
    rep_pl = sweep(cfg_pl, req, device=device)   # warms the plain engine
    engines = machine.engine_cache_size()
    drift = diff_cycles(
        {lb: r.cycles for lb, r in zip(labels, rep_ff)},
        {lb: r.cycles for lb, r in zip(labels, rep_pl)},
        want_name="fast_forward", got_name="plain")
    t_ff, t_pl = [], []
    for _ in range(reps):
        t0 = time.time()
        sweep(cfg_ff, req, device=device)
        t_ff.append(time.time() - t0)
        t0 = time.time()
        sweep(cfg_pl, req, device=device)
        t_pl.append(time.time() - t0)
    wall_ff, wall_pl = min(t_ff), min(t_pl)
    tel = rep_ff.telemetry
    return dict(wall_ff_s=round(wall_ff, 3),
                wall_plain_s=round(wall_pl, 3),
                speedup=round(wall_pl / wall_ff, 3),
                dead_step_fraction=round(tel.dead_step_fraction, 4),
                stepped_pe_ticks=tel.stepped_pe_ticks,
                plain_pe_ticks=tel.plain_pe_ticks,
                engine_cache_size=engines,
                drift=drift)


def run_fast_forward(traffic: str, device="cuda") -> dict:
    """The event-compression leg: the same sweep on the fast-forward
    (default) and plain (``fast_forward=False``) engines, wall-clock
    and ``dead_step_fraction`` recorded, per-lane cycles gated
    bit-identical.

    Two traffic shapes, matching the two regimes:

      * ``fig17`` — the packed scaling grid.  Its critical lanes are
        CONGESTED (many flits in flight), so compression rarely proves a
        sub-lane quiet and the honest expectation is parity; the gate
        checks ff never runs meaningfully slower than plain (the
        two-speed chunk dispatch keeps the ff tick off the hot path).
      * ``chain`` — a scrambled 512-node pointer chase (BFS over
        :func:`repro_torch.bench.workloads.pointer_chase_graph` on 8x8): a
        serial message endlessly crossing the mesh alone, the workload
        class event compression exists for — here the leg demonstrates
        the actual win (``dead_step_fraction`` ~0.5, wall-clock well
        above 1x).
    """
    from repro_torch.bench.workloads import pointer_chase_graph
    from repro_torch.core import compiler
    from repro_torch.core.machine import MachineConfig
    if traffic == "fig17":
        from repro_torch.bench import fig17 as fig17_scaling
        grid = fig17_scaling.build_grid(fig17_scaling._builders())
        return _ff_compare(fig17_scaling._size_cfg(2, 2),
                           [wl for _, _, wl in grid],
                           [f"{name}@{w}x{h}" for (w, h), name, _ in grid],
                           pack=True, device=device)
    cfg = MachineConfig(width=8, height=8, mem_words=8192,
                        max_cycles=400_000)
    # "chain_smoke" is the same shape scaled down for the smoke
    # artifact: the dead_step_fraction trail accumulates there too, but
    # the runs are too short to gate wall-clock on.
    n_nodes, n_lanes = (128, 4) if traffic == "chain_smoke" else (512, 8)
    rowptr, col, src = pointer_chase_graph(n_nodes)
    wl = compiler.build_bfs(rowptr, col, src, cfg)
    # the smoke chain retires in under two default 512-cycle chunks,
    # which would hide the compression from the chunk-granular
    # telemetry — slice finer there.
    return _ff_compare(cfg, [wl] * n_lanes,
                       [f"pointer_chase/{i}" for i in range(n_lanes)],
                       chunk=128 if traffic == "chain_smoke" else 512,
                       device=device)


def run_service(traffic: str, device="cuda") -> dict:
    """The continuous-batching leg: the same traffic through the
    resident :class:`repro_torch.serve.SweepService` (steady state, warm
    engine) vs sequential blocking per-lane ``run_many`` calls — see
    :mod:`repro_torch.bench.serve_bench`.  Records steady-state lanes/s both
    ways, the speedup, and the service's mid-wave refill occupancy;
    results are checked bit-identical before anything is reported."""
    from repro_torch.bench import serve_bench
    if traffic == "fig17":
        # fine slices (128-cycle chunks, retire/refill between every
        # chunk) are the service's throughput lever on this traffic:
        # every lane finishes in well under one default 512-cycle
        # chunk, which each blocking call pays in full.
        cfg, lanes = serve_bench.fig17_traffic(copies=2)
        return serve_bench.service_throughput(
            cfg, lanes, chunk=128, slice_chunks=1, label=traffic,
            device=device)
    cfg, lanes = serve_bench.smoke_traffic(copies=2)
    return serve_bench.service_throughput(cfg, lanes, label=traffic,
                                          device=device)


def check_golden(smoke: dict, update: bool, *,
                 out: str | None = None) -> list[str]:
    """Compare smoke-grid cycles against the golden values.

    Drift reports go through :func:`diff_cycles`, so every violation
    names its lane's (workload, mode) coordinates next to both cycle
    counts instead of a bare value diff.  With ``update`` this run's
    cycles are written to ``bench_smoke.json`` under ``out`` (default
    :data:`OUT`) and nothing is gated: :data:`GOLDEN` is the reference's
    record, never rewritten from a run of the port.
    """
    got = {name: {mode: row["cycles"] for mode, row in modes.items()}
           for name, modes in smoke["grid"].items()}
    if update:
        path = os.path.join(OUT if out is None else out, "bench_smoke.json")
        if os.path.realpath(path) == os.path.realpath(GOLDEN):
            raise ValueError(f"--update-golden would overwrite {GOLDEN}, "
                             "the reference's record")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(got, f, indent=1, sort_keys=True)
        print(f"this run's smoke cycles written to {path} "
              f"(the golden {GOLDEN} is left as it is)")
        return []
    if not os.path.exists(GOLDEN):
        return [f"golden file missing: {GOLDEN}"]
    with open(GOLDEN) as f:
        want = json.load(f)
    return diff_cycles(want, got)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT,
                    help="artifact output directory")
    ap.add_argument("--update-golden", action="store_true",
                    help="write this run's smoke cycles to "
                         "OUT/bench_smoke.json instead of gating on the "
                         "golden (which stays the reference's record)")
    ap.add_argument("--skip-fig17", action="store_true",
                    help="smoke grid + golden gate only (quick)")
    ap.add_argument("--device", default="cuda",
                    help="the simulator's device")
    args = ap.parse_args(argv)
    device = args.device

    os.makedirs(args.out, exist_ok=True)
    failures: list[str] = []

    smoke = run_smoke(device)
    smoke["service"] = run_service("smoke", device)
    smoke["fast_forward"] = run_fast_forward("chain_smoke", device)
    with open(os.path.join(args.out, "BENCH_fig11.json"), "w") as f:
        json.dump(smoke, f, indent=1)
    print(f"smoke grid: wall={smoke['wall_s']}s "
          f"(sharded {smoke['wall_shard_s']}s on {smoke['n_devices']} "
          f"device(s), {smoke['lanes_per_device']} lanes/device) "
          f"engines={smoke['engine_cache_size']}")
    if smoke["engine_cache_size"] != 1:
        failures.append("smoke grid compiled "
                        f"{smoke['engine_cache_size']} engines (want 1): "
                        "a lane axis stopped being runtime data")
    if smoke["engine_cache_size_shard"] != 1:
        failures.append("smoke SHARDED grid compiled "
                        f"{smoke['engine_cache_size_shard']} engines "
                        "(want 1): the sharded path silently recompiled")
    failures += check_golden(smoke, args.update_golden, out=args.out)
    failures += [f"smoke shard leg: {msg}" for msg in smoke["shard_drift"]]
    sc = smoke["static_cost"]
    print(f"smoke static cost model: rank_corr={sc['rank_corr']} over "
          f"{sc['n_points']} grid points")
    if sc["rank_corr"] is not None and sc["rank_corr"] < 0.0:
        failures.append(
            f"smoke static cost model anti-correlated with measured "
            f"cycles (rank_corr={sc['rank_corr']}): estimate_cycles "
            "stopped tracking the machine")
    svc = smoke["service"]
    print(f"smoke service leg: sequential {svc['seq_lanes_per_s']} lanes/s, "
          f"service {svc['service_lanes_per_s']} lanes/s "
          f"({svc['speedup']:.2f}x), refill occupancy "
          f"{svc['refill_occupancy']:.2f}")
    failures += [f"smoke service leg: {msg}" for msg in svc["drift"]]
    if svc["engine_cache_size"] != 1:
        failures.append("smoke service leg compiled "
                        f"{svc['engine_cache_size']} engines (want 1): "
                        "the service arena stopped hitting the cache")
    ffs = smoke["fast_forward"]
    print(f"smoke fast-forward leg (pointer chase): ff {ffs['wall_ff_s']}s "
          f"vs plain {ffs['wall_plain_s']}s ({ffs['speedup']:.2f}x), "
          f"dead_step_fraction={ffs['dead_step_fraction']:.2f}")
    failures += [f"smoke fast-forward leg: {msg}" for msg in ffs["drift"]]

    if not args.skip_fig17:
        fig17 = run_fig17(device)
        fig17["service"] = run_service("fig17", device)
        fig17["fast_forward"] = run_fast_forward("fig17", device)
        fig17["fast_forward_chain"] = run_fast_forward("chain", device)
        with open(os.path.join(args.out, "BENCH_fig17.json"), "w") as f:
            json.dump(fig17, f, indent=1)
        print(f"fig17 sweep: wall={fig17['wall_s']}s "
              f"(sharded {fig17['wall_shard_s']}s on "
              f"{fig17['n_devices']} device(s), "
              f"{fig17['lanes_per_device']} lanes/device) "
              f"engines={fig17['engine_cache_size']} "
              f"packing_efficiency={fig17['packing_efficiency']:.3f} "
              f"(unpacked {fig17['unpacked_efficiency']:.3f}, "
              f"{fig17['n_waves']} waves)")
        failures += [f"fig17 shard leg: {msg}"
                     for msg in fig17["shard_drift"]]
        sc17 = fig17["static_cost"]
        print(f"fig17 static cost model: rank_corr={sc17['rank_corr']} "
              f"over {sc17['n_points']} grid points")
        if sc17["rank_corr"] is not None and sc17["rank_corr"] < 0.0:
            failures.append(
                f"fig17 static cost model anti-correlated with measured "
                f"cycles (rank_corr={sc17['rank_corr']}): "
                "estimate_cycles stopped tracking the machine")
        if fig17["engine_cache_size_shard"] != 1:
            failures.append("fig17 SHARDED sweep compiled "
                            f"{fig17['engine_cache_size_shard']} engines "
                            "(want 1): the sharded path silently "
                            "recompiled")
        if fig17["engine_cache_size"] != 1:
            failures.append("fig17 size grid compiled "
                            f"{fig17['engine_cache_size']} engines "
                            "(want 1): geometry stopped being runtime "
                            "data")
        if fig17["packing_efficiency"] < fig17["unpacked_efficiency"]:
            failures.append(
                "fig17 packing efficiency "
                f"{fig17['packing_efficiency']:.3f} fell below the "
                f"unpacked baseline {fig17['unpacked_efficiency']:.3f}: "
                "the packer stopped co-tenanting small meshes")
        svc17 = fig17["service"]
        print(f"fig17 service leg: sequential {svc17['seq_lanes_per_s']} "
              f"lanes/s, service {svc17['service_lanes_per_s']} lanes/s "
              f"({svc17['speedup']:.2f}x), refill occupancy "
              f"{svc17['refill_occupancy']:.2f}, {svc17['n_refills']} "
              "mid-wave refills")
        failures += [f"fig17 service leg: {msg}" for msg in svc17["drift"]]
        if svc17["engine_cache_size"] != 1:
            failures.append("fig17 service leg compiled "
                            f"{svc17['engine_cache_size']} engines "
                            "(want 1): the service arena stopped hitting "
                            "the cache")
        if svc17["speedup"] < 1.0:
            failures.append(
                "fig17 service throughput "
                f"{svc17['service_lanes_per_s']} lanes/s fell below the "
                f"sequential run_many baseline "
                f"{svc17['seq_lanes_per_s']} lanes/s "
                f"({svc17['speedup']:.2f}x): continuous batching stopped "
                "paying for itself")
        ff17 = fig17["fast_forward"]
        ffch = fig17["fast_forward_chain"]
        print(f"fig17 fast-forward leg: ff {ff17['wall_ff_s']}s vs plain "
              f"{ff17['wall_plain_s']}s ({ff17['speedup']:.2f}x), "
              f"dead_step_fraction={ff17['dead_step_fraction']:.2f}; "
              f"pointer chase: ff {ffch['wall_ff_s']}s vs plain "
              f"{ffch['wall_plain_s']}s ({ffch['speedup']:.2f}x), "
              f"dead_step_fraction={ffch['dead_step_fraction']:.2f}")
        failures += [f"fig17 fast-forward leg: {msg}"
                     for msg in ff17["drift"]]
        failures += [f"fig17 fast-forward chain leg: {msg}"
                     for msg in ffch["drift"]]
        # fig17's critical lanes are congested, so parity is the honest
        # expectation there — the gate is "compression never costs":
        # the two-speed chunk dispatch must keep the ff tick off the
        # hot path (0.9 absorbs runner noise around 1.0x).
        if ff17["speedup"] < 0.9:
            failures.append(
                f"fig17 fast-forward leg ran {ff17['speedup']:.2f}x vs "
                "plain (want >= 0.9): the compressed engine slowed the "
                "congested grid down")
        # the pointer chase is the demonstration: most plain PE-steps
        # are dead transit, and skipping them must show up on the wall
        # clock.
        if ffch["speedup"] < 1.2:
            failures.append(
                f"fast-forward pointer-chase leg ran {ffch['speedup']:.2f}x "
                "vs plain (want >= 1.2): event compression stopped "
                "paying on its own workload class")
        if ffch["dead_step_fraction"] < 0.3:
            failures.append(
                "fast-forward pointer-chase dead_step_fraction "
                f"{ffch['dead_step_fraction']:.2f} (want >= 0.3): "
                "lone-flight stretches stopped being compressed")

    if failures:
        print("\nPERF-REGRESSION GATE FAILED:", file=sys.stderr)
        for msg in failures:
            print(f"  - {msg}", file=sys.stderr)
        return 1
    print("bench artifacts written; perf gates green")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
