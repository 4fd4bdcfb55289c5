"""Perf hillclimbing on the dry run: hypothesis -> change -> re-count ->
validate on a cell, plus fabric-size autotuning on the cycle-level
simulator.

The port of the reference's ``benchmarks/hillclimb.py``.  Each variant is
a (policy, microbatch, flags) override on top of the baseline
``TRAIN_POLICY``; every run re-counts the cell's step on fake tensors
over the production mesh's fake process group
(:func:`repro_torch.launch.dryrun.run_cell`) and records the three
roofline terms at the H100 constants of
:class:`repro_torch.launch.roofline.RooflineTerms`.  Records land in
``experiments/perf_torch/<arch>__<shape>__<variant>.json``:

    PYTHONPATH=src python -m repro_torch.bench.hillclimb --cell minitron_4b:train_4k \\
        --variant baseline --variant remat_none ...

Fabric-size autotuning (``--fabric``): every candidate mesh geometry is a
lane of ONE batched sweep (the geometry is runtime data, so the whole
candidate set shares one engine and one call), on the card unless
``--device`` names another:

    PYTHONPATH=src python -m repro_torch.bench.hillclimb --fabric spmv \\
        --sizes 2x2,2x4,4x4,4x8,8x8
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch import dryrun as dr
from repro_torch.launch import roofline as rl

OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "experiments", "perf_torch")

FABRIC_SIZES = [(2, 2), (2, 4), (4, 4), (4, 8), (8, 8)]

# variant name -> dict(policy=(remat, seqshard, microbatch), arch=<cfg
# dataclass overrides>)
VARIANTS = {
    "baseline": {},
    "remat_none": dict(remat="none"),
    "remat_full": dict(remat="full"),
    "remat_dots": dict(remat="dots"),
    "seqshard_on": dict(seqshard=True),
    "seqshard_off": dict(seqshard=False),
    "mb2": dict(microbatch=2),
    "mb4": dict(microbatch=4),
    "mb8": dict(microbatch=8),
    "block_causal": dict(arch=dict(block_causal=True)),
    "bc_remat_none": dict(arch=dict(block_causal=True), remat="none"),
    "bc_mb2": dict(arch=dict(block_causal=True), microbatch=2),
}


def run_variant(arch: str, shape: str, variant: str, *, pair: bool = True,
                device="cuda"):
    """Count one variant of a single-pod cell and save its record."""
    base = dr.TRAIN_POLICY.get(arch, ("dots", False, 1))
    ov = VARIANTS[variant]
    policy = (ov.get("remat", base[0]), ov.get("seqshard", base[1]),
              ov.get("microbatch", base[2]))
    rec = dr.run_cell(arch, shape, False, pair=pair, save=False,
                      policy=policy, arch_overrides=ov.get("arch"),
                      device=device)
    os.makedirs(OUT, exist_ok=True)
    tag = f"{arch}__{shape}__{variant}"
    with open(os.path.join(OUT, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def terms(rec):
    flops = rec.get("flops_corrected", rec["flops_reported"])
    byts = rec.get("bytes_corrected", rec["bytes_reported"])
    coll = rec.get("coll_corrected", rec["collective_total"])
    return rl.RooflineTerms(
        flops=flops, hbm_bytes=byts, coll_bytes=coll,
        coll_breakdown=rec["collective_bytes"], chips=rec["chips"],
        model_flops=rec["model_flops"])


def fmt(rec):
    t = terms(rec)
    return (f"T_comp={t.t_compute:7.3f}s T_mem={t.t_memory:7.3f}s "
            f"T_coll={t.t_collective:7.3f}s bound={t.dominant:<10} "
            f"useful={100*t.useful_flops_frac:5.1f}% "
            f"roofline={100*t.mfu_bound:5.1f}%")


def fabric_autotune(workload: str = "spmv", sizes=None, *,
                    builders=None, save: bool = True,
                    pack: bool = True, shard: bool = False,
                    device="cuda") -> dict:
    """Pick the best mesh geometry for a workload by running EVERY
    candidate as a lane of one batched sweep on ``device``.

    With ``pack`` (default) the candidate meshes are co-scheduled as
    disjoint sub-meshes of shared padded super-lanes
    (``SweepRequest(pack=True)``); the packing plan the search ran over is
    logged in the record.  ``shard=True`` additionally fans the candidate
    lanes out over every visible card (bit-identical; one card: the plain
    engine).  Scores both ends of the trade: latency (cycles) and
    efficiency (cycles x PEs, the area-delay proxy).  Returns the scored
    table with the argmin of each; with ``save`` the record lands in
    ``experiments/perf_torch/fabric__<workload>.json``.
    """
    from repro_torch.bench.fig17 import _builders, _size_cfg
    from repro_torch.core import machine
    from repro_torch.core.sweep import SweepRequest, sweep
    if builders is None:
        builders = _builders()
    if workload not in builders:
        raise ValueError(f"unknown fabric workload {workload!r}; "
                         f"known: {sorted(builders)}")
    sizes = FABRIC_SIZES if sizes is None else list(sizes)
    lanes = [builders[workload](_size_cfg(w, h)) for (w, h) in sizes]
    report = sweep(_size_cfg(*sizes[0]),
                   SweepRequest(workloads=lanes, pack=pack, shard=shard),
                   device=device)
    table = {}
    for (w, h), wl, r in zip(sizes, lanes, report.lanes):
        if not (r.completed and wl.check(r.mem_val)):
            raise RuntimeError(f"{workload} @ {w}x{h}: no idle or WRONG "
                               "RESULT")
        table[f"{w}x{h}"] = dict(
            cycles=r.cycles, pes=w * h, cycle_pes=r.cycles * w * h,
            utilization=r.utilization)
    best_lat = min(table, key=lambda k: table[k]["cycles"])
    best_eff = min(table, key=lambda k: table[k]["cycle_pes"])
    rec = dict(workload=workload, table=table, best_latency=best_lat,
               best_efficiency=best_eff,
               engine_cache_size=machine.engine_cache_size(),
               packed=pack,
               pack_stats=report.pack.to_json() if report.pack else None,
               sharded=shard,
               shard_stats=report.shard.to_json() if report.shard else None)
    if save:
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, f"fabric__{workload}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _parse_sizes(spec: str):
    return [tuple(int(t) for t in s.split("x")) for s in spec.split(",")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None, help="arch:shape")
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--no-pair", action="store_true")
    ap.add_argument("--fabric", default=None, metavar="WORKLOAD",
                    help="autotune the simulator mesh size for WORKLOAD "
                         "(one batched run over --sizes)")
    ap.add_argument("--sizes", default=None,
                    help="candidate geometries, e.g. 2x2,4x4,8x8")
    ap.add_argument("--pack", dest="pack", action="store_true",
                    default=True,
                    help="co-schedule candidate meshes as sub-meshes of "
                         "shared padded super-lanes (default)")
    ap.add_argument("--no-pack", dest="pack", action="store_false",
                    help="one padded lane per candidate (the pre-packing "
                         "behaviour)")
    ap.add_argument("--shard", action="store_true",
                    help="fan candidate lanes out over every visible card "
                         "(bit-identical; the plain engine on one card)")
    ap.add_argument("--device", default="cuda",
                    help="the simulator's (or the fake tensors') device")
    args = ap.parse_args(argv)
    if args.fabric:
        sizes = _parse_sizes(args.sizes) if args.sizes else None
        rec = fabric_autotune(args.fabric, sizes, pack=args.pack,
                              shard=args.shard, device=args.device)
        for sz, row in rec["table"].items():
            print(f"{args.fabric} @ {sz:<5} cycles={row['cycles']:>8} "
                  f"cycle*PEs={row['cycle_pes']:>9} "
                  f"util={row['utilization']:.2f}")
        print(f"best latency: {rec['best_latency']}   "
              f"best efficiency: {rec['best_efficiency']}   "
              f"(engines cached: {rec['engine_cache_size']})")
        if rec.get("shard_stats"):
            ss = rec["shard_stats"]
            print(f"candidates sharded over {ss['n_devices']} device(s), "
                  f"{ss['lanes_per_device']} lanes/device")
        if rec.get("pack_stats"):
            ps = rec["pack_stats"]
            print(f"packing plan searched: {ps['n_waves']} wave(s), "
                  f"efficiency {ps['packing_efficiency']:.2f} "
                  f"(unpacked {ps['unpacked_efficiency']:.2f})")
            for wv, wave in enumerate(ps["plan"]):
                placed = ", ".join(
                    f"lane{p['lane']}@({p['origin'][0]},{p['origin'][1]}) "
                    f"{p['geom'][0]}x{p['geom'][1]}"
                    for p in wave["lanes"])
                print(f"  wave {wv}: {placed}")
        return
    if not args.cell:
        raise SystemExit("need --cell arch:shape (or --fabric WORKLOAD)")
    arch, shape = args.cell.split(":")
    variants = args.variant or ["baseline"]
    for v in variants:
        rec = run_variant(arch, shape, v, pair=not args.no_pair,
                          device=args.device)
        print(f"{arch} x {shape} [{v:<12}] {fmt(rec)}")


if __name__ == "__main__":
    main()
