"""How the traffic files' kernel sizes were found (run on the CPU, once).

Each kernel keeps its kind, densities, degree and distribution and is
scaled in its one size key (rows, tokens, pixels or vertices) to the
largest size that

1. the program's compiler and its static checks (the ones ``submit``
   runs) accept on every mesh and placement the cell compiles it for,
   within the configuration's per-PE AM queue (``queue_cap``), memory
   (``mem_words``) and stream wait queue (``stream_wait_cap``), on the
   structure the benchmark runs (drawn from the traffic file's
   ``pattern_seed`` and graph seeds; ``--seed`` only changes values,
   which move none of these), and
2. carries at most ``--messages`` active messages, as the program's
   static walk of the compiled lane counts them (static AMs plus the
   messages their streams spawn; for the two relaxation kernels the
   walk's estimate).

The sizes are then written into the traffic file as fixed numbers; the
benchmark never runs this.  ::

    PYTHONPATH=src python3 nexusbench/sizing.py --traffic fig11-modes --config nexus-4x4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from concurrent.futures import ProcessPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.join(os.path.dirname(HERE),
                                                    "src")]

from nexusbench import harness  # noqa: E402
from nexusbench.inputs import structure  # noqa: E402

#: the one size key of each kind
SIZE_KEY = dict(spmspm="n", spmadd="n", matmul="n", spmv="m", mv="m",
                sddmm="s", conv="h", bfs="nodes", sssp="nodes",
                pagerank="nodes")


def _fits(spec, cfgs, strategies, traffic, i, messages) -> tuple[bool, int]:
    from repro_torch.analysis import check_workload, error_findings, lift
    msgs = -1
    inp = structure(traffic, i, spec)
    for cfg in cfgs:
        for strat in strategies:
            try:
                wl = harness.compile_lane(spec["kind"], inp, cfg, strat)
            except MemoryError:
                return False, -1
            if error_findings(check_workload(
                    wl, stream_wait_cap=cfg.stream_wait_cap)):
                return False, -1
            msgs = max(msgs, int(lift(wl).n_messages))
            if msgs > messages:
                return False, msgs
    return True, msgs


def largest(spec, cfgs, strategies, traffic, i, messages
            ) -> tuple[int, int]:
    key = SIZE_KEY[spec["kind"]]

    def fits(size):
        return _fits(dict(spec, **{key: size}), cfgs, strategies, traffic,
                     i, messages)
    lo = spec[key]
    ok, best = fits(lo)
    while not ok:           # the start does not fit: step down
        lo = max(1, lo * 3 // 4)
        ok, best = fits(lo)
    hi, step = None, lo
    while hi is None:
        ok, m = fits(lo + step)
        if ok:
            lo, best, step = lo + step, m, step * 2
        else:
            hi = lo + step
    while hi - lo > 1:
        mid = (lo + hi) // 2
        ok, m = fits(mid)
        if ok:
            lo, best = mid, m
        else:
            hi = mid
    return lo, best


def _one(job):
    spec, cfgs, strategies, traffic, i, messages = job
    size, msgs = largest(spec, cfgs, strategies, traffic, i, messages)
    return dict(name=spec["name"], key=SIZE_KEY[spec["kind"]], size=size,
                messages=msgs)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--messages", type=int, default=65536)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--only", nargs="*", help="kernels to size (all)")
    args = ap.parse_args()
    traffic = harness.load_json("traffic", args.traffic)
    base = harness.machine_config(harness.load_json("configs", args.config))
    cfgs = [dataclasses.replace(base, width=w, height=h)
            for w, h in traffic["pool"]["meshes"]]
    strategies = sorted({traffic["pool"]["placement"][m]
                         for m in traffic["pool"]["modes"]})
    jobs = [(spec, cfgs, strategies, traffic, i, args.messages)
            for i, spec in enumerate(traffic["kernels"])
            if not args.only or spec["name"] in args.only]
    with ProcessPoolExecutor(args.workers) as ex:
        for out in ex.map(_one, jobs):
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
