"""The benchmark's control: the reference put in the program's place with
one active message of each lane lost (``reference.control``), which
breaks the configurations' exactly-once delivery guarantee.  Its lanes
go through the same check as a run's (``harness.judge``): the warm pass
over the pool, then as many lanes of the clients' order as a run
compares, each lane's answer the control's and its record the reference
simulator's.  It has to come out as not correct.

    python3 nexusbench/control.py --workload <cell> --lanes 600 --seeds 11 12 13

The benchmark's own runs never run it, and it needs no card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE)]

from nexusbench import harness, inputs, reference  # noqa: E402


def readings(cell_name: str, seed: int, n_lanes: int,
             bench: dict | None = None) -> dict:
    """The numbers ``correct`` compares, each with its limit, and
    ``correct``, with the control's lanes in the program's place."""
    bench = bench or harness.load_benchmark()
    c = harness.cell(cell_name, bench)
    wl = next(w for w in bench["workloads"] if w["name"] == cell_name)
    records = harness.load_records(wl["config"], wl["traffic"], c.config)
    pool = harness.pool_lanes(c.traffic)
    inps = inputs.draw_traffic(c.traffic, seed)
    seen = {}

    def lane(i):
        if i not in seen:
            p = pool[i]
            seen[i] = harness.Seen(True,
                                   reference.control(p.kind, inps[p.kernel]),
                                   records[p.name])
        return i, seen[i]
    picks = harness.order(c.traffic, len(pool))
    lanes = ([lane(i) for i in range(len(pool))]
             + [lane(next(picks)) for _ in range(n_lanes)])
    compared, _ = harness.judge(pool, inps, records, lanes)
    return dict(workload=cell_name, seed=seed, lanes=n_lanes,
                correct=all(v <= lim for v, lim in compared.values()),
                compared={k: dict(value=v, limit=lim)
                          for k, (v, lim) in compared.items()})


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--lanes", type=int, required=True,
                    help="window lanes to compare, as many as a run does")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.lanes)),
              flush=True)


if __name__ == "__main__":
    main()
