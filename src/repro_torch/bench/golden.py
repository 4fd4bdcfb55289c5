"""The paper grids and their golden results (``golden/paper_grid.json``).

The golden file holds the JAX reference's results for two grids:

* ``grid_a``: every ``make_all()`` workload x nexus / tia / tia_valiant
  on the default 4x4 mesh (the Figs. 11-14 grid, 39 lanes);
* ``grid_b``: spmv, sddmm and bfs under nexus at 2x2, 4x4 and 8x8 (the
  padded traced-geometry axis of Fig. 17).

Each lane records ``RunResult.to_json()``, the full per-PE stall matrix
and a sha256 of the lane's ``mem_val`` image.  A test regenerates the
file from the reference and fails on any difference; a run on the card
is held to it bit for bit with :func:`check_lanes`.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "golden", "paper_grid.json")
MAX_CYCLES = 400_000

#: name -> (workload names or None for all, modes or None for all, sizes)
GRIDS = {
    "grid_a": dict(workloads=None, modes=None, sizes=None),
    "grid_b": dict(workloads=["spmv", "sddmm", "bfs"], modes=["nexus"],
                   sizes=[[2, 2], [4, 4], [8, 8]]),
}


def grid_workloads(spec: dict, all_wls: list) -> list:
    """The workloads of a grid spec, in ``make_all()`` order."""
    names = spec["workloads"]
    return list(all_wls) if names is None else \
        [w for w in all_wls if w.name in names]


def lane_record(res) -> dict:
    """The golden record of one lane's ``RunResult`` (reference's or
    port's: both have the same fields)."""
    rec = res.to_json()
    rec["stall_per_pe_port"] = np.asarray(res.stall_per_port).tolist()
    mem = np.ascontiguousarray(np.asarray(res.mem_val, np.int32))
    rec["mem_shape"] = list(mem.shape)
    rec["mem_sha256"] = hashlib.sha256(mem.tobytes()).hexdigest()
    return rec


def lane_key(workload: str, mode, size) -> str:
    at = "" if size is None else f"@{size[0]}x{size[1]}"
    return f"{workload}/{mode}{at}"


def load_golden(path: str = GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def check_lanes(got: dict, want: dict) -> None:
    """Raise unless the ``{lane_key: record}`` maps are equal."""
    if list(got) != list(want):
        raise AssertionError(f"lane sets differ: {list(got)} vs "
                             f"{list(want)}")
    bad = [k for k in want if got[k] != want[k]]
    if bad:
        k = bad[0]
        diff = {f: (got[k].get(f), want[k][f]) for f in want[k]
                if got[k].get(f) != want[k][f]}
        raise AssertionError(f"{len(bad)} lanes differ from the golden "
                             f"results, first {k}: {diff}")
