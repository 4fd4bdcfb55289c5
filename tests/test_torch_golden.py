"""The golden file the card run is held to (``paper_grid.json``): it must
be exactly what the JAX reference gives today, and the port's engine must
meet it.

Regenerate ``src/repro_torch/golden/paper_grid.json`` from the reference
with::

    PYTHONPATH=src:. python tests/test_torch_golden.py
"""
import json

import pytest

torch = pytest.importorskip("torch")

from benchmarks import harness as ref_harness  # noqa: E402
from benchmarks.workloads import make_all as ref_make_all  # noqa: E402

from repro_torch.bench import golden, harness  # noqa: E402
from repro_torch.bench.workloads import make_all  # noqa: E402

N_LANES = {"grid_a": 39, "grid_b": 9}


def reference_golden(name: str) -> dict:
    """Run one paper grid through the JAX reference and return its golden
    records (one top-level entry of ``paper_grid.json``)."""
    spec = golden.GRIDS[name]
    wls = golden.grid_workloads(spec, ref_make_all())
    modes = spec["modes"] or list(ref_harness.PLACEMENT)
    sizes = spec["sizes"]
    _, report = ref_harness.run_grid_report(
        wls, modes, max_cycles=golden.MAX_CYCLES, sizes=sizes)
    keys = [golden.lane_key(w.name, m, s) for m in modes
            for s in (sizes or [None]) for w in wls]
    return dict(spec=spec, max_cycles=golden.MAX_CYCLES,
                lanes={k: golden.lane_record(r)
                       for k, r in zip(keys, report.lanes)})


@pytest.mark.parametrize("name", list(golden.GRIDS))
def test_golden_file_matches_reference(name):
    """(e) the committed golden records of each grid are exactly what the
    reference gives today, so the card run cannot be held to a stale
    file."""
    want = golden.load_golden()
    assert list(want) == list(golden.GRIDS)
    got = json.loads(json.dumps(reference_golden(name)))
    assert got["spec"] == want[name]["spec"]
    assert got["max_cycles"] == want[name]["max_cycles"]
    golden.check_lanes(got["lanes"], want[name]["lanes"])
    assert len(want[name]["lanes"]) == N_LANES[name]


def test_port_grid_matches_golden_small_lanes():
    """The port's engine on the CPU against the golden records, on the
    grid B lanes that finish quickly (the card run checks every lane)."""
    spec = dict(golden.GRIDS["grid_b"], workloads=["bfs"])
    want = golden.load_golden()["grid_b"]["lanes"]
    wls = golden.grid_workloads(spec, make_all())
    lanes, _ = harness.run_grid_lanes(
        wls, spec["modes"], max_cycles=golden.MAX_CYCLES,
        sizes=spec["sizes"], device="cpu")
    got = {golden.lane_key(ln.workload.name, ln.mode, ln.size):
           golden.lane_record(ln.result) for ln in lanes}
    assert len(got) == 3
    golden.check_lanes(got, {k: want[k] for k in got})


if __name__ == "__main__":
    with open(golden.GOLDEN_PATH, "w") as f:
        json.dump({name: reference_golden(name) for name in golden.GRIDS}, f,
                  indent=1)
        f.write("\n")
    print("wrote", golden.GOLDEN_PATH)
