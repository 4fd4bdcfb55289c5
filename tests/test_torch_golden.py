"""The golden files the card run is held to (``paper_grid.json``,
``sweeps.json``, ``service.json``): they must be exactly what the JAX
reference gives today, and the port's engine must meet them.

Regenerate ``src/repro_torch/golden/paper_grid.json``,
``src/repro_torch/golden/sweeps.json`` and
``src/repro_torch/golden/service.json`` from the reference with::

    PYTHONPATH=src:. python tests/test_torch_golden.py
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import fig17_scaling as ref_fig17  # noqa: E402
from benchmarks import harness as ref_harness  # noqa: E402
from benchmarks import serve_bench as ref_serve_bench  # noqa: E402
from benchmarks import workloads as ref_workloads  # noqa: E402
from benchmarks.workloads import make_all as ref_make_all  # noqa: E402
from repro.core import compiler as ref_compiler  # noqa: E402
from repro.core import machine as ref_machine  # noqa: E402
from repro.core.machine import MachineConfig as RefConfig  # noqa: E402
from repro.core.sweep import SweepRequest as RefRequest  # noqa: E402
from repro.core.sweep import sweep as ref_sweep  # noqa: E402

from repro_torch.bench import fig17, golden, harness  # noqa: E402
from repro_torch.bench import serve_bench  # noqa: E402
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


def reference_sweep(name: str) -> dict:
    """Run one sweep leg through the JAX reference and return its golden
    record (one top-level entry of ``sweeps.json``)."""
    cfg, kw, keys = golden.sweep_leg(
        name, compiler=ref_compiler, config=RefConfig,
        workloads=ref_workloads, fig17=ref_fig17)
    return golden.sweep_record(name, keys, ref_sweep(cfg, RefRequest(**kw)))


def reference_service() -> dict:
    """The service traffic through the JAX reference's ``run_many``: the
    whole of ``service.json``."""
    cfg, lanes = ref_serve_bench.fig17_traffic(golden.SERVICE["copies"])
    return golden.service_record(
        ref_machine.run_many, cfg, lanes,
        golden.service_lane_keys(fig17.SIZES))


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


@pytest.mark.parametrize("name", list(golden.SWEEPS))
def test_sweep_golden_matches_reference(name):
    """The committed sweep records (lanes, packing schedule, engine
    telemetry) are exactly what the reference's ``sweep`` gives today."""
    want = golden.load_sweep_golden()
    assert list(want) == list(golden.SWEEPS)
    golden.check_sweep(reference_sweep(name), want[name])


def test_sweep_golden_shapes():
    """The legs hold what the card run promises: the packed Fig. 17 grid
    in 4 waves of one 8x8 super-lane at 0.984375 efficiency, the chain's
    fast-forward skipping a quarter of the plain PE-steps (a chunk of
    four; half at the reference CI's 512 nodes), and the deadline
    freezing its lane (only) at its bound."""
    want = golden.load_sweep_golden()
    fig = want["fig17"]
    assert len(fig["lanes"]) == 9
    assert (fig["pack"]["n_waves"], fig["pack"]["n_super_lanes"]) == (4, 4)
    assert fig["pack"]["packing_efficiency"] == 0.984375
    chain = want["chain"]
    assert len(chain["lanes"]) == 8
    assert chain["telemetry"]["stepped_pe_ticks"] == 786_432
    assert chain["telemetry"]["plain_pe_ticks"] == 1_048_576
    assert chain["telemetry"]["dead_step_fraction"] == 0.25
    dl = want["deadline"]
    for key, rec in dl["lanes"].items():
        cut = golden.SWEEPS["deadline"]["deadlines"].get(key)
        assert rec["completed"] == (cut is None), key
        if cut is not None:
            assert rec["cycles"] == cut


def test_service_golden_matches_reference():
    """``service.json`` is exactly what the reference's one-shot
    ``run_many`` gives today on the service traffic (12 lanes, 2x2 to
    8x8), with the deadline lane's frozen record; the port's traffic is
    the reference's, array for array."""
    want = golden.load_service_golden()
    got = reference_service()
    assert got["spec"] == want["spec"]
    golden.check_lanes(got["lanes"], want["lanes"])
    assert got["deadline"] == want["deadline"]
    assert len(want["lanes"]) == 12
    frozen = want["deadline"]["record"]
    assert frozen["cycles"] == want["deadline"]["cycles"]
    assert not frozen["completed"]
    _, ref_lanes = ref_serve_bench.fig17_traffic(golden.SERVICE["copies"])
    _, lanes = serve_bench.fig17_traffic(golden.SERVICE["copies"])
    for a, b in zip(lanes, ref_lanes):
        assert tuple(a.geom) == tuple(b.geom)
        for f in ("prog", "static_ams", "amq_len", "mem_val", "mem_meta"):
            np.testing.assert_array_equal(getattr(a, f),
                                          np.asarray(getattr(b, f)))


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
    with open(golden.SWEEP_GOLDEN_PATH, "w") as f:
        json.dump({name: reference_sweep(name) for name in golden.SWEEPS},
                  f, indent=1)
        f.write("\n")
    print("wrote", golden.SWEEP_GOLDEN_PATH)
    with open(golden.SERVICE_GOLDEN_PATH, "w") as f:
        json.dump(reference_service(), f, indent=1)
        f.write("\n")
    print("wrote", golden.SERVICE_GOLDEN_PATH)
