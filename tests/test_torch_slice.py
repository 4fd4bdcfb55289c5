"""The port's slice end to end on the CPU: the benchmark grid through the
torch engine against the JAX reference, and the copied host modules
against the reference's.  (The golden file the card run is held to is
checked in ``tests/test_torch_golden.py``.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import harness as ref_harness  # noqa: E402
from benchmarks.workloads import Workload as RefWorkload  # noqa: E402
from benchmarks.workloads import make_all as ref_make_all  # noqa: E402
from benchmarks.workloads import small_world_graph as ref_graph  # noqa: E402
from repro.core import compiler as ref_compiler  # noqa: E402
from repro.core.machine import MachineConfig as RefConfig  # noqa: E402

from repro_torch.bench import golden, harness  # noqa: E402
from repro_torch.bench.workloads import Workload, make_all  # noqa: E402
from repro_torch.core.machine import MachineConfig  # noqa: E402

GOLDEN_SMOKE = {"spmv": {"nexus": 24, "tia": 28, "tia_valiant": 27},
                "matmul": {"nexus": 40, "tia": 41, "tia_valiant": 42},
                "bfs": {"nexus": 33, "tia": 37, "tia_valiant": 39}}


def _smoke_workloads(wl_cls, comp, graph):
    """The tiny 2x2 grid of tests/test_bench_smoke.py, built against the
    given package's compiler (same seed, same draws)."""
    rng = np.random.default_rng(5)
    a = comp.random_sparse(8, 8, 0.4, rng)
    x = rng.integers(-3, 4, size=(8,))
    da = rng.integers(-3, 4, size=(4, 4))
    db = rng.integers(-3, 4, size=(4, 4))
    rp, col = graph(12, 4, 2)
    return [
        wl_cls(name="spmv", sparsity_note="sparse",
               build=lambda c, s: comp.build_spmv(a, x, c, strategy=s),
               useful_ops=2 * int(np.count_nonzero(a)),
               cgra=None, systolic_cycles=None, mem_words=1024),
        wl_cls(name="matmul", sparsity_note="dense",
               build=lambda c, s: comp.build_matmul(da, db, c, strategy=s),
               useful_ops=2 * 4 ** 3,
               cgra=None, systolic_cycles=None, mem_words=1024),
        wl_cls(name="bfs", sparsity_note="graph",
               build=lambda c, s: comp.build_bfs(rp, col, 0, c, strategy=s),
               useful_ops=2 * int(col.size),
               cgra=None, systolic_cycles=None, mem_words=1024),
    ]


def test_smoke_grid_matches_reference():
    """(b) the port's run_grid on the CPU equals the reference's on the
    tiny 2x2 smoke grid: every RunResult field, per-PE arrays and mem_val,
    and the bench_smoke golden cycle counts."""
    from repro_torch.bench.workloads import small_world_graph
    from repro_torch.core import compiler as port_compiler
    ref_wls = _smoke_workloads(RefWorkload, ref_compiler, ref_graph)
    port_wls = _smoke_workloads(Workload, port_compiler, small_world_graph)
    _, ref_report = ref_harness.run_grid_report(
        ref_wls, base_cfg=RefConfig(width=2, height=2), max_cycles=100_000)
    lanes, _ = harness.run_grid_lanes(
        port_wls, base_cfg=MachineConfig(width=2, height=2),
        max_cycles=100_000, device="cpu")
    assert len(lanes) == len(ref_report.lanes) == 9
    for lane, want in zip(lanes, ref_report.lanes):
        got = lane.result
        assert golden.lane_record(got) == golden.lane_record(want)
        np.testing.assert_array_equal(got.mem_val, want.mem_val)
        np.testing.assert_array_equal(got.per_pe_busy, want.per_pe_busy)
        np.testing.assert_array_equal(got.stall_per_port,
                                      want.stall_per_port)
        assert got.cycles == GOLDEN_SMOKE[lane.workload.name][lane.mode]
    table = harness.build_table(
        port_wls, harness.run_grid(port_wls,
                                   base_cfg=MachineConfig(width=2, height=2),
                                   max_cycles=100_000, device="cpu"),
        verbose=False)
    for name, by_mode in GOLDEN_SMOKE.items():
        for mode, cycles in by_mode.items():
            assert table[name]["archs"][mode]["cycles"] == cycles


def test_copied_compiler_outputs_match_reference():
    """(c) the port's copied compiler and workload generators produce
    byte-equal compiled workloads for every make_all() workload and
    placement."""
    ref_wls, port_wls = ref_make_all(), make_all()
    assert [w.name for w in ref_wls] == [w.name for w in port_wls]
    for rw, pw in zip(ref_wls, port_wls):
        assert (rw.useful_ops, rw.sparsity_note, rw.systolic_cycles,
                rw.mem_words) == (pw.useful_ops, pw.sparsity_note,
                                  pw.systolic_cycles, pw.mem_words)
        for strategy in ("dissimilarity", "rows"):
            rc = rw.build(RefConfig(mem_words=rw.mem_words), strategy)
            pc = pw.build(MachineConfig(mem_words=pw.mem_words), strategy)
            for f in ("prog", "static_ams", "amq_len", "mem_val",
                      "mem_meta", "expected", "meta_pe", "alloc_top"):
                a, b = getattr(rc, f), getattr(pc, f)
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
                    (rw.name, strategy, f)
            assert (rc.n_static_ams, rc.name, rc.geom) == \
                (pc.n_static_ams, pc.name, pc.geom)


@pytest.mark.parametrize("nv,k,seed", [(96, 6, 3), (96, 6, 5), (96, 6, 9),
                                       (12, 4, 2)])
def test_small_world_graph_matches_networkx(nv, k, seed):
    """(c) the networkx-free graph equals networkx's for every (nv, k,
    seed) the reference uses."""
    from repro_torch.bench.workloads import small_world_graph
    rp, col = small_world_graph(nv, k, seed)
    rp_ref, col_ref = ref_graph(nv, k, seed)
    np.testing.assert_array_equal(rp, rp_ref)
    np.testing.assert_array_equal(col, col_ref)
