"""The port's paper-figure drivers (``repro_torch.bench.harness``'s grid
and table, the Figs. 11-14 and Table 2 formatters, Fig. 16's model and
simulated axis, Fig. 17's printout) against the reference's
``benchmarks/`` scripts, on the CPU: the same tables (all but the wall
seconds), the same returned dicts and the same printed text."""
import json

import pytest

torch = pytest.importorskip("torch")

from benchmarks import bench_ci as ref_bench_ci  # noqa: E402
from benchmarks import fig11_performance as ref_fig11  # noqa: E402
from benchmarks import fig12_perf_watt as ref_fig12  # noqa: E402
from benchmarks import fig13_utilization as ref_fig13  # noqa: E402
from benchmarks import fig14_congestion as ref_fig14  # noqa: E402
from benchmarks import fig16_bandwidth as ref_fig16  # noqa: E402
from benchmarks import fig17_scaling as ref_fig17  # noqa: E402
from benchmarks import harness as ref_harness  # noqa: E402
from benchmarks import table2_efficiency as ref_table2  # noqa: E402
from benchmarks.workloads import Workload as RefWorkload  # noqa: E402
from benchmarks.workloads import make_all as ref_make_all  # noqa: E402
from repro.core import compiler as ref_compiler  # noqa: E402
from repro.core.machine import MachineConfig as RefConfig  # noqa: E402

from repro_torch.bench import bench_ci, fig11_performance  # noqa: E402
from repro_torch.bench import fig12_perf_watt, fig13_utilization  # noqa: E402
from repro_torch.bench import fig14_congestion, fig16_bandwidth  # noqa: E402
from repro_torch.bench import fig17, golden, harness  # noqa: E402
from repro_torch.bench import table2_efficiency  # noqa: E402
from repro_torch.bench.workloads import Workload, make_all  # noqa: E402
from repro_torch.core import compiler  # noqa: E402
from repro_torch.core.machine import MachineConfig  # noqa: E402

#: formatter name -> (port module, reference module)
FORMATTERS = {
    "fig11": (fig11_performance, ref_fig11),
    "fig12": (fig12_perf_watt, ref_fig12),
    "fig13": (fig13_utilization, ref_fig13),
    "fig14": (fig14_congestion, ref_fig14),
    "table2": (table2_efficiency, ref_table2),
}
SMOKE = dict(max_cycles=100_000)


def _no_wall(table: dict) -> dict:
    """A ``build_table`` table without the batch wall seconds."""
    out = json.loads(json.dumps(table))
    for entry in out.values():
        for row in entry["archs"].values():
            row.pop("batch_wall_s", None)
    return out


@pytest.fixture(scope="module")
def tiny_tables():
    """The smoke grid's three workloads (``tests/test_bench_smoke.py``'s
    tiny table) x the three modes at 2x2, through each harness."""
    ref_wls = ref_bench_ci.smoke_workloads()
    port_wls = bench_ci.smoke_workloads()
    ref = ref_harness.build_table(
        ref_wls, ref_harness.run_grid(
            ref_wls, base_cfg=RefConfig(width=2, height=2), **SMOKE),
        verbose=False)
    port = harness.build_table(
        port_wls, harness.run_grid(
            port_wls, base_cfg=MachineConfig(width=2, height=2),
            device="cpu", **SMOKE),
        verbose=False)
    return ref, port


@pytest.fixture(scope="module")
def paper_tables():
    """The Figs. 11-14 table of ``golden/paper_grid.json``'s grid A
    records (the reference's lanes; no engine runs), built by each
    harness over its own ``make_all()``."""
    lanes = golden.load_golden()["grid_a"]["lanes"]
    modes = list(harness.PLACEMENT)
    ref_wls, port_wls = ref_make_all(), make_all()
    ref = ref_harness.build_table(
        ref_wls, golden.grid_rows(lanes, ref_wls, modes), verbose=False)
    port = harness.build_table(
        port_wls, golden.grid_rows(lanes, port_wls, modes), verbose=False)
    return ref, port


def test_tiny_table_equals_reference(tiny_tables):
    """Every field of every row but ``batch_wall_s``, and the rows' JSON
    types (lists, ints, floats), equal the reference's."""
    ref, port = tiny_tables
    assert _no_wall(port) == _no_wall(ref)
    row = port["spmv"]["archs"]["nexus"]
    assert isinstance(row["per_pe_busy"], list)
    assert isinstance(row["stall_per_port"], list)
    assert all(type(v) is int for v in row["per_pe_busy"])
    assert type(row["enroute_frac"]) is float
    assert type(row["batch_wall_s"]) is float
    assert json.loads(json.dumps(port)) == port


def test_paper_table_equals_reference(paper_tables):
    """The table built from the golden records (host CGRA and systolic
    models included) is the reference's."""
    ref, port = paper_tables
    assert list(port) == [w.name for w in make_all()]
    assert port == json.loads(json.dumps(ref))


@pytest.mark.parametrize("table", ["tiny", "paper"])
@pytest.mark.parametrize("name", list(FORMATTERS))
def test_formatter_matches_reference(name, table, tiny_tables,
                                     paper_tables, capsys):
    """Each formatter returns the reference's dict and prints the
    reference's text, on the tiny table (the n/a paths) and on the full
    Figs. 11-14 table."""
    ref_t, port_t = tiny_tables if table == "tiny" else paper_tables
    port_mod, ref_mod = FORMATTERS[name]
    want = ref_mod.main(ref_t)
    want_text = capsys.readouterr().out
    got = port_mod.main(port_t)
    got_text = capsys.readouterr().out
    assert got == want
    assert got_text == want_text
    assert want_text
    if table == "paper":
        assert all(v is not None for v in got.values())


def test_paper_headlines():
    """The headline ratios of the golden grid: the numbers the card's
    ``[figures]`` line prints (the port's table and the reference's agree
    on every one, above)."""
    lanes = golden.load_golden()["grid_a"]["lanes"]
    wls = make_all()
    table = harness.build_table(
        wls, golden.grid_rows(lanes, wls, list(harness.PLACEMENT)),
        verbose=False)
    f11 = fig11_performance.main(table)
    f13 = fig13_utilization.main(table)
    t2 = table2_efficiency.main(table)
    assert f11["sparse_vs_cgra"] > 1 and f11["all_vs_tia"] > 1
    assert f13["util_vs_tia"] > 1
    assert t2["thr_ratio"] > 1


def _pack_workloads(wl_cls, comp):
    import numpy as np
    rng = np.random.default_rng(5)
    a = comp.random_sparse(8, 8, 0.4, rng)
    x = rng.integers(-3, 4, size=(8,))
    return [wl_cls(name="spmv", sparsity_note="sparse",
                   build=lambda c, s: comp.build_spmv(a, x, c, strategy=s),
                   useful_ops=2 * int(np.count_nonzero(a)),
                   cgra=None, systolic_cycles=None, mem_words=1024)]


def test_run_grid_report_pack_equals_reference():
    """``run_grid_report(pack=True)`` on a mixed-size grid: the
    reference's table and packing schedule."""
    kw = dict(max_cycles=100_000, sizes=[(2, 2), (4, 4)], pack=True)
    want, ref_report = ref_harness.run_grid_report(
        _pack_workloads(RefWorkload, ref_compiler), ["nexus"],
        base_cfg=RefConfig(width=2, height=2), **kw)
    got, report = harness.run_grid_report(
        _pack_workloads(Workload, compiler), ["nexus"],
        base_cfg=MachineConfig(width=2, height=2), device="cpu", **kw)
    for t in (got, want):
        for rows in t["nexus"].values():
            for r in rows:
                r.pop("batch_wall_s")
    assert list(got["nexus"]) == ["2x2", "4x4"]
    assert got == want
    assert report.pack.to_json() == ref_report.pack.to_json()
    assert report.pack.packing_efficiency >= \
        report.pack.unpacked_efficiency
    # the table-only entry point delegates to the same run
    plain = harness.run_grid(_pack_workloads(Workload, compiler), ["nexus"],
                             base_cfg=MachineConfig(width=2, height=2),
                             device="cpu", max_cycles=100_000,
                             sizes=[(2, 2), (4, 4)], shard=True)
    for size in ("2x2", "4x4"):
        assert plain["nexus"][size][0]["cycles"] == \
            got["nexus"][size][0]["cycles"]


def test_fig16_model_equals_reference(capsys):
    want = ref_fig16.main()
    want_text = capsys.readouterr().out
    got = fig16_bandwidth.main(device="cpu")
    assert got == want
    assert capsys.readouterr().out == want_text


def test_fig16_simulated_axis_equals_reference(capsys):
    """The simulated sparsity axis on the port's packed sweep: the
    reference's densities, executed counts and cycles, and its text."""
    kw = dict(n=10, sparsities=(0.30, 0.70), mem_words=1024)
    want = ref_fig16.simulate_sparsity_axis(**kw)
    want_text = capsys.readouterr().out
    got = fig16_bandwidth.simulate_sparsity_axis(device="cpu", **kw)
    assert got == want
    assert capsys.readouterr().out == want_text
    assert got[0.70]["executed"] < got[0.30]["executed"]


def test_fig17_printout_equals_reference(tmp_path, monkeypatch, capsys):
    """Fig. 17's table over ``golden/sweeps.json``'s fig17 lanes (the
    reference's packed grid), read from each script's cache."""
    lanes = golden.load_sweep_golden()["fig17"]["lanes"]
    data: dict = {}
    for key, rec in lanes.items():
        name, size = key.split("@")
        data.setdefault(name, {})[size] = dict(
            cycles=rec["cycles"], utilization=rec["utilization"])
    assert list(data) == list(fig17._builders())
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    for p in (ref_out, port_out):
        p.write_text(json.dumps(data, indent=1))
    monkeypatch.setattr(ref_fig17, "OUT", str(ref_out))
    monkeypatch.setattr(fig17, "OUT", str(port_out))
    want = ref_fig17.main()
    want_text = capsys.readouterr().out
    got = fig17.main(device="cpu")
    assert got == want == data
    assert capsys.readouterr().out == want_text


def test_mops_equal_reference(paper_tables):
    ref, port = paper_tables
    n = 0
    for name, entry in port.items():
        for arch in entry["archs"]:
            assert harness.mops(entry, arch) == \
                ref_harness.mops(ref[name], arch)
            assert harness.mops_per_mw(entry, arch) == \
                ref_harness.mops_per_mw(ref[name], arch)
            n += 1
    assert n == 13 * 3 + sum("cgra" in e["archs"] for e in port.values()) \
        + sum("systolic" in e["archs"] for e in port.values())


def test_run_all_caches_under_its_own_directory(tmp_path, monkeypatch):
    """``run_all`` reads and writes ``experiments/bench_torch/``, never the
    reference's ``experiments/bench/``; a cached table is returned as
    written."""
    import os
    assert os.path.basename(os.path.dirname(harness.RESULTS)) == \
        "bench_torch"
    assert os.path.realpath(harness.RESULTS) != \
        os.path.realpath(ref_harness.RESULTS)
    cached = {"spmv": {"useful_ops": 1, "sparsity": "s", "archs": {}}}
    monkeypatch.setattr(harness, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(harness, "RESULTS", str(tmp_path / "results.json"))
    (tmp_path / "results.json").write_text(json.dumps(cached))
    assert harness.run_all(device="cpu") == cached
