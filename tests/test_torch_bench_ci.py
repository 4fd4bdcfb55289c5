"""The port's benchmark CI (``repro_torch.bench.bench_ci``), fabric
autotuner and dry-run hillclimb (``bench.hillclimb``), roofline table
(``bench.roofline``) and section runner (``bench.run``) against the
reference's ``benchmarks/`` scripts, on the CPU; and the two goldens the
card's ``[figures]`` phase is held to.

Regenerate ``src/repro_torch/golden/bench_drivers.json`` from the
reference with::

    PYTHONPATH=src:. python tests/test_torch_bench_ci.py
"""
import filecmp
import json
import os
import sys
import types

import pytest

torch = pytest.importorskip("torch")

from benchmarks import bench_ci as ref_bench_ci  # noqa: E402
from benchmarks import fig16_bandwidth as ref_fig16  # noqa: E402
from benchmarks import harness as ref_harness  # noqa: E402
from repro.analysis import estimate_cycles as ref_estimate  # noqa: E402
from repro.core.machine import MachineConfig as RefConfig  # noqa: E402

from repro_torch.bench import bench_ci, golden, hillclimb  # noqa: E402
from repro_torch.bench import roofline, run  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_fabric_autotune():
    """The reference's ``benchmarks.hillclimb.fabric_autotune``, imported
    with a stand-in for ``repro.launch.dryrun``: that module's first line
    sets ``XLA_FLAGS`` to 512 forced host devices, which would hold for
    every JAX start in this test process (the multi-device tests of other
    files would then see 512 devices).  ``fabric_autotune`` does not use
    the dry run."""
    mod = sys.modules.get("benchmarks.hillclimb")
    if mod is None:
        name = "repro.launch.dryrun"
        saved = sys.modules.get(name)
        sys.modules[name] = types.ModuleType(name)
        try:
            from benchmarks import hillclimb as mod
        finally:
            if saved is None:
                del sys.modules[name]
            else:
                sys.modules[name] = saved
    return mod.fabric_autotune


def reference_drivers() -> dict:
    """The reference's Fig. 16 simulated axis and bfs autotune at the
    arguments of :data:`golden.BENCH_DRIVERS`: the whole of
    ``bench_drivers.json``."""
    spec = golden.BENCH_DRIVERS
    f16 = dict(spec["fig16"])
    f16["sparsities"] = tuple(f16["sparsities"])
    at = spec["autotune"]
    return dict(
        fig16=dict(spec=spec["fig16"], record=golden.fig16_record(
            ref_fig16.simulate_sparsity_axis(**f16))),
        autotune=dict(spec=at, record=golden.autotune_record(
            _ref_fabric_autotune()(
                at["workload"], [tuple(s) for s in at["sizes"]],
                save=False))))


# --- diff_cycles and check_golden (tests/test_bench_smoke.py's cases) -----

DIFF_CASES = {
    # flat (workload, mode) grids: the smoke-golden shape
    "flat": (({"spmv": {"nexus": 100, "tia": 120}, "bfs": {"nexus": 40}},
              {"spmv": {"nexus": 103, "tia": 120}, "bfs": {"nexus": 40}}),
             {}, ["cycle drift: spmv/nexus golden=100 got=103"]),
    # nested size grids (fig17 / run_grid(sizes=) shapes) label the mesh
    "nested": (({"spmv": {"nexus": {
        "2x2": {"cycles": 10, "utilization": 0.5},
        "4x4": {"cycles": 5, "utilization": 0.5}}}},
        {"spmv": {"nexus": {
            "2x2": {"cycles": 11, "utilization": 0.5},
            "4x4": {"cycles": 5, "utilization": 0.5}}}}),
        dict(want_name="solo", got_name="sharded"),
        ["cycle drift: spmv/nexus@2x2 solo=10 sharded=11"]),
    # asymmetric grids: missing and untracked lanes are named too
    "asymmetric": (({"spmv": {"nexus": 1}}, {"spmv": {"tia": 2}}), {},
                   None),
    "equal": (({"spmv": {"nexus": {"2x2": {"cycles": 10}}}},
               {"spmv": {"nexus": {"2x2": {"cycles": 10}}}}), {}, []),
}


@pytest.mark.parametrize("case", list(DIFF_CASES))
def test_diff_cycles_labels_lanes(case):
    """Drift reports name each lane's (workload, mode, size) next to both
    cycle counts, word for word as the reference's."""
    (want, got), kw, expect = DIFF_CASES[case]
    errs = bench_ci.diff_cycles(want, got, **kw)
    assert errs == ref_bench_ci.diff_cycles(want, got, **kw)
    if expect is not None:
        assert errs == expect
    else:
        assert any("missing lane: spmv/nexus" in e for e in errs)
        assert any("untracked grid point: spmv/tia" in e for e in errs)


@pytest.mark.parametrize("case", ["drift", "update", "refuse", "missing"])
def test_check_golden(case, tmp_path, monkeypatch):
    """The golden gate: a drifted smoke grid names the lane as the
    reference's gate does; ``update`` writes this run's cycles beside
    ``--out`` and never over the golden; a missing golden is reported."""
    smoke = {"grid": {"spmv": {"nexus": {"cycles": 50, "executed": 9}}}}
    drifted = {"grid": {"spmv": {"nexus": {"cycles": 51, "executed": 9}}}}
    golden_file = tmp_path / "golden" / "bench_smoke.json"
    golden_file.parent.mkdir()
    monkeypatch.setattr(bench_ci, "GOLDEN", str(golden_file))
    if case == "drift":
        golden_file.write_text(json.dumps({"spmv": {"nexus": 50}}))
        monkeypatch.setattr(ref_bench_ci, "GOLDEN", str(golden_file))
        errs = bench_ci.check_golden(drifted, update=False)
        assert errs == ["cycle drift: spmv/nexus golden=50 got=51"]
        assert errs == ref_bench_ci.check_golden(drifted, update=False)
        assert bench_ci.check_golden(smoke, update=False) == []
    elif case == "update":
        out = tmp_path / "out"
        assert bench_ci.check_golden(smoke, update=True, out=str(out)) == []
        assert json.loads((out / "bench_smoke.json").read_text()) == \
            {"spmv": {"nexus": 50}}
        assert not golden_file.exists()
    elif case == "refuse":
        with pytest.raises(ValueError, match="reference's record"):
            bench_ci.check_golden(smoke, update=True,
                                  out=str(golden_file.parent))
    else:
        errs = bench_ci.check_golden(smoke, update=False)
        assert errs == [f"golden file missing: {golden_file}"]


def test_bench_smoke_golden_is_the_reference_copy():
    assert filecmp.cmp(golden.BENCH_SMOKE_PATH, ref_bench_ci.GOLDEN,
                       shallow=False)
    assert os.path.realpath(bench_ci.GOLDEN) == \
        os.path.realpath(golden.BENCH_SMOKE_PATH)


def test_run_smoke_meets_the_golden_and_the_reference():
    """The smoke grid on the CPU: the golden's cycles, no drift between the
    solo and sharded legs, one engine each, and the reference's static
    cost correlation (its estimates over its own compiled lanes against
    the golden cycles)."""
    smoke = bench_ci.run_smoke("cpu")
    want = golden.load_bench_smoke()
    assert bench_ci.check_golden(smoke, update=False) == []
    assert {w: {m: r["cycles"] for m, r in modes.items()}
            for w, modes in smoke["grid"].items()} == want
    assert smoke["shard_drift"] == []
    assert smoke["engine_cache_size"] == 1
    assert smoke["engine_cache_size_shard"] == 1
    assert smoke["n_devices"] == 1 and smoke["lanes_per_device"] == 9
    assert smoke["meta"]["backend"] == "cpu"
    assert "jax" not in smoke["meta"]
    points = []
    for wl in ref_bench_ci.smoke_workloads():
        for mode in want[wl.name]:
            cfg = RefConfig(width=2, height=2, mem_words=wl.mem_words,
                            max_cycles=100_000)
            est = ref_estimate(wl.build(cfg, ref_harness._placement_for(mode)))
            points.append((f"{wl.name}/{mode}", est, want[wl.name][mode]))
    assert smoke["static_cost"] == ref_bench_ci.static_cost_corr(points)


def test_fabric_autotune_equals_reference():
    sizes = [(2, 2), (4, 4)]
    flags = os.environ.get("XLA_FLAGS")
    want = _ref_fabric_autotune()("bfs", sizes, save=False)
    assert os.environ.get("XLA_FLAGS") == flags
    got = hillclimb.fabric_autotune("bfs", sizes, save=False, device="cpu")
    assert golden.autotune_record(got) == golden.autotune_record(want)
    assert got["pack_stats"]["n_waves"] >= 1
    assert got["sharded"] is False and got["shard_stats"] is None
    with pytest.raises(ValueError, match="unknown fabric workload"):
        hillclimb.fabric_autotune("nope", sizes, save=False, device="cpu")


def test_bench_drivers_golden_matches_reference():
    """``golden/bench_drivers.json`` is exactly what the reference gives
    today at the card's arguments, so the card is not held to a stale
    file."""
    want = golden.load_bench_drivers_golden()
    got = json.loads(json.dumps(reference_drivers()))
    assert got == want
    golden.check_bench_drivers(got["fig16"]["record"],
                               got["autotune"]["record"], want)
    with pytest.raises(AssertionError, match="autotune differs"):
        bad = json.loads(json.dumps(got["autotune"]["record"]))
        bad["table"]["2x2"]["cycles"] += 1
        golden.check_bench_drivers(None, bad, want)


@pytest.fixture(scope="module")
def variant_record(tmp_path_factory):
    """One depth-cut dry-run cell through ``run_variant``: StableLM-3B's
    ``train_4k`` cut to one layer (``configs.get_arch`` wrapped for the
    call), without remat, on 256 fake ranks."""
    import dataclasses

    from repro_torch.launch import dryrun
    out = tmp_path_factory.mktemp("perf")
    get_arch = dryrun.configs.get_arch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hillclimb, "OUT", str(out))
        mp.setattr(dryrun.configs, "get_arch", lambda a: dataclasses.replace(
            get_arch(a), n_layers=1))
        rec = hillclimb.run_variant("stablelm_3b", "train_4k", "remat_none",
                                    pair=False, device="cpu")
    return out, rec


def test_run_variant_writes_its_record(variant_record):
    out, rec = variant_record
    path = out / "stablelm_3b__train_4k__remat_none.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    assert rec["policy"]["remat"] == "none"
    assert rec["policy"]["n_layers"] == 1
    assert rec["chips"] == 256 and rec["flops_reported"] > 0
    line = hillclimb.fmt(rec)
    assert "bound=" in line and "roofline=" in line
    t = hillclimb.terms(rec)
    assert t.t_compute == rec["flops_reported"] / 989e12


def test_roofline_table_prints_the_h100_constants(variant_record,
                                                  monkeypatch, capsys):
    """The roofline table over a record in a directory of its own: the
    port's constants in the header, no TPU figure, one row."""
    out, rec = variant_record
    monkeypatch.setattr(roofline, "DRYRUN_DIR", str(out))
    rows = roofline.main(show_breakdown=True)
    text = capsys.readouterr().out
    assert "989 TF/s bf16" in text and "3.35 TB/s" in text
    assert "50 GB/s link (assumed)" in text
    assert "v5e" not in text and "819" not in text
    assert len(rows) == 1 and rows[0]["arch"] == "stablelm_3b"
    assert rows[0]["t_compute"] == hillclimb.terms(rec).t_compute
    monkeypatch.setattr(roofline, "DRYRUN_DIR", str(out / "none"))
    assert roofline.main() == []
    assert "repro_torch.launch.dryrun" in capsys.readouterr().out


def test_run_exits_1_when_a_section_fails(monkeypatch, capsys):
    """A section that raises is reported, the others run, and the run
    ends with exit code 1, as the reference's does."""
    from repro_torch.bench import harness

    def boom(*a, **kw):
        raise RuntimeError("section failed on purpose")

    monkeypatch.setattr(harness, "run_all", lambda **kw: {})
    monkeypatch.setattr(roofline, "main", boom)
    with pytest.raises(SystemExit) as e:
        run.main(["--only", "roofline", "--device", "cpu"])
    assert e.value.code == 1
    text = capsys.readouterr().out
    assert "[harness: " in text and "[roofline: " in text
    assert "FAILED sections: ['roofline']" in text
    assert [n for n, _ in run.SECTIONS] == [
        "harness", "fig11", "fig12", "fig13", "fig14", "fig16", "fig17",
        "table2", "kernels", "roofline"]
    monkeypatch.setattr(roofline, "main", lambda: [])
    run.main(["--only", "roofline", "--device", "cpu"])
    assert "all benchmark sections completed" in capsys.readouterr().out


if __name__ == "__main__":
    with open(golden.BENCH_DRIVERS_PATH, "w") as f:
        json.dump(reference_drivers(), f, indent=1)
        f.write("\n")
    print(f"wrote {golden.BENCH_DRIVERS_PATH}")
