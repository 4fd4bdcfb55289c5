"""The harness on the CPU: pools and the clients' order from the seed,
discovery of added files, the result line, the no-JAX check, and
``correct`` coming out false when the timed path is broken underneath.

A tiny cell (two kernels, two modes, 2x2 fabrics) runs the program's
plain engine on the CPU; the look for a card is skipped.  Its records
(``testdata/tiny.tiny.json``) were made by the JAX reference simulator,
as the cells' are.
"""
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from nexusbench import harness, inputs, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TRAFFIC = ("fig11-modes", "fig17-scale")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]

TINY_CONFIG = {
    "fabric": {"width": 2, "height": 2, "mem_words": 512, "queue_cap": 256,
               "stream_wait_cap": 256, "max_cycles": 20000},
    "service": {"n_supers": 2, "chunk": 64, "slice_chunks": 1,
                "super_geom": [2, 2], "slots_per_super": None}}
TINY_TRAFFIC = {
    "clients": {"count": 4}, "pattern_seed": 7,
    "pool": {"modes": ["nexus", "tia"], "meshes": [[2, 2]],
             "placement": {"nexus": "dissimilarity", "tia": "rows"}},
    "kernels": [{"name": "spmv", "kind": "spmv", "m": 8, "density": 0.3},
                {"name": "bfs", "kind": "bfs", "nodes": 12, "degree": 4}]}


@pytest.fixture
def tiny(tmp_path):
    """A folder of configs, traffic, records and metrics holding the tiny
    cell and every metric reader of the benchmark, and a BENCHMARK dict
    naming them all."""
    for kind, name, body in (("configs", "tiny", TINY_CONFIG),
                             ("traffic", "tiny", TINY_TRAFFIC)):
        (tmp_path / kind).mkdir()
        (tmp_path / kind / f"{name}.json").write_text(json.dumps(body))
    (tmp_path / "records").mkdir()
    shutil.copy(os.path.join(HERE, "testdata", "tiny.tiny.json"),
                tmp_path / "records" / "tiny.tiny.json")
    shutil.copytree(os.path.join(HERE, "metrics"), tmp_path / "metrics")
    real = harness.load_benchmark()
    bench = dict(real, workloads=[dict(name="tiny.service", config="tiny",
                                       traffic="tiny", chips=1, why="test")])
    bench["end_to_end"] = [dict(m, workloads=["tiny.service"])
                           for m in real["end_to_end"]]
    bench["per_layer"] = [dict(m, workloads=["tiny.service"])
                          for m in real["per_layer"]]
    return str(tmp_path), bench


def _run(tiny, trace_on=False, **kw):
    base, bench = tiny
    return harness.run("tiny.service", 2 ** 31 + 99, 1.0, trace_on,
                       time.monotonic(), device="cpu", grace_s=3.0,
                       bench=bench, base=base, **kw)


@pytest.mark.parametrize("name", TRAFFIC)
def test_pool_and_order_follow_the_seed(name):
    traffic = harness.load_json("traffic", name)
    n_pool = len(harness.pool_lanes(traffic))

    def flat(d):
        return np.concatenate([np.ravel(v) for v in d.values()])

    def first(n):
        return list(itertools.islice(harness.order(traffic, n_pool), n))

    a, b = (inputs.draw_traffic(traffic, 2 ** 31 + 17) for _ in range(2))
    other = inputs.draw_traffic(traffic, 5)
    assert all(np.array_equal(flat(x), flat(y)) for x, y in zip(a, b))
    assert not all(np.array_equal(flat(x), flat(y))
                   for x, y in zip(a, other))
    # another seed: the same structure (every zero where it was, since the
    # compiler drops zeros), other values
    for x, y in zip(a, other):
        for k in x:
            assert np.array_equal(np.asarray(x[k]) != 0,
                                  np.asarray(y[k]) != 0) or k in ("x", "rank")
    # the clients' order: whole passes over the pool, the same for every
    # seed
    assert first(5 * n_pool) == first(5 * n_pool)
    assert sorted(first(3 * n_pool)) == sorted(list(range(n_pool)) * 3)
    assert first(n_pool) != first(2 * n_pool)[n_pool:]


def test_every_named_file_exists():
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        c = harness.cell(w["name"], bench)
        assert c.per_layer and c.end_to_end
        for m in c.per_layer:
            assert callable(harness.reader(m["name"]))
        records = harness.load_records(w["config"], w["traffic"], c.config)
        names = [p.name for p in harness.pool_lanes(c.traffic)]
        assert sorted(records) == sorted(names)
        assert all(r["completed"] for r in records.values())


def test_records_made_for_another_fabric_are_refused(tiny):
    base, _ = tiny
    conf = dict(TINY_CONFIG, fabric=dict(TINY_CONFIG["fabric"],
                                         mem_words=1024))
    with pytest.raises(ValueError):
        harness.load_records("tiny", "tiny", conf, base)


def test_added_files_are_found_without_an_edit(tiny, tmp_path):
    base, bench = tiny
    (tmp_path / "metrics" / "dummy.metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench["per_layer"].append(dict(name="dummy.metric", unit="x",
                                   better="higher", source="host_clock",
                                   layer="client", moves="lanes_per_s",
                                   workloads=["tiny.service"]))
    c = harness.cell("tiny.service", bench, base)
    assert c.config == TINY_CONFIG and c.traffic == TINY_TRAFFIC
    assert harness.reader("dummy.metric", base)({}) == 42.0
    out = _run(tiny, trace_on=True)
    assert out["metrics"]["dummy.metric"]["value"] == 42.0


def test_the_result_line(tiny):
    out = _run(tiny)
    assert list(out) == KEYS + ["compared"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"lanes_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(v["value"] == 0 == v["limit"]
               for v in out["compared"].values())


def test_the_traced_line(tiny, monkeypatch):
    """With a device trace (here a made-up one, since the CPU has none) the
    traced line adds ``breakdown`` and ``busy_s`` / ``window_s``."""
    def fake_stop(prof, marker, t0, t_close):
        lo, hi = int(t0 * 1e9), int(t_close * 1e9)
        mid = (lo + hi) // 2
        return dict(lo=lo, hi=hi, ops=[("cycle_kernel", lo, mid),
                                       ("Memcpy DtoH", mid, mid + 1000)])
    monkeypatch.setattr(trace, "stop", fake_stop)
    out = _run(tiny, trace_on=True)
    assert list(out) == KEYS + ["breakdown", "compared"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["breakdown"]["device_ops"][0][0] == "cycle_kernel"
    assert 0 < out["device"]["busy_s"] < out["device"]["window_s"]
    assert 45 < out["metrics"]["device.idle_pct"]["value"] < 55
    assert "lanes_per_s" not in out["metrics"]
    assert out["metrics"]["lane_p95_ms.fig11-modes.service"]["value"] > 0


def test_no_jax_check_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    for name in ("repro_torch_extra", "jaxtyping", "benchmarks_x"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    for name in ("repro.core.machine", "jax", "benchmarks"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == ["benchmarks", "jax", "repro"]


def test_a_run_loads_no_jax(tiny):
    base, bench = tiny
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'src')!r}]\n"
        "from nexusbench import harness\n"
        f"bench = json.loads({json.dumps(json.dumps(bench))})\n"
        "out = harness.run('tiny.service', 3, 0.5, False, time.monotonic(),"
        f" device='cpu', grace_s=3.0, bench=bench, base={base!r})\n"
        "print(out['correct'], harness.forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.stdout.strip().splitlines()[-1] == "True []", res.stderr[-2000:]


class _Fault:
    """A fault in the program's chunk entry, switched on for the window and
    off again once the run has been judged (so the engine can finish)."""

    def __init__(self, monkeypatch, broken):
        from repro_torch.kernels import cycle
        self.orig, self.on, self.svc = cycle.cycle_chunk, False, None

        def chunk(cfg, *args, ticks, fast_forward):
            if self.on:
                return broken(self.orig, cfg, *args, ticks=ticks,
                              fast_forward=fast_forward)
            return self.orig(cfg, *args, ticks=ticks,
                             fast_forward=fast_forward)
        monkeypatch.setattr(cycle, "cycle_chunk", chunk)

    def start(self, svc):
        self.svc, self.on = svc, True

    def stop(self):
        self.on = False
        self.svc._thread.join(timeout=120)


def _unchanged(orig, cfg, *args, ticks, fast_forward):
    return args[-1]


def _half_batch(orig, cfg, prog, modes, geoms, sub_ids, local_ids, cycle0,
                budget, st, *, ticks, fast_forward):
    budget = budget.clone()
    budget[budget.shape[0] // 2:] = 0
    return orig(cfg, prog, modes, geoms, sub_ids, local_ids, cycle0, budget,
                st, ticks=ticks, fast_forward=fast_forward)


def _nexus_everywhere(orig, cfg, prog, modes, geoms, sub_ids, local_ids,
                     cycle0, budget, st, *, ticks, fast_forward):
    """The lanes' modes ignored: every lane routed and executed as Nexus."""
    from repro_torch.core.machine import MODE_NEXUS
    return orig(cfg, prog, torch.full_like(modes, MODE_NEXUS), geoms,
                sub_ids, local_ids, cycle0, budget, st, ticks=ticks,
                fast_forward=fast_forward)


@pytest.mark.parametrize("broken", [_unchanged, _half_batch],
                         ids=["state-unchanged", "half-the-batch"])
def test_a_broken_step_is_not_correct(tiny, monkeypatch, broken):
    fault = _Fault(monkeypatch, broken)
    try:
        out = _run(tiny, on_window=fault.start)
    finally:
        fault.stop()
    assert not out["correct"]
    assert out["compared"]["lost"]["value"] > 0 and out["failed"] > 0


def test_an_altered_answer_is_not_correct(tiny, monkeypatch):
    from repro_torch.serve import fabric
    orig = fabric._pe_slice_result

    def altered(*a, **k):
        res = orig(*a, **k)
        res.mem_val[...] += 1
        return res

    def start(svc):
        monkeypatch.setattr(fabric, "_pe_slice_result", altered)
    out = _run(tiny, on_window=start)
    assert not out["correct"]
    assert out["compared"]["wrong"]["value"] > 0
    assert out["compared"]["lost"]["value"] == 0


def test_an_ignored_mode_is_not_correct(tiny, monkeypatch):
    """TIA lanes run as Nexus give the same answers; their records differ."""
    fault = _Fault(monkeypatch, _nexus_everywhere)
    try:
        out = _run(tiny, on_window=fault.start)
    finally:
        fault.stop()
    assert not out["correct"]
    assert out["compared"]["bad_record"]["value"] > 0
    assert out["compared"]["wrong"]["value"] == 0


def test_a_cycle_count_off_by_one_is_not_correct(tiny, monkeypatch):
    from repro_torch.serve import fabric
    orig = fabric._pe_slice_result

    def late(*a, **k):
        res = orig(*a, **k)
        res.cycles += 1
        return res

    def start(svc):
        monkeypatch.setattr(fabric, "_pe_slice_result", late)
    out = _run(tiny, on_window=start)
    assert not out["correct"]
    assert out["compared"]["bad_record"]["value"] > 0
    assert out["compared"]["wrong"]["value"] == 0
