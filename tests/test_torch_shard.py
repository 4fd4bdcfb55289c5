"""The multi-device lane split of the port (``shard=True`` over a list of
devices) against the JAX reference, over four shards of the CPU in one
process (``[cpu] * 4``, the counterpart of the reference's four forced
host devices).

Each sharded leg of ``src/repro_torch/golden/shard.json`` (the
reference's ``sweep(..., shard=True)`` under four forced host devices)
must come back bit for bit: every lane, the shard plan, the packing
schedule and the per-shard telemetry.  The lanes must also equal the
reference's unsharded (and packed) runs made here, the plan the
reference's ``plan_shards``, a sharded service the records of
``golden/service.json``, and a sharded service's checkpoint must restore
onto other splits.  One test regenerates the golden file from the
reference in a subprocess with four forced host devices.

Regenerate ``src/repro_torch/golden/shard.json`` with::

    PYTHONPATH=src:. python tests/test_torch_shard.py
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import workloads as ref_workloads  # noqa: E402
from repro.core import batch as ref_batch  # noqa: E402
from repro.core import compiler as ref_compiler  # noqa: E402
from repro.core import machine as ref_machine  # noqa: E402

from repro_torch.bench import fig17, golden, serve_bench  # noqa: E402
from repro_torch.checkpoint.store import list_steps  # noqa: E402
from repro_torch.core import batch, machine  # noqa: E402
from repro_torch.core.sweep import SweepRequest, sweep  # noqa: E402
from repro_torch.serve import SweepService  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CPUS = [CPU] * golden.SHARD_DEVICES
#: the reference's sharded legs, run where JAX sees four host devices
REFERENCE_CODE = r"""
import json
import jax
from benchmarks import workloads
from repro.core import compiler, machine
from repro.core.sweep import SweepRequest, sweep
from repro_torch.bench import golden
assert len(jax.devices()) == golden.SHARD_DEVICES, jax.devices()
out = {}
for name in golden.SHARD_LEGS:
    cfg, kw, keys = golden.shard_leg(
        name, compiler=compiler, config=machine.MachineConfig,
        fabric_modes=machine.FABRIC_MODES, workloads=workloads)
    out[name] = golden.shard_record(name, keys, sweep(cfg, SweepRequest(**kw)))
print(json.dumps(out))
"""


def reference_shard_records(timeout: float = 240) -> dict:
    """Every sharded leg through the JAX reference in a subprocess with
    four forced host devices: the whole of ``shard.json``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]),
               XLA_FLAGS="--xla_force_host_platform_device_count="
                         f"{golden.SHARD_DEVICES}")
    out = subprocess.run([sys.executable, "-c", REFERENCE_CODE],
                         capture_output=True, text=True, timeout=timeout,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def ref_shard_leg(name: str):
    return golden.shard_leg(name, compiler=ref_compiler,
                            config=ref_machine.MachineConfig,
                            fabric_modes=ref_machine.FABRIC_MODES,
                            workloads=ref_workloads)


def _same(got, want, label) -> None:
    assert got.to_json() == want.to_json(), label
    np.testing.assert_array_equal(np.asarray(got.mem_val),
                                  np.asarray(want.mem_val),
                                  err_msg=str(label))


@pytest.fixture(scope="module")
def want() -> dict:
    return golden.load_shard_golden()


def _port_sweep(name: str, **kw):
    cfg, req, keys = golden.port_shard_leg(name)
    req.update(kw)
    report = sweep(cfg, SweepRequest(**req), devices=CPUS)
    return report, keys, req


def test_sharded_grid_matches_reference_and_golden(want):
    """The 18-lane (workload x mode x size) grid over four CPU shards: ONE
    cached engine, the golden leg bit for bit (lanes, plan, per-shard
    telemetry), and every lane equal to the reference's unsharded
    ``run_many`` of the same lanes."""
    machine.clear_engine_cache()
    report, keys, _ = _port_sweep("grid")
    assert machine.engine_cache_size() == 1
    golden.check_shard(golden.shard_record("grid", keys, report),
                       want["grid"])
    sh = report.shard
    assert sh.n_devices == golden.SHARD_DEVICES
    assert sh.lanes_per_device * sh.n_devices == len(keys) + sh.n_pad_lanes
    # each shard stops on its own: the per-shard ticks differ, so the
    # telemetry is not the unsharded run's
    unsharded_ticks = 128 * len(keys) * 16
    assert report.telemetry.stepped_pe_ticks != unsharded_ticks
    cfg, kw, _ = ref_shard_leg("grid")
    ref = ref_machine.run_many(cfg, kw["workloads"], modes=kw["modes"],
                               chunk=kw["chunk"])
    for k, r, w in zip(keys, report, ref):
        _same(r, w, k)


def test_shard_plan_matches_reference():
    """``plan_shards`` equals the reference's on seeded geometries and
    hints, and the grid's plan is the reference's plan of its lanes
    under the static cost model's hints (the default load signal)."""
    rng = np.random.default_rng(11)
    for _ in range(100):
        n = int(rng.integers(1, 17))
        geoms = [(int(rng.integers(1, 9)), int(rng.integers(1, 9)))
                 for _ in range(n)]
        n_dev = int(rng.integers(1, 6))
        hints = (rng.integers(0, 5000, size=n).tolist()
                 if rng.random() < 0.5 else None)
        assert batch.plan_shards(geoms, n_dev, cycle_hints=hints) == \
            ref_batch.plan_shards(geoms, n_dev, cycle_hints=hints)
    _, kw, _ = ref_shard_leg("grid")
    wls = kw["workloads"]
    hints = ref_batch.static_cycle_hints(wls, None, homogeneous=True)
    geoms = [tuple(w.geom) for w in wls]
    want_plan = ref_batch.plan_shards(geoms, golden.SHARD_DEVICES,
                                      cycle_hints=hints)
    report, _, _ = _port_sweep("grid")
    assert [list(p) for p in report.shard.plan] == want_plan


@pytest.mark.parametrize("name", ["odd", "cap", "pack"])
def test_sharded_legs_match_golden(name, want):
    """The padded (5 lanes over 4 shards), capped (2 lanes, 2 shards) and
    packed legs bit for bit against the file; the packed leg also equals
    the reference's packed run here, and every odd lane its oracle."""
    machine.clear_engine_cache()
    report, keys, req = _port_sweep(name)
    assert machine.engine_cache_size() == 1
    golden.check_shard(golden.shard_record(name, keys, report), want[name])
    if name == "odd":
        assert report.shard.n_pad_lanes == golden.SHARD_DEVICES - 1
        for wl, r in zip(req["workloads"], report):
            assert r.completed and wl.check(r.mem_val)
    if name == "cap":
        assert (report.shard.n_devices, report.shard.lanes_per_device) == \
            (2, 1)
    if name == "pack":
        cfg, kw, _ = ref_shard_leg("pack")
        ref = ref_machine.run_many(cfg, kw["workloads"], modes=kw["modes"],
                                   pack=True, chunk=kw["chunk"])
        for k, r, w in zip(keys, report, ref):
            _same(r, w, k)


def test_engine_cache_entries():
    """A sharded sweep builds one engine for its tuple of devices and
    reuses it; ``shard=True`` over one device reuses the plain engine's
    entry; another tuple of devices is another entry."""
    cfg, req, _ = golden.port_shard_leg("cap")
    machine.clear_engine_cache()
    plain = machine.run_many(cfg, req["workloads"], chunk=req["chunk"],
                             device="cpu")
    assert machine.engine_cache_size() == 1
    one = sweep(cfg, SweepRequest(**req), devices=[CPU])
    assert one.shard.n_devices == 1 and one.shard.n_pad_lanes == 0
    assert machine.engine_cache_size() == 1
    for p, s in zip(plain, one):
        _same(s, p, "one-device shard")
    for _ in range(2):
        two = sweep(cfg, SweepRequest(**req), devices=CPUS)
        assert two.shard.n_devices == 2
        assert machine.engine_cache_size() == 2
    for p, s in zip(plain, two):
        _same(s, p, "two-shard lane")
    three = sweep(cfg, SweepRequest(**dict(req, workloads=req["workloads"]
                                           * 2)), devices=[CPU] * 3)
    assert three.shard.n_devices == 3 and machine.engine_cache_size() == 3


def test_deadline_on_sharded_lane():
    """A lane's budget rows travel with it to its shard: the 3x3 BFS cut
    at 21 cycles freezes exactly there, and every lane equals the
    reference's unsharded run with the same deadlines."""
    cfg, req, keys = golden.port_shard_leg("grid")
    rcfg, rkw, _ = ref_shard_leg("grid")
    dls = [21 if k == "bfs/nexus@3x3" else None for k in keys]
    report = sweep(cfg, SweepRequest(**req, deadlines=dls), devices=CPUS)
    ref = ref_machine.run_many(rcfg, rkw["workloads"], modes=rkw["modes"],
                               chunk=rkw["chunk"], deadlines=dls)
    for k, r, w in zip(keys, report, ref):
        _same(r, w, k)
    cut = keys.index("bfs/nexus@3x3")
    assert not report[cut].completed and report[cut].cycles == 21
    assert all(r.completed for i, r in enumerate(report) if i != cut)


def test_sharded_service_soak_matches_records():
    """A ``SweepService`` with 4 super-lanes over four CPU shards (each
    super-lane's state on its shard, masked installs and retirement per
    shard, per-shard ticks) returns every lane of
    ``fig17_traffic(copies=2)`` equal to ``service.json``'s record, on one
    cached engine."""
    want = golden.load_service_golden()
    keys = golden.service_lane_keys(fig17.SIZES)
    cfg, lanes = serve_bench.fig17_traffic(golden.SERVICE["copies"])
    machine.clear_engine_cache()
    with SweepService(cfg, template=lanes, n_supers=4, chunk=64,
                      slice_chunks=1, shard=True, devices=CPUS,
                      device="cpu") as svc:
        assert svc._n_dev == 4
        futs = [svc.submit(w) for w in lanes]
        svc.drain(timeout=600)
        got = {k: golden.lane_record(f.result(timeout=5))
               for k, f in zip(keys, futs)}
        assert svc.stats["n_refills"] > 0
        assert svc.stats["stepped_pe_ticks"] > 0
    golden.check_lanes(got, want["lanes"])
    assert machine.engine_cache_size() == 1


def test_sharded_service_checkpoint_restores_onto_other_splits():
    """A sharded service's checkpoint holds the whole state in the
    reference's layout: a mid-run checkpoint of four shards restores onto
    two shards and onto one device, and the in-flight lanes finish on
    their records."""
    want = golden.load_service_golden()["lanes"]
    keys = golden.service_lane_keys(fig17.SIZES, copies=1)
    cfg, lanes = serve_bench.fig17_traffic(1)
    with tempfile.TemporaryDirectory() as root:
        with SweepService(cfg, template=lanes, n_supers=4, chunk=8,
                          slice_chunks=1, shard=True, devices=CPUS,
                          device="cpu", checkpoint_root=root,
                          checkpoint_every=1, checkpoint_keep=10_000) as svc:
            futs = [svc.submit(w) for w in lanes]
            svc.drain(timeout=600)
            for k, f in zip(keys, futs):
                assert golden.lane_record(f.result(timeout=5)) == want[k], k
        steps = list_steps(root)
        assert steps
        for devs in ([CPU] * 2, [CPU]):
            svc2 = SweepService.restore(cfg, root,
                                        step=steps[len(steps) // 2],
                                        device="cpu", devices=devs)
            try:
                assert svc2._n_dev == len(devs)
                restored = svc2.futures
                assert restored
                svc2.drain(timeout=600)
                for seq, f in restored.items():
                    assert golden.lane_record(f.result(timeout=5)) == \
                        want[keys[seq]], (devs, keys[seq])
            finally:
                svc2.shutdown()


def test_devices_that_do_not_exist_raise():
    """No fallback: ``shard=True`` over a device this host does not have
    raises before any cycle runs, in ``run_many`` and in the service; with
    no ``devices`` the CPU shards over its one device."""
    cfg, req, _ = golden.port_shard_leg("cap")
    gone = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(ValueError, match="does not exist"):
        machine.run_many(cfg, req["workloads"], shard=True, device="cpu",
                         devices=[CPU, gone])
    with pytest.raises(ValueError, match="does not exist"):
        SweepService(cfg, shard=True, device="cpu", devices=[gone])
    assert machine.shard_devices("cpu") == [CPU]
    report = sweep(cfg, SweepRequest(**req), device="cpu")
    assert report.shard.n_devices == 1


def test_default_devices_put_the_named_card_first(monkeypatch):
    """With no ``devices``, a ``device`` that names its card comes first
    among the visible cards, so a split into one shard (one lane, or a
    service whose super-lane count has no other divisor) runs on the
    card the caller named; an unnamed ``cuda`` keeps the cards' order."""
    from repro_torch.launch import mesh
    cards = [torch.device("cuda", i) for i in range(3)]
    monkeypatch.setattr(mesh, "visible_devices", lambda kind: list(cards))
    monkeypatch.setattr(mesh, "check_devices", list)
    assert machine.shard_devices("cuda:1") == [cards[1], cards[0], cards[2]]
    assert machine.shard_devices(torch.device("cuda", 2))[0] == cards[2]
    assert machine.shard_devices("cuda") == cards
    assert machine.shard_devices("cuda:1", devices=cards) == cards


def test_shard_golden_matches_reference(want):
    """``shard.json`` is exactly what the reference's ``sweep(...,
    shard=True)`` gives today under four forced host devices."""
    got = reference_shard_records()
    assert list(got) == list(golden.SHARD_LEGS) == list(want)
    for name in golden.SHARD_LEGS:
        golden.check_shard(got[name], want[name])


if __name__ == "__main__":
    with open(golden.SHARD_GOLDEN_PATH, "w") as f:
        json.dump(reference_shard_records(timeout=900), f, indent=1)
        f.write("\n")
    print("wrote", golden.SHARD_GOLDEN_PATH)
