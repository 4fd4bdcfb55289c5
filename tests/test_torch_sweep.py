"""The port's structured sweep surface against the JAX reference:
``sweep(cfg, SweepRequest(...))`` equals the ``run_many`` shim and the
reference's report, deadlines freeze only their own lane, and the
reference's error paths are kept."""
import dataclasses
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compiler as ref_compiler  # noqa: E402
from repro.core import machine as ref  # noqa: E402
from repro.core.sweep import SweepRequest as RefRequest  # noqa: E402
from repro.core.sweep import sweep as ref_sweep  # noqa: E402

from repro_torch.analysis import WorkloadValidationError  # noqa: E402
from repro_torch.core import am, batch, compiler, machine  # noqa: E402
from repro_torch.core.sweep import (PackStats, SweepReport,  # noqa: E402
                                    SweepRequest, sweep)


def _cfg(**kw):
    kw.setdefault("mem_words", 1024)
    kw.setdefault("max_cycles", 100_000)
    return machine.MachineConfig(**kw)


def _ref_cfg(**kw):
    kw.setdefault("mem_words", 1024)
    kw.setdefault("max_cycles", 100_000)
    return ref.MachineConfig(**kw)


@pytest.fixture(scope="module")
def mixed():
    """Three mixed-size spmv lanes (2x2, 3x3, 4x4), compiled by both
    packages (the reference sweep tests' lanes)."""
    rng = np.random.default_rng(9)
    port, want = [], []
    for n in (2, 3, 4):
        a = ref_compiler.random_sparse(6, 6, 0.4, rng)
        x = rng.integers(-3, 4, size=(6,))
        want.append(ref_compiler.build_spmv(a, x, _ref_cfg(width=n,
                                                           height=n)))
        port.append(compiler.build_spmv(a, x, _cfg(width=n, height=n)))
    return port, want


def _sig(r):
    return (r.to_json(), np.asarray(r.stall_per_port).tolist(),
            np.asarray(r.mem_val).tolist())


@pytest.mark.parametrize("pack", [False, True], ids=["plain", "packed"])
def test_sweep_equals_shim_and_reference(mixed, pack):
    """sweep() == run_many(pack_stats=..., shard_stats=...) (which warns)
    lane for lane and dict for dict, and the report's JSON is the
    reference's, telemetry included."""
    wls, wls_ref = mixed
    ps: dict = {}
    ss: dict = {}
    with pytest.warns(DeprecationWarning, match="SweepRequest"):
        legacy = machine.run_many(_cfg(), wls, pack=pack, pack_stats=ps,
                                  shard_stats=ss, chunk=64, device="cpu")
    report = sweep(_cfg(), SweepRequest(workloads=wls, pack=pack, chunk=64),
                   device="cpu")
    assert isinstance(report, SweepReport) and len(report) == 3
    for r_new, r_old in zip(report, legacy):
        assert _sig(r_new) == _sig(r_old)
    if pack:
        assert isinstance(report.pack, PackStats)
        assert report.pack.to_json() == ps
    want = ref_sweep(_ref_cfg(), RefRequest(workloads=wls_ref, pack=pack,
                                            chunk=64))
    assert report.to_json() == want.to_json()
    for r, w in zip(report, want):
        assert _sig(r) == _sig(w)
    json.dumps(report.to_json())
    # the reference's shim fills shard_stats with the same one-device plan
    ps_r: dict = {}
    ss_r: dict = {}
    with pytest.warns(DeprecationWarning):
        ref.run_many(_ref_cfg(), wls_ref, pack=pack, pack_stats=ps_r,
                     shard_stats=ss_r, chunk=64)
    assert ss == ss_r and ps == ps_r


def test_plain_run_many_does_not_warn(mixed):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = machine.run_many(_cfg(), mixed[0], pack=True, chunk=64,
                               device="cpu")
    assert all(r.completed for r in res)


@pytest.mark.parametrize("pack", [False, True], ids=["plain", "packed"])
def test_deadline_freezes_only_its_lane(mixed, pack):
    """A deadlined lane comes back frozen exactly at its bound with
    completed=False; the other lanes equal the unbounded sweep and the
    reference's deadlined sweep, packed and unpacked.  (The cap of 2,048
    cycles bounds the reference's fault of ROADMAP.md section 3: a
    deadlined sub-lane 0 keeps its super-lane's uncovered PEs ticking to
    ``max_cycles``; every lane here finishes in under 100 cycles.)"""
    wls, wls_ref = mixed
    cfg, ref_cfg = _cfg(max_cycles=2048), _ref_cfg(max_cycles=2048)
    free = sweep(cfg, SweepRequest(workloads=wls, chunk=64), device="cpu")
    victim = max(range(3), key=lambda i: free[i].cycles)
    dl = max(1, free[victim].cycles // 2)
    dls = [dl if i == victim else None for i in range(3)]
    rep = sweep(cfg, SweepRequest(workloads=wls, pack=pack, deadlines=dls,
                                  chunk=64), device="cpu")
    assert rep[victim].cycles == dl and not rep[victim].completed
    for i in range(3):
        if i != victim:
            assert _sig(rep[i]) == _sig(free[i]), i
    want = ref_sweep(ref_cfg, RefRequest(workloads=wls_ref, pack=pack,
                                         deadlines=dls, chunk=64))
    assert rep.to_json() == want.to_json()
    for r, w in zip(rep, want):
        assert _sig(r) == _sig(w)


@pytest.mark.parametrize("validate", ["static", "strict", "off"])
def test_validate_tiers_match_reference(mixed, validate):
    """Each validation tier passes the clean lanes with the reference's
    results; "static" and "strict" reject a corrupted lane before any
    cycle runs, naming it, and "off" dispatches it."""
    wls, wls_ref = mixed
    rep = sweep(_cfg(), SweepRequest(workloads=wls, validate=validate,
                                     chunk=64), device="cpu")
    want = ref_sweep(_ref_cfg(), RefRequest(workloads=wls_ref,
                                            validate=validate, chunk=64))
    assert rep.to_json() == want.to_json()
    bad = dataclasses.replace(wls[0], static_ams=wls[0].static_ams.copy())
    pe = int(np.argmax(np.asarray(bad.amq_len)))
    bad.static_ams[pe, 0, am.F_DST0] = 999
    req = SweepRequest(workloads=[wls[1], bad], validate=validate, chunk=64)
    if validate == "off":
        # dispatched unchecked: the rogue message never lands, so the
        # lane runs to the (here small) cycle cap
        rep = sweep(_cfg(max_cycles=256), req, device="cpu")
        assert rep[0].completed and not rep[1].completed
        return
    with pytest.raises(WorkloadValidationError) as ei:
        sweep(_cfg(), req, device="cpu")
    assert any(f.lane == 1 and f.code == "wf.dst-out-of-mesh"
               for f in ei.value.findings)
    assert all(f.lane != 0 for f in ei.value.findings)


def test_request_is_frozen_and_validates_early(mixed):
    """The request keeps the reference's fields and checks: tuples, an
    unknown validate tier, wrong-length hints or deadlines."""
    assert [f.name for f in dataclasses.fields(SweepRequest)] == \
        [f.name for f in dataclasses.fields(RefRequest)]
    req = SweepRequest(workloads=[object()], modes=["nexus"],
                       cycle_hints=[7], super_geom=[4, 4])
    assert req.modes == ("nexus",) and req.super_geom == (4, 4)
    with pytest.raises(dataclasses.FrozenInstanceError):
        req.pack = True
    with pytest.raises(ValueError, match="validate"):
        SweepRequest(workloads=[object()], validate="paranoid")
    with pytest.raises(ValueError, match="2 cycle hints for 3 lanes"):
        SweepRequest(workloads=[object()] * 3, cycle_hints=[1.0, 2.0])
    with pytest.raises(ValueError, match="deadlines"):
        SweepRequest(workloads=mixed[0], deadlines=[10])
    with pytest.raises(ValueError, match="deadline"):
        SweepRequest(workloads=mixed[0], deadlines=[0, None, None])
    with pytest.raises(TypeError, match="SweepRequest"):
        sweep(_cfg(), mixed[0], device="cpu")


def test_error_paths(mixed, monkeypatch):
    """The reference's errors: a prestacked batch or a geometry override
    under pack, hints of the wrong length, a corrupted packed batch
    (rectangle escape, caught before any cycle), and shard=True over a
    device that does not exist (no fallback to another device)."""
    wls = mixed[0]
    with pytest.raises(ValueError, match="already stacked"):
        machine.run_many(_cfg(), batch.stack_workloads(wls[:1]), pack=True,
                         device="cpu")
    with pytest.raises(ValueError, match="geoms"):
        machine.run_many(_cfg(), wls[:1], geoms=[(2, 2)], pack=True,
                         device="cpu")
    with pytest.raises(ValueError, match="cycle hints for"):
        machine.run_many(_cfg(), wls, pack=True, cycle_hints=[1.0],
                         device="cpu")
    # shard=True splits over the devices it is given
    # (tests/test_torch_shard.py holds it to the reference); one that
    # does not exist raises before any cycle runs
    gone = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(ValueError, match="does not exist"):
        sweep(_cfg(), SweepRequest(workloads=wls, shard=True), device="cpu",
              devices=["cpu", gone])
    real_pack = batch.pack_workloads

    def corrupting_pack(*a, **kw):
        wb = real_pack(*a, **kw)
        src = int(np.argmax(np.asarray(wb.amq_len[0])))
        other = int(np.nonzero(np.asarray(wb.sub_ids[0])
                               != wb.sub_ids[0, src])[0][0])
        wb.static_ams[0, src, 0, am.F_DST0] = other
        return wb

    monkeypatch.setattr(batch, "pack_workloads", corrupting_pack)
    two = [compiler.build_spmv(np.eye(4, dtype=np.int64) * 2,
                               np.arange(4), _cfg(width=2, height=2,
                                                  mem_words=4096))
           for _ in range(2)]
    with pytest.raises(WorkloadValidationError, match="rect-escape"):
        machine.run_many(_cfg(width=4, height=2), two, pack=True,
                         super_geom=(4, 2), device="cpu")


def test_packed_overflow_names_input_lanes(mixed, monkeypatch):
    """A super-lane tripping the pending-FIFO guard is reported as the
    input lanes it hosts (``RuntimeError.lanes``), as in the reference."""
    monkeypatch.setattr(machine, "PEND_CAP", 4)
    monkeypatch.setattr(machine, "STREAM_THROTTLE", 10**9)
    monkeypatch.setattr(ref, "PEND_CAP", 4)
    monkeypatch.setattr(ref, "STREAM_THROTTLE", 10**9)
    rng = np.random.default_rng(1)
    a = ref_compiler.random_sparse(16, 16, 0.5, rng)
    x = rng.integers(-4, 5, size=(16,))
    lanes = [compiler.build_spmv(a, x, _cfg(width=4, height=4)), mixed[0][0]]
    lanes_ref = [ref_compiler.build_spmv(a, x, _ref_cfg(width=4, height=4)),
                 mixed[1][0]]
    with pytest.raises(RuntimeError, match="packed input lanes") as ei:
        machine.run_many(_cfg(), lanes, pack=True, chunk=1, device="cpu")
    with pytest.raises(RuntimeError, match="packed input lanes") as ei_ref:
        ref.run_many(_ref_cfg(), lanes_ref, pack=True, chunk=1)
    assert str(ei.value) == str(ei_ref.value)
    assert ei.value.lanes == [0]
