"""Chaos-hardening of the port's sweep service (``repro_torch.serve.chaos``
+ ``fabric``) against the JAX reference: the 13 cases of
``tests/test_chaos.py`` on the same 12-lane traffic, every result held
bit for bit (``to_json()`` and the full ``mem_val``) to the reference's
one-shot ``run_many``, plus checkpoints crossing packages: a mid-soak
checkpoint written by the reference's ``SweepService`` is restored by the
port's, and the reverse, and every in-flight lane finishes on the
reference's bits.

The reference tests' default chunk of 512 is cut to 16 here (results
are bit-identical across chunk sizes); the reference's runs use chunk 8,
so its one-shot oracle and its service share one compiled engine.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import machine as ref_machine  # noqa: E402
from repro.serve import SweepService as RefService  # noqa: E402
from repro.serve import chaos as ref_chaos  # noqa: E402

from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.checkpoint.store import list_steps  # noqa: E402
from repro_torch.core import compiler  # noqa: E402
from repro_torch.core.machine import MachineConfig  # noqa: E402
from repro_torch.serve import (DeadlineError, FaultSchedule,  # noqa: E402
                               RetryPolicy, ServiceError, SweepService,
                               TransientFault, run_soak)
from repro_torch.serve.chaos import (BlockingHook,  # noqa: E402
                                     results_bit_identical)

from test_torch_service import build_traffic  # noqa: E402

CHUNK = 16


def _cfg(w=4, h=4, **kw):
    kw.setdefault("mem_words", 1024)
    kw.setdefault("max_cycles", 100_000)
    return MachineConfig(width=w, height=h, **kw)


def _ref_cfg(w=4, h=4, **kw):
    kw.setdefault("mem_words", 1024)
    kw.setdefault("max_cycles", 100_000)
    return ref_machine.MachineConfig(width=w, height=h, **kw)


def _same(r, w) -> bool:
    """Bit-identity of a port result and a reference result."""
    return (r.to_json() == w.to_json()
            and np.array_equal(np.asarray(r.mem_val), np.asarray(w.mem_val)))


@pytest.fixture(scope="module")
def built():
    return build_traffic(23)


@pytest.fixture(scope="module")
def traffic(built):
    lanes, _, modes = built
    return lanes, modes


@pytest.fixture(scope="module")
def reference(built):
    _, ref_lanes, modes = built
    return ref_machine.run_many(_ref_cfg(), ref_lanes, modes=modes, chunk=8)


def _service(**kw):
    kw.setdefault("chunk", CHUNK)
    return SweepService(_cfg(), device="cpu", **kw)


def _dl_lane(reference, div):
    lane = max(range(len(reference)), key=lambda i: reference[i].cycles)
    return lane, max(1, reference[lane].cycles // div)


# ----------------------------------------------------------------------
# the acceptance soak: kills + transients + deadline + restore
# ----------------------------------------------------------------------
def test_chaos_soak_survivors_bit_identical_and_restore(tmp_path, built,
                                                        reference):
    lanes, ref_lanes, modes = built
    dl_lane, dl = _dl_lane(reference, 2)
    root = str(tmp_path / "ckpt")
    sched = FaultSchedule.seeded(5, n_transients=2, n_kills=1, horizon=6)
    report, svc = run_soak(
        _cfg(), lanes, modes=modes, seed=5, schedule=sched,
        deadline_lane=dl_lane, deadline_cycles=dl, duplicates=2,
        service_kwargs=dict(template=lanes, n_supers=2, chunk=8,
                            slice_chunks=1, checkpoint_root=root,
                            checkpoint_every=2), device="cpu")
    svc.shutdown()

    kinds = {k for _, _, k in report.fired}
    assert kinds == {"transient", "kill"}, report.fired
    assert report.stats["n_retries"] >= 2
    assert report.stats["n_restarts"] >= 1
    assert report.stats["n_checkpoints"] >= 1

    assert set(report.survivors) == set(range(len(lanes))) - {dl_lane}
    for i, r in report.survivors.items():
        assert _same(r, reference[i]), f"lane {i}"
    assert report.duplicate_results
    for i, r in report.duplicate_results.items():
        assert _same(r, reference[i]), f"dup lane {i}"

    assert set(report.deadline_failures) == {dl_lane}
    err = report.deadline_failures[dl_lane]
    assert err.result is not None and not err.result.completed
    assert err.result.cycles == dl
    assert err.result.per_pe_busy.shape[0] == np.prod(lanes[dl_lane].geom)
    assert err.telemetry is not None and err.telemetry.engine_calls > 0
    assert report.stats["n_deadline_failures"] == 1
    # the reference's deadlined run_many (lanes are independent, so the
    # lane frozen in the whole batch is the lane frozen alone; the batch
    # keeps the fixture's compiled engine)
    solo = ref_machine.run_many(
        _ref_cfg(), ref_lanes, modes=modes, chunk=8,
        deadlines=[dl if i == dl_lane else None
                   for i in range(len(lanes))])[dl_lane]
    assert _same(err.result, solo)

    steps = list_steps(root)
    assert steps, "soak wrote no checkpoints"
    svc2 = SweepService.restore(_cfg(), root, step=steps[len(steps) // 2],
                                device="cpu")
    try:
        futs = svc2.futures
        assert futs, "mid-soak checkpoint held no in-flight lanes"
        svc2.drain(timeout=600)
        for seq, f in futs.items():
            lane = report.seq_lane[seq]
            try:
                r = f.result(timeout=5)
            except DeadlineError as e:
                assert lane == dl_lane and _same(e.result, solo)
            else:
                assert _same(r, reference[lane]), \
                    f"restored lane {lane} (seq {seq}) drifted"
    finally:
        svc2.shutdown()


# ----------------------------------------------------------------------
# deadlines
# ----------------------------------------------------------------------
def test_deadline_fails_own_future_coteants_unaffected(traffic, reference):
    lanes, modes = traffic
    dl_lane, dl = _dl_lane(reference, 3)
    with _service(template=lanes, n_supers=2, slice_chunks=1) as svc:
        futs = [svc.submit(w, mode=m,
                           deadline_cycles=dl if i == dl_lane else None)
                for i, (w, m) in enumerate(zip(lanes, modes))]
        svc.drain(timeout=600)
        for i, f in enumerate(futs):
            if i == dl_lane:
                with pytest.raises(DeadlineError) as ei:
                    f.result(timeout=5)
                assert ei.value.result.cycles == dl
                assert not ei.value.result.completed
            else:
                assert _same(f.result(timeout=5), reference[i]), f"lane {i}"
        again = svc.submit(lanes[dl_lane], mode=modes[dl_lane])
        svc.drain(timeout=600)
        assert _same(again.result(timeout=5), reference[dl_lane])


def test_deadline_validation():
    with SweepService(_cfg(), device="cpu") as svc:
        a = compiler.random_sparse(4, 4, 0.5, np.random.default_rng(0))
        wl = compiler.build_spmv(a, np.arange(4), _cfg(2, 2))
        with pytest.raises(ValueError, match="deadline_cycles"):
            svc.submit(wl, deadline_cycles=0)
        with pytest.raises(ValueError, match="deadline_s"):
            svc.submit(wl, deadline_s=-1.0)


def test_wall_deadline_expires_in_pending_queue(traffic):
    lanes, modes = traffic
    hook = BlockingHook("pre_slice")
    svc = _service(template=lanes, n_supers=2, fault_hook=hook)
    try:
        blocker = svc.submit(lanes[0], mode=modes[0])
        assert hook.entered.wait(timeout=60)
        doomed = svc.submit(lanes[1], mode=modes[1], deadline_s=0.01)
        time.sleep(0.05)
        hook.release()
        svc.drain(timeout=600)
        blocker.result(timeout=5)
        with pytest.raises(DeadlineError) as ei:
            doomed.result(timeout=5)
        assert ei.value.result is None
        assert ei.value.telemetry is not None
    finally:
        svc.shutdown()


# ----------------------------------------------------------------------
# retry policy + fatal escalation
# ----------------------------------------------------------------------
def test_transient_faults_are_retried_exactly(traffic, reference):
    lanes, modes = traffic
    sched = FaultSchedule({"pre_slice": {0: "transient", 2: "transient"}})
    with _service(template=lanes, n_supers=2, fault_hook=sched,
                  retry=RetryPolicy(backoff_s=0.001)) as svc:
        futs = [svc.submit(w, mode=m) for w, m in zip(lanes, modes)]
        svc.drain(timeout=600)
        for i, f in enumerate(futs):
            assert _same(f.result(timeout=5), reference[i]), f"lane {i}"
        assert svc.stats["n_retries"] == 2
        assert [k for _, _, k in sched.fired] == ["transient", "transient"]


def test_retry_exhaustion_escalates_to_service_error(traffic):
    lanes, modes = traffic
    sched = FaultSchedule({"pre_slice": {0: "transient", 1: "transient"}})
    svc = _service(template=lanes, n_supers=2, fault_hook=sched,
                   retry=RetryPolicy(max_retries=1, backoff_s=0.001))
    try:
        fut = svc.submit(lanes[0], mode=modes[0])
        with pytest.raises(ServiceError):
            svc.drain(timeout=600)
        with pytest.raises(ServiceError, match="transient fault"):
            fut.result(timeout=5)
        with pytest.raises(ServiceError):
            svc.submit(lanes[1], mode=modes[1])
    finally:
        svc.shutdown(wait=False)


def test_poisoned_install_fails_all_unresolved_then_submit_raises(traffic):
    """A fault at the install phase is fatal by design — every
    unresolved future fails with ServiceError and the service raises
    (never hangs) afterward."""
    lanes, modes = traffic

    class PoisonedInstall:
        def __init__(self):
            self.entered = threading.Event()
            self.go = threading.Event()

        def __call__(self, phase, service):
            if phase == "install":
                self.entered.set()
                self.go.wait()
                raise RuntimeError("poisoned install")

    hook = PoisonedInstall()
    svc = _service(template=lanes, n_supers=2, fault_hook=hook)
    try:
        futs = [svc.submit(w, mode=m)
                for w, m in zip(lanes[:4], modes[:4])]
        assert hook.entered.wait(timeout=60)
        hook.go.set()
        with pytest.raises(ServiceError):
            svc.drain(timeout=600)
        for f in futs:
            with pytest.raises(ServiceError, match="poisoned install"):
                f.result(timeout=5)
        with pytest.raises(ServiceError, match="failed"):
            svc.submit(lanes[0], mode=modes[0])
    finally:
        svc.shutdown(wait=False)


def test_retry_policy_backoff_caps():
    """The reference's policy, and the port's one difference: a failure
    inside the engine is never retried, whatever the predicate says (the
    engine updates the resident state in place)."""
    p = RetryPolicy(max_retries=5, backoff_s=0.1, max_backoff_s=0.3)
    assert [p.delay(a) for a in (1, 2, 3, 4)] == [0.1, 0.2, 0.3, 0.3]
    assert p.transient(TransientFault("x"))
    assert not p.transient(RuntimeError("x"))
    custom = RetryPolicy(is_transient=lambda e: "flaky" in str(e))
    assert custom.transient(RuntimeError("flaky link"))
    assert not custom.transient(TransientFault("not matching"))
    svc = SweepService(_cfg(), device="cpu",
                       retry=RetryPolicy(is_transient=lambda e: True))
    try:
        calls = []

        def failing_engine(*args):
            calls.append(1)
            raise RuntimeError("flaky engine")

        a = compiler.random_sparse(4, 4, 0.5, np.random.default_rng(0))
        wl = compiler.build_spmv(a, np.arange(4), _cfg(2, 2))
        svc._build_arena([wl])
        svc._engine = failing_engine
        fut = svc.submit(wl)
        with pytest.raises(ServiceError, match="flaky engine"):
            svc.drain(timeout=60)
        assert isinstance(fut.exception(timeout=5), ServiceError)
        assert len(calls) == 1 and svc.stats["n_retries"] == 0
    finally:
        svc.shutdown(wait=False)


# ----------------------------------------------------------------------
# kill/restart determinism (without the full soak)
# ----------------------------------------------------------------------
def test_scheduler_kill_restart_resumes_bit_identical(traffic, reference):
    lanes, modes = traffic
    sched = FaultSchedule({"post_slice": {1: "kill", 3: "kill"}})
    with _service(template=lanes, n_supers=2, chunk=8, slice_chunks=1,
                  fault_hook=sched) as svc:
        futs = [svc.submit(w, mode=m) for w, m in zip(lanes, modes)]
        svc.drain(timeout=600)          # drain revives the scheduler
        assert svc.stats["n_restarts"] == 2
        for i, f in enumerate(futs):
            assert _same(f.result(timeout=5), reference[i]), f"lane {i}"


def test_fault_schedule_seeded_deterministic():
    """The port's schedules equal the reference's, seed for seed."""
    a = FaultSchedule.seeded(7, n_transients=3, n_kills=2, horizon=10)
    b = FaultSchedule.seeded(7, n_transients=3, n_kills=2, horizon=10)
    assert a.faults == b.faults
    assert a.faults == ref_chaos.FaultSchedule.seeded(
        7, n_transients=3, n_kills=2, horizon=10).faults
    assert len(a.faults["pre_slice"]) == 3
    assert len(a.faults["post_slice"]) == 2
    with pytest.raises(ValueError, match="unknown kind"):
        FaultSchedule({"pre_slice": {0: "segfault"}})
    with pytest.raises(ValueError, match="horizon"):
        FaultSchedule.seeded(1, n_transients=9, n_kills=9, horizon=4)


# ----------------------------------------------------------------------
# checkpoint/restore edge cases
# ----------------------------------------------------------------------
def test_restore_rejects_foreign_checkpoint(tmp_path):
    root = str(tmp_path / "foreign")
    save_checkpoint(root, 0, {"x": np.zeros(3)}, extra={"note": "not ours"})
    with pytest.raises(ValueError, match="not a SweepService snapshot"):
        SweepService.restore(_cfg(), root, device="cpu")


def test_restore_requires_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        SweepService.restore(_cfg(), str(tmp_path / "empty"), device="cpu")


def test_restore_carries_pending_queue(tmp_path, traffic, reference):
    """A checkpoint taken while lanes still WAIT in the pending queue
    restores them as array-only workloads and runs them to the same
    bits."""
    lanes, modes = traffic
    root = str(tmp_path / "ckpt")
    hook = BlockingHook("post_slice")
    svc = _service(template=lanes, n_supers=2, chunk=8, slice_chunks=1,
                   fault_hook=hook, checkpoint_root=root,
                   checkpoint_every=1, checkpoint_keep=10_000)
    seqs = {}
    try:
        for i, (w, m) in enumerate(zip(lanes, modes)):
            seqs[i] = len(seqs)
            svc.submit(w, mode=m)
        assert hook.entered.wait(timeout=120)
        hook.release()
        svc.drain(timeout=600)
    finally:
        svc.shutdown()
    steps = list_steps(root)
    assert steps
    svc2 = SweepService.restore(_cfg(), root, step=steps[0], device="cpu")
    try:
        futs = svc2.futures
        assert any(t.workload is not None for t in svc2._pending), \
            "the first checkpoint must still hold pending lanes"
        lane_of = {seq: i for i, seq in seqs.items()}
        svc2.drain(timeout=600)
        for seq, f in futs.items():
            assert _same(f.result(timeout=5), reference[lane_of[seq]]), \
                f"restored lane {lane_of[seq]}"
    finally:
        svc2.shutdown()


# ----------------------------------------------------------------------
# checkpoints across packages
# ----------------------------------------------------------------------
def _soak_kwargs(root):
    return dict(template=None, n_supers=2, chunk=8, slice_chunks=1,
                checkpoint_root=root, checkpoint_every=2,
                checkpoint_keep=10_000)


def test_reference_checkpoint_restored_by_port(tmp_path, built, reference):
    """A mid-soak checkpoint written by the reference's SweepService is
    restored by the port's (``device="cpu"``): every in-flight lane, the
    pending queue's included, finishes on the reference's bits."""
    lanes, ref_lanes, modes = built
    root = str(tmp_path / "ref")
    kw = dict(_soak_kwargs(root), template=ref_lanes)
    report, svc = ref_chaos.run_soak(
        _ref_cfg(), ref_lanes, modes=modes, seed=5,
        schedule=ref_chaos.FaultSchedule.seeded(5, n_transients=2,
                                                n_kills=1, horizon=6),
        duplicates=2, service_kwargs=kw)
    svc.shutdown()
    steps = list_steps(root)
    assert len(steps) >= 2
    svc2 = SweepService.restore(_cfg(), root, step=steps[len(steps) // 2],
                                device="cpu")
    try:
        futs = svc2.futures
        assert futs, "the checkpoint held no in-flight lanes"
        svc2.drain(timeout=600)
        for seq, f in futs.items():
            lane = report.seq_lane[seq]
            assert _same(f.result(timeout=5), reference[lane]), \
                f"lane {lane} (seq {seq}) restored by the port drifted"
    finally:
        svc2.shutdown()


def test_port_checkpoint_restored_by_reference(tmp_path, built, reference):
    """The reverse: a mid-soak checkpoint of the port's service, restored
    by the reference's SweepService, finishes every in-flight lane on the
    reference's bits."""
    lanes, _, modes = built
    root = str(tmp_path / "port")
    report, svc = run_soak(
        _cfg(), lanes, modes=modes, seed=5,
        schedule=FaultSchedule.seeded(5, n_transients=2, n_kills=1,
                                      horizon=6),
        duplicates=2, service_kwargs=dict(_soak_kwargs(root),
                                          template=lanes), device="cpu")
    svc.shutdown()
    steps = list_steps(root)
    assert len(steps) >= 2
    svc2 = RefService.restore(_ref_cfg(), root, step=steps[len(steps) // 2])
    try:
        futs = svc2.futures
        assert futs, "the checkpoint held no in-flight lanes"
        svc2.drain(timeout=600)
        for seq, f in futs.items():
            lane = report.seq_lane[seq]
            assert _same(f.result(timeout=5), reference[lane]), \
                f"lane {lane} (seq {seq}) restored by the reference drifted"
    finally:
        svc2.shutdown()
