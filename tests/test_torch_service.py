"""The port's resident sweep service (``repro_torch.serve.SweepService``)
against the JAX reference, on the 12-lane traffic of
``tests/test_sweep_service.py`` (spmv/bfs x 2x2/3x3/4x4 x two copies,
nexus/tia), built by both packages from the same arrays.

Every future's result must equal the reference's one-shot ``run_many``
bit for bit (``to_json()`` and the full ``mem_val``); the service runs on
ONE cached engine, the entry a blocking ``run_many`` of the same arena
hits.  The engine chunk is cut from the reference tests' 512 to 16 so
each slice is short on the CPU: results are bit-identical across chunk
sizes.  Also here: the host copies of the state no longer alias it, and
an install never writes into a client's workload arrays.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.workloads import small_world_graph  # noqa: E402
from repro.core import compiler as ref_compiler  # noqa: E402
from repro.core import machine as ref_machine  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import compiler, machine  # noqa: E402
from repro_torch.core.machine import MachineConfig  # noqa: E402
from repro_torch.serve import (CapacityError, ServiceError,  # noqa: E402
                               SweepService)
from repro_torch.serve.chaos import BlockingHook  # noqa: E402

CHUNK = 16


def _cfg(w=4, h=4, **kw):
    kw.setdefault("mem_words", 1024)
    kw.setdefault("max_cycles", 100_000)
    return MachineConfig(width=w, height=h, **kw)


def _ref_cfg(w=4, h=4, **kw):
    kw.setdefault("mem_words", 1024)
    kw.setdefault("max_cycles", 100_000)
    return ref_machine.MachineConfig(width=w, height=h, **kw)


def _assert_same(r, w, label):
    assert r.to_json() == w.to_json(), label
    np.testing.assert_array_equal(np.asarray(r.mem_val),
                                  np.asarray(w.mem_val), err_msg=str(label))


def build_traffic(seed):
    """The reference tests' mixed traffic from ``default_rng(seed)``,
    compiled by the port and by the reference from the same arrays:
    ``(port_lanes, reference_lanes, modes)``."""
    rng = np.random.default_rng(seed)
    lanes, ref_lanes, modes = [], [], []
    for n in (2, 3, 4):
        a = ref_compiler.random_sparse(6, 6, 0.4, rng)
        x = rng.integers(-3, 4, size=(6,))
        rp, col = small_world_graph(12, 4, 2)
        for _ in range(2):
            lanes.append(compiler.build_spmv(a, x, _cfg(n, n)))
            ref_lanes.append(ref_compiler.build_spmv(a, x, _ref_cfg(n, n)))
            modes.append("nexus")
            lanes.append(compiler.build_bfs(rp, col, 0, _cfg(n, n)))
            ref_lanes.append(ref_compiler.build_bfs(rp, col, 0,
                                                    _ref_cfg(n, n)))
            modes.append("tia")
    return lanes, ref_lanes, modes


@pytest.fixture(scope="module")
def traffic():
    lanes, _, modes = build_traffic(17)
    return lanes, modes


@pytest.fixture(scope="module")
def reference():
    """The reference's one-shot blocking run_many of the same lanes — the
    bit-identity oracle for every service result."""
    _, ref_lanes, modes = build_traffic(17)
    return ref_machine.run_many(_ref_cfg(), ref_lanes, modes=modes)


def _service(**kw):
    kw.setdefault("chunk", CHUNK)
    return SweepService(_cfg(**kw.pop("cfg", {})), device="cpu", **kw)


def test_service_soak_bit_identical_one_engine_clean_drain(traffic,
                                                           reference):
    lanes, modes = traffic
    machine.clear_engine_cache()
    rng = np.random.default_rng(0)
    with _service(template=lanes, n_supers=2, slice_chunks=1) as svc:
        for rd in range(2):
            order = [int(i) for i in rng.permutation(len(lanes))]
            futs = {}
            for i in order:
                hint = reference[i].cycles if i % 3 == 0 else None
                futs[i] = svc.submit(lanes[i], mode=modes[i],
                                     cycle_hint=hint)
            svc.drain(timeout=600)
            assert all(f.done() for f in futs.values()), "orphaned futures"
            for i, f in futs.items():
                _assert_same(f.result(), reference[i],
                             f"round {rd} lane {i}")
        assert machine.engine_cache_size() == 1, \
            "the service must stay on ONE cached engine"
        assert svc.stats["n_retired"] == 2 * len(lanes)
        assert svc.stats["n_refills"] > 0, \
            "oversubscribed traffic must exercise mid-wave refill"
        assert 0 < svc.refill_occupancy <= 1
    with pytest.raises(ServiceError, match="shut down"):
        svc.submit(lanes[0], mode=modes[0])


def test_service_hits_the_same_engine_cache_entry(traffic, reference):
    """A blocking run_many of the same traffic, then the service: one
    shared cache entry, not one each."""
    lanes, modes = traffic
    machine.clear_engine_cache()
    blocking = machine.run_many(_cfg(), lanes, modes=modes, chunk=CHUNK,
                                device="cpu")
    assert machine.engine_cache_size() == 1
    with _service(template=lanes, n_supers=2) as svc:
        futs = [svc.submit(wl, mode=m) for wl, m in zip(lanes, modes)]
        svc.drain(timeout=600)
        for f, b, w in zip(futs, blocking, reference):
            _assert_same(f.result(), w, "service lane")
            _assert_same(b, w, "blocking lane")
    assert machine.engine_cache_size() == 1, \
        "the service arena must reuse run_many's engine entry"


def test_lazy_template_first_batch_sizes_arena(traffic, reference):
    """template=None: the first submission batch sizes the arena."""
    lanes, _ = traffic
    with _service(n_supers=2) as svc:
        futs = [svc.submit(lanes[0], mode="nexus") for _ in range(3)]
        svc.drain(timeout=300)
        for f in futs:
            _assert_same(f.result(), reference[0], "lazy lane")


def test_capacity_error_for_oversize_lane(traffic):
    lanes, _ = traffic
    rng = np.random.default_rng(1)
    a = compiler.random_sparse(6, 6, 0.4, rng)
    x = rng.integers(-3, 4, size=(6,))
    big = compiler.build_spmv(a, x, _cfg(6, 6))
    # template is a single 2x2 lane -> the arena super-mesh is 2x2
    with _service(template=lanes[:1]) as svc:
        with pytest.raises(CapacityError, match="exceeds"):
            svc.submit(big)
        f = svc.submit(lanes[0], mode="nexus")   # service still healthy
        svc.drain(timeout=300)
        assert f.result().completed


def test_shutdown_nowait_fails_unresolved_futures(traffic):
    lanes, modes = traffic
    svc = _service(template=lanes, n_supers=2)
    futs = [svc.submit(wl, mode=m) for wl, m in zip(lanes, modes)]
    svc.shutdown(wait=False)
    assert all(f.done() for f in futs), \
        "shutdown(wait=False) must resolve every future"
    for f in futs:
        e = f.exception()
        assert e is None or isinstance(e, ServiceError)
    with pytest.raises(ServiceError):
        svc.submit(lanes[0], mode=modes[0])


def test_service_rejects_untraced_config():
    with pytest.raises(ValueError, match="traced"):
        SweepService(_cfg(traced_geometry=False), device="cpu")


def test_service_plain_engine_matches_fast_forward(traffic, reference):
    """The sliced service on the PLAIN (fast_forward=False) engine
    reproduces the reference's one-shot fast-forward run bit for bit."""
    lanes, modes = traffic
    machine.clear_engine_cache()
    with _service(cfg=dict(fast_forward=False), template=lanes, n_supers=2,
                  slice_chunks=1) as svc:
        futs = [svc.submit(wl, mode=m) for wl, m in zip(lanes, modes)]
        svc.drain(timeout=600)
        assert svc.stats["engine_ticks"] > 0
        for i, f in enumerate(futs):
            _assert_same(f.result(), reference[i], f"plain-engine lane {i}")
    assert machine.engine_cache_size() == 1


def test_service_sharded_soak(traffic, reference):
    """shard=True on one device (the CPU here, one card on a single-card
    host): the largest divisor of n_supers within one device is 1, so
    the service runs the plain engine, one cache entry, the reference's
    bits."""
    lanes, modes = traffic
    machine.clear_engine_cache()
    with _service(template=lanes, n_supers=4, slice_chunks=1,
                  shard=True) as svc:
        assert svc._n_dev == 1
        futs = [svc.submit(wl, mode=m) for wl, m in zip(lanes, modes)]
        svc.drain(timeout=600)
        for i, (f, w) in enumerate(zip(futs, reference)):
            _assert_same(f.result(), w, f"sharded lane {i}")
        assert machine.engine_cache_size() == 1
        assert svc.stats["n_refills"] > 0


def test_drain_timeout_carries_diagnostics(traffic, reference):
    """A timed-out drain names what is stuck: pending/resident lane
    counts, the oldest ticket's age, and the refill occupancy."""
    lanes, modes = traffic
    hook = BlockingHook("pre_slice")
    svc = _service(template=lanes, n_supers=2, fault_hook=hook)
    try:
        futs = [svc.submit(w, mode=m)
                for w, m in zip(lanes[:3], modes[:3])]
        assert hook.entered.wait(timeout=60)
        with pytest.raises(TimeoutError) as ei:
            svc.drain(timeout=0.3)
        msg = str(ei.value)
        assert "pending lane(s)" in msg and "resident lane(s)" in msg
        assert "oldest ticket age" in msg and "refill_occupancy" in msg
        # the parked lanes are recoverable, not poisoned
        hook.release()
        svc.drain(timeout=600)
        for i, f in enumerate(futs):
            _assert_same(f.result(timeout=5), reference[i],
                         f"post-timeout lane {i}")
    finally:
        svc.shutdown()


def test_capacity_error_in_admit_under_shard(traffic, reference):
    """A lane that can never fit the (explicit) super-mesh, arriving in
    the arena-building first batch of a shard=True service: ITS future
    fails with CapacityError, co-tenant lanes complete bit-identically,
    and the service accepts later submissions."""
    lanes, modes = traffic
    big = compiler.build_spmv(
        compiler.random_sparse(6, 6, 0.4, np.random.default_rng(3)),
        np.arange(6), _cfg(6, 6))
    svc = _service(super_geom=(4, 4), n_supers=4, shard=True)
    try:
        doomed = svc.submit(big, mode="nexus")
        futs = [svc.submit(w, mode=m) for w, m in zip(lanes, modes)]
        svc.drain(timeout=600)
        with pytest.raises(CapacityError, match="exceeds"):
            doomed.result(timeout=5)
        for i, f in enumerate(futs):
            _assert_same(f.result(timeout=5), reference[i],
                         f"sharded co-tenant lane {i}")
        late = svc.submit(lanes[0], mode=modes[0])
        svc.drain(timeout=600)
        _assert_same(late.result(timeout=5), reference[0], "late lane")
    finally:
        svc.shutdown()


def test_install_never_writes_into_client_arrays(traffic, reference):
    """One workload object submitted twice (so its second install lands
    on rows the first run updated in place) keeps its arrays, and both
    runs give the reference's bits."""
    lanes, modes = traffic
    wl = lanes[5]
    before = {f: np.array(getattr(wl, f), copy=True) for f in
              ("prog", "static_ams", "amq_len", "mem_val", "mem_meta")}
    with _service(template=lanes, n_supers=1, slice_chunks=1) as svc:
        futs = [svc.submit(wl, mode=modes[5]) for _ in range(2)]
        svc.drain(timeout=300)
        for f in futs:
            _assert_same(f.result(), reference[5], "resubmitted lane")
    for f, v in before.items():
        np.testing.assert_array_equal(getattr(wl, f), v, err_msg=f)


def test_host_copies_do_not_alias_the_state(traffic):
    """``convert.state_to_numpy`` and ``machine._host_stats`` return
    copies: a later engine call on the same state (which updates
    ``pend``, ``swq`` and ``mem_val`` in place) leaves them unchanged,
    as ``np.asarray`` of a JAX array is in the reference."""
    lanes, _ = traffic
    wl = lanes[1]
    cfg = _cfg(2, 2)
    n = 4
    st = machine.init_state(cfg, wl.static_ams[None], wl.amq_len[None],
                            wl.mem_val[None], wl.mem_meta[None],
                            device="cpu")

    def t(a):
        return torch.tensor(np.asarray(a, np.int32))

    args = (t(wl.prog[None]), t([machine.resolve_mode("tia")]),
            t([[2, 2]]), t(np.zeros((1, n))), t(np.arange(n)[None]))

    def bud(v):
        return torch.full((1, n), v, dtype=torch.int32)

    st, _, _, _ = machine.run_engine(cfg, *args, st, bud(6), chunk=4)
    leaves = convert.state_to_numpy(st)
    stats = machine._host_stats(st)
    kept = {k: v.copy() for k, v in leaves.items()}
    kept_stats = {k: v.copy() for k, v in stats.items()}
    st, _, idle, ticks = machine.run_engine(cfg, *args, st, bud(1000),
                                            chunk=4)
    assert bool(idle.all()) and ticks.shape == (1,)
    assert ticks.dtype == torch.int32
    after = convert.state_to_numpy(st)
    assert not np.array_equal(after["mem_val"], kept["mem_val"]), \
        "the second call must change mem_val for this test to mean much"
    for k, v in kept.items():
        np.testing.assert_array_equal(leaves[k], v, err_msg=k)
    for k, v in kept_stats.items():
        np.testing.assert_array_equal(stats[k], v, err_msg=k)
