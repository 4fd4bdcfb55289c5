"""The port's packing planners and packed runs against the JAX
reference: the planners' copies give the reference's plans on seeded and
property sweeps, and packed, solo and reference runs give the same bits."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from benchmarks.workloads import small_world_graph  # noqa: E402
from repro.core import batch as ref_batch  # noqa: E402
from repro.core import compiler as ref_compiler  # noqa: E402
from repro.core import machine as ref  # noqa: E402
from repro.core.sweep import SweepRequest as RefRequest  # noqa: E402
from repro.core.sweep import sweep as ref_sweep  # noqa: E402

from repro_torch.core import batch, compiler, machine  # noqa: E402
from repro_torch.core.sweep import SweepRequest, sweep  # noqa: E402

SIZES = [(2, 2), (3, 3), (4, 4)]


def _random_case(rng):
    """The reference packing tests' random lane set, plus hints."""
    n = int(rng.integers(1, 14))
    geoms = [(int(rng.integers(1, 9)), int(rng.integers(1, 9)))
             for _ in range(n)]
    groups = [int(rng.integers(0, 3)) for _ in range(n)] \
        if rng.random() < 0.5 else None
    super_geom = (int(rng.integers(1, 10)), int(rng.integers(1, 10))) \
        if rng.random() < 0.5 else None
    hints = [float(h) for h in rng.integers(0, 5000, size=n)] \
        if rng.random() < 0.5 else None
    return geoms, groups, super_geom, hints


def _same_plans(geoms, groups, super_geom, hints, parallel=1):
    assert batch.plan_packing(geoms, super_geom=super_geom, groups=groups) \
        .__repr__() == ref_batch.plan_packing(
            geoms, super_geom=super_geom, groups=groups).__repr__()
    assert batch.plan_waves(geoms, super_geom=super_geom, groups=groups,
                            cycle_hints=hints, parallel=parallel) == \
        ref_batch.plan_waves(geoms, super_geom=super_geom, groups=groups,
                             cycle_hints=hints, parallel=parallel)
    for n_dev in (1, 2, 3):
        assert batch.plan_shards(geoms, n_dev, cycle_hints=hints) == \
            ref_batch.plan_shards(geoms, n_dev, cycle_hints=hints)
    assert batch.shard_loads(geoms, hints) == \
        ref_batch.shard_loads(geoms, hints)
    assert batch.unpacked_efficiency(geoms) == \
        ref_batch.unpacked_efficiency(geoms)


def test_planners_match_reference_seeded_sweep():
    """plan_packing, plan_waves, plan_shards, shard_loads and
    unpacked_efficiency over the reference tests' seeded lane sets."""
    rng = np.random.default_rng(7)
    for _ in range(200):
        geoms, groups, super_geom, hints = _random_case(rng)
        _same_plans(geoms, groups, super_geom, hints,
                    parallel=int(rng.integers(1, 4)))


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(st.integers(1, 8), st.integers(1, 8)),
                min_size=1, max_size=16),
       st.lists(st.integers(0, 2), min_size=16, max_size=16),
       st.booleans())
def test_planners_match_reference_property(geoms, group_pool, grouped):
    _same_plans(geoms, group_pool[:len(geoms)] if grouped else None, None,
                None)


@settings(max_examples=60, deadline=None)
@given(st.tuples(st.integers(1, 9), st.integers(1, 9)),
       st.lists(st.tuples(st.booleans(), st.integers(1, 5),
                          st.integers(1, 5), st.integers(0, 30)),
                max_size=40))
def test_rect_pool_matches_reference(geom, ops):
    """The same alloc / release sequence gives the same origins and free
    lists in both pools (releases pick a live rectangle by index)."""
    pool, want = batch.RectPool(geom), ref_batch.RectPool(geom)
    live = []
    for is_alloc, w, h, pick in ops:
        if is_alloc or not live:
            got = pool.alloc((w, h))
            assert got == want.alloc((w, h))
            if got is not None:
                live.append((got, (w, h)))
        else:
            origin, g = live.pop(pick % len(live))
            pool.release(origin, g)
            want.release(origin, g)
        assert pool.free == want.free
        assert pool.n_allocated == want.n_allocated


@pytest.fixture(scope="module")
def per_size():
    """One SpMV + one BFS per mesh size, compiled by both packages (the
    reference packing tests' lanes)."""
    rng = np.random.default_rng(21)
    a = ref_compiler.random_sparse(14, 14, 0.35, rng)
    x = rng.integers(-4, 5, size=(14,))
    rp, col = small_world_graph(20, 4, 3)
    out = {}
    for (w, h) in SIZES:
        rc = ref.MachineConfig(width=w, height=h, mem_words=1024,
                               max_cycles=100_000)
        pc = machine.MachineConfig(width=w, height=h, mem_words=1024,
                                   max_cycles=100_000)
        out[w, h] = dict(
            ref=[ref_compiler.build_spmv(a, x, rc),
                 ref_compiler.build_bfs(rp, col, 0, rc)],
            port=[compiler.build_spmv(a, x, pc),
                  compiler.build_bfs(rp, col, 0, pc)])
    return out


def _lanes(per_size, side):
    return [wl for size in SIZES for wl in per_size[size][side]]


def _sig(r):
    return (r.to_json(), np.asarray(r.stall_per_port).tolist(),
            np.asarray(r.mem_val).tolist())


def test_static_hints_and_schedule_match_reference(per_size):
    """static_cycle_hints (the analysis copy's estimates) and the whole
    pack_schedule — waves, stats and packed arrays — equal the
    reference's."""
    wls, wls_ref = _lanes(per_size, "port"), _lanes(per_size, "ref")
    assert batch.static_cycle_hints(wls) == \
        ref_batch.static_cycle_hints(wls_ref)
    for sg in (None, (6, 6)):
        got = batch.pack_schedule(wls, super_geom=sg)
        want = ref_batch.pack_schedule(wls_ref, super_geom=sg)
        assert got[1] == want[1] and got[2] == want[2]
        for wb, wr in zip(got[0], want[0]):
            for f in ("prog", "static_ams", "amq_len", "mem_val",
                      "mem_meta", "geoms", "sub_ids", "local_ids"):
                np.testing.assert_array_equal(getattr(wb, f),
                                              getattr(wr, f), err_msg=f)
            assert repr(wb.plan) == repr(wr.plan)


@pytest.mark.parametrize("super_geom", [None, (6, 6)],
                         ids=["default", "6x6"])
def test_packed_matches_solo_and_reference(per_size, super_geom):
    """Packed (2x2 + 3x3 + 4x4 co-tenants), solo and reference runs give
    the same lanes, and the report's schedule and telemetry are the
    reference's."""
    wls, wls_ref = _lanes(per_size, "port"), _lanes(per_size, "ref")
    got = sweep(machine.MachineConfig(mem_words=1024, max_cycles=100_000),
                SweepRequest(workloads=wls, pack=True, super_geom=super_geom,
                             chunk=64), device="cpu")
    want = ref_sweep(ref.MachineConfig(mem_words=1024, max_cycles=100_000),
                     RefRequest(workloads=wls_ref, pack=True,
                                super_geom=super_geom, chunk=64))
    assert got.to_json() == want.to_json()
    solo = machine.run_many(
        machine.MachineConfig(mem_words=1024, max_cycles=100_000), wls,
        chunk=64, device="cpu")
    for i, (g, w, s) in enumerate(zip(got, want, solo)):
        assert _sig(g) == _sig(w), i
        assert _sig(g) == _sig(s), i
        assert wls[i].check(g.mem_val), i
    if super_geom is not None:
        assert got.pack.n_super_lanes < len(wls), "packing must co-tenant"
