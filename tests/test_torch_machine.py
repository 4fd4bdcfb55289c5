"""The torch engine against the JAX reference engine, cycle by cycle.

The same numpy-made state goes through the reference's ``_make_cycle``
(jitted, vmapped over lanes) and the port's batched cycle; every
``MachineState`` leaf must agree in value and dtype after every cycle.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.workloads import make_all as ref_make_all  # noqa: E402
from repro.core import batch as ref_batch  # noqa: E402
from repro.core import machine as ref  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import machine as port  # noqa: E402

WORKLOADS = ("spmv", "sddmm", "bfs", "sssp")
MODES = ("nexus", "tia", "tia_valiant")
PLACEMENT = {"nexus": "dissimilarity", "tia": "rows", "tia_valiant": "rows"}


@pytest.fixture(scope="module")
def grid():
    """spmv/sddmm/bfs/sssp x the three modes at 4x4, stacked as one batch,
    with the reference's jitted batched cycle.  The queues are cut to
    what these workloads need (both engines get the same config), which
    keeps the per-cycle comparison of every leaf cheap."""
    cfg = ref.MachineConfig(mem_words=2048, max_cycles=400_000,
                            queue_cap=512, stream_wait_cap=64)
    wls = {w.name: w for w in ref_make_all()}
    lanes, modes = [], []
    for name in WORKLOADS:
        for mode in MODES:
            lanes.append(wls[name].build(cfg, PLACEMENT[mode]))
            modes.append(mode)
    wb = ref_batch.stack_workloads(lanes, modes=modes)
    st0 = jax.vmap(lambda *a: ref.init_state(cfg, *a))(
        jnp.asarray(wb.static_ams), jnp.asarray(wb.amq_len),
        jnp.asarray(wb.mem_val), jnp.asarray(wb.mem_meta))
    cyc = ref._make_cycle(cfg, wb.n_pes)
    step = jax.jit(jax.vmap(lambda p, m, g, s, h: cyc(p, m, g, s, None, h)))
    return dict(cfg=cfg, wb=wb, st0=st0, step=step)


def _leaves(st) -> dict:
    return {k: np.asarray(getattr(st, k)) for k in ref.MachineState._fields}


def _assert_same(want: dict, got: dict, where: str) -> None:
    for k, a in want.items():
        b = got[k]
        assert a.dtype == b.dtype, (where, k, a.dtype, b.dtype)
        assert a.shape == b.shape, (where, k)
        if not np.array_equal(a, b):
            idx = np.argwhere(a != b)[:3]
            raise AssertionError(f"{where}: leaf {k} differs at {idx}")


@pytest.mark.parametrize("warm,halted", [(0, False), (160, False),
                                         (160, True)])
def test_cycle_bit_identical_to_reference(grid, warm, halted):
    """(a) 64 cycles of the port's cycle equal the reference's, leaf by
    leaf, from the initial state and from a warmed-up one, and once more
    with a random budget-halt mask."""
    wb = grid["wb"]
    b, n = wb.batch, wb.n_pes
    prog, mode, geom = (jnp.asarray(wb.prog), jnp.asarray(wb.modes),
                        jnp.asarray(wb.geoms))
    st = grid["st0"]
    no_halt = jnp.zeros((b, n), bool)
    for _ in range(warm):
        st = grid["step"](prog, mode, geom, st, no_halt)
    tst = convert.state_from_numpy(_leaves(st), device="cpu")
    _assert_same(_leaves(st), convert.state_to_numpy(tst), "start")
    cfg = port.MachineConfig(**dataclasses.asdict(grid["cfg"]))
    tcyc = port._make_cycle(cfg, n)
    pb = convert.batch_from_numpy(
        {k: getattr(wb, k) for k in ("prog", "static_ams", "amq_len",
                                     "mem_val", "mem_meta", "modes",
                                     "geoms")})
    tprog, tmode, tgeom = (torch.as_tensor(x)
                           for x in (pb.prog, pb.modes, pb.geoms))
    rng = np.random.default_rng(11 + warm)
    for c in range(64):
        halt = (rng.random((b, n)) < 0.25) if halted \
            else np.zeros((b, n), bool)
        st = grid["step"](prog, mode, geom, st, jnp.asarray(halt))
        tst = tcyc(tprog, tmode, tgeom, tst,
                   halt=torch.as_tensor(halt) if halted else None)
        _assert_same(_leaves(st), convert.state_to_numpy(tst),
                     f"cycle {warm + c}")


def test_idle_accounting_matches_reference(grid):
    """lane_work / group_idle equal the reference's on a mid-run state,
    with arbitrary sub-lane groupings (the scatter-add is exact)."""
    wb = grid["wb"]
    prog, mode, geom = (jnp.asarray(wb.prog), jnp.asarray(wb.modes),
                        jnp.asarray(wb.geoms))
    st = grid["st0"]
    no_halt = jnp.zeros((wb.batch, wb.n_pes), bool)
    for _ in range(40):
        st = grid["step"](prog, mode, geom, st, no_halt)
    tst = convert.state_from_numpy(_leaves(st), device="cpu")
    want = np.asarray(jax.vmap(ref.lane_work)(st))
    got = port.lane_work(tst).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(3)
    for sub in (np.zeros((wb.batch, wb.n_pes), np.int32),
                rng.integers(0, 4, (wb.batch, wb.n_pes)).astype(np.int32)):
        want = np.asarray(jax.vmap(ref.group_idle)(st, jnp.asarray(sub)))
        got = port.group_idle(tst, torch.as_tensor(sub)).numpy()
        np.testing.assert_array_equal(got, want)


def test_alu_and_pick_one_match_reference():
    """The integer traps: floor division with a zero guard on negative
    operands, jnp.select order, first-index argmin tie-breaking."""
    rng = np.random.default_rng(0)
    op = rng.integers(0, 15, 4096).astype(np.int32)
    a = rng.integers(-40, 41, 4096).astype(np.int32)
    b = rng.integers(-5, 6, 4096).astype(np.int32)
    r = rng.integers(-40, 41, 4096).astype(np.int32)
    want = np.asarray(ref._alu(*(jnp.asarray(x) for x in (op, a, b, r))))
    got = port._alu(*(torch.as_tensor(x) for x in (op, a, b, r))).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    cand = rng.random((512, 15)) < 0.3
    rr = rng.integers(0, 9, 512).astype(np.int32)
    want = np.asarray(ref._pick_one(jnp.asarray(cand), jnp.asarray(rr)))
    got = port._pick_one(torch.as_tensor(cand), torch.as_tensor(rr)).numpy()
    np.testing.assert_array_equal(got, want)


def test_run_is_a_one_lane_run_many():
    """run() is a B=1 run_many: same metrics as the lane in a batch, and
    the bench_smoke golden cycle count (spmv on nexus at 2x2: 24)."""
    from repro_torch.core import compiler
    rng = np.random.default_rng(5)
    a = compiler.random_sparse(8, 8, 0.4, rng)
    x = rng.integers(-3, 4, size=(8,))
    cfg = port.MachineConfig(width=2, height=2, mem_words=1024)
    wl = compiler.build_spmv(a, x, cfg, strategy="dissimilarity")
    solo = port.run(cfg, wl.prog, wl.static_ams, wl.amq_len, wl.mem_val,
                    wl.mem_meta, device="cpu")
    both = port.run_many(cfg, [wl, wl], modes=["nexus", "tia"],
                         device="cpu", chunk=16)
    assert solo.cycles == both[0].cycles == 24 and solo.completed
    assert wl.check(solo.mem_val) and wl.check(both[1].mem_val)
    assert solo.to_json() == both[0].to_json()


@pytest.mark.parametrize("kw", [dict(shard=True, pack=True),
                                dict(shard=True),
                                dict(shard=True, deadlines=[None]),
                                dict(shard=True, cycle_hints=[1.0])])
def test_unported_options_raise(kw):
    """``shard=True`` is the one option not ported yet: it raises alone
    and beside the ported ``pack`` / ``deadlines`` / ``cycle_hints``
    (tests/test_torch_sweep.py holds those to the reference)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.run_many(port.MachineConfig(), [], device="cpu", **kw)


@pytest.mark.parametrize("flag", ["traced_modes", "traced_geometry"])
def test_static_golden_engines_not_ported(flag):
    cfg = port.MachineConfig(**{flag: False})
    with pytest.raises(NotImplementedError):
        port._make_cycle(cfg)


def test_config_keeps_reference_fields():
    """MachineConfig and MachineState keep the reference's fields, order
    and defaults."""
    assert [f.name for f in dataclasses.fields(port.MachineConfig)] == \
        [f.name for f in dataclasses.fields(ref.MachineConfig)]
    assert dataclasses.asdict(port.MachineConfig()) == \
        dataclasses.asdict(ref.MachineConfig())
    assert port.MachineState._fields == ref.MachineState._fields
    assert port.FABRIC_MODES == ref.FABRIC_MODES
    assert (port.PEND_CAP, port.STREAM_THROTTLE, port.DEPTH) == \
        (ref.PEND_CAP, ref.STREAM_THROTTLE, ref.DEPTH)


def test_entry_points_do_not_fall_back_to_cpu():
    """(g) with no card here, the default device is refused by torch
    itself: nothing quietly moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wl = ref_make_all()[4].build(ref.MachineConfig(mem_words=2048), "rows")
    with pytest.raises((RuntimeError, AssertionError)):
        port.run(port.MachineConfig(mem_words=2048), wl.prog, wl.static_ams,
                 wl.amq_len, wl.mem_val, wl.mem_meta)
