"""The port's event-compressed engine against its plain tick loop and the
JAX reference: the closed-form path, single-tick replay, telemetry and
budget slicing, all exact (int32, bit for bit)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.workloads import pointer_chase_graph  # noqa: E402
from repro.core import compiler as ref_compiler  # noqa: E402
from repro.core import machine as ref  # noqa: E402
from repro.core.fastforward import path_position as ref_path  # noqa: E402
from repro.core.sweep import SweepRequest as RefRequest  # noqa: E402
from repro.core.sweep import sweep as ref_sweep  # noqa: E402

from repro_torch.core import compiler, machine  # noqa: E402
from repro_torch.core.fastforward import path_position  # noqa: E402
from repro_torch.core.sweep import SweepRequest, sweep  # noqa: E402


def _cfgs(w, h, **kw):
    """The same machine config for the reference and the port."""
    kw.setdefault("mem_words", 1024)
    kw.setdefault("max_cycles", 100_000)
    return (ref.MachineConfig(width=w, height=h, **kw),
            machine.MachineConfig(width=w, height=h, **kw))


def _chain(cfgs, n_nodes, seed=3):
    rowptr, col, src = pointer_chase_graph(n_nodes, seed=seed)
    return (ref_compiler.build_bfs(rowptr, col, src, cfgs[0]),
            compiler.build_bfs(rowptr, col, src, cfgs[1]))


def _sig(r):
    return (r.to_json(), np.asarray(r.stall_per_port).tolist(),
            np.asarray(r.mem_val).tolist())


def _plain(cfg):
    return dataclasses.replace(cfg, fast_forward=False)


# ----------------------------------------------------------------------
# the closed-form path
# ----------------------------------------------------------------------
def _all_paths(w, h):
    """Every (holder, destination, t) of a w x h mesh with 0 <= t <= dist,
    as flat int32 arrays."""
    src, dst = np.meshgrid(np.arange(w * h), np.arange(w * h),
                           indexing="ij")
    hx, hy = src.ravel() % w, src.ravel() // w
    ex, ey = dst.ravel() % w, dst.ravel() // w
    dist = np.abs(ex - hx) + np.abs(ey - hy)
    rep = dist + 1
    t = np.concatenate([np.arange(r) for r in rep])
    cols = [np.repeat(a, rep).astype(np.int32) for a in (hx, hy, ex, ey)]
    return (*cols, t.astype(np.int32))


@pytest.mark.parametrize("w", range(1, 9))
def test_path_position_numpy_torch_and_reference_agree(w):
    """Every (hx, hy, ex, ey, t) on every mesh up to 8x8: the port under
    numpy and under torch gives the reference's positions."""
    for h in range(1, 9):
        args = _all_paths(w, h)
        want = ref_path(np, *args)
        got_np = path_position(np, *args)
        got_t = path_position(torch, *(torch.as_tensor(a) for a in args))
        for k in range(2):
            np.testing.assert_array_equal(got_np[k], want[k])
            assert got_t[k].dtype == torch.int32
            np.testing.assert_array_equal(got_t[k].numpy(), want[k])
        # the walk ends at the destination
        end = args[4] == np.abs(args[2] - args[0]) + np.abs(args[3] - args[1])
        np.testing.assert_array_equal(want[0][end], args[2][end])
        np.testing.assert_array_equal(want[1][end], args[3][end])


# ----------------------------------------------------------------------
# fast-forward == plain == reference
# ----------------------------------------------------------------------
def test_chunk1_single_tick_replay_matches():
    """chunk=1 re-decides the two-speed dispatch every tick, so every
    compressed advance of the 3x3 chains of seeds 3 and 7 is replayed
    against the plain single tick and the reference."""
    cfgs = _cfgs(3, 3, max_cycles=20_000)
    pairs = [_chain(cfgs, 9, seed=s) for s in (3, 7)]
    want = ref.run_many(cfgs[0], [p[0] for p in pairs], chunk=1)
    lanes = [p[1] for p in pairs]
    ff = machine.run_many(cfgs[1], lanes, chunk=1, device="cpu")
    plain = machine.run_many(_plain(cfgs[1]), lanes, chunk=1, device="cpu")
    for i, (w, f, p) in enumerate(zip(want, ff, plain)):
        assert _sig(f) == _sig(w), i
        assert _sig(p) == _sig(w), i
        assert f.completed


def test_chain_compresses_with_the_reference_telemetry():
    """The 64-node chain at 8x8, chunk 64: fast-forward, plain and the
    reference give the same lanes, and the fast-forward telemetry is the
    reference's (about half the plain PE-steps are skipped)."""
    cfgs = _cfgs(8, 8, mem_words=2048)
    wl_ref, wl = _chain(cfgs, 64)
    want = ref_sweep(cfgs[0], RefRequest(workloads=[wl_ref], chunk=64))
    ff = sweep(cfgs[1], SweepRequest(workloads=[wl], chunk=64),
               device="cpu")
    plain = sweep(_plain(cfgs[1]), SweepRequest(workloads=[wl], chunk=64),
                  device="cpu")
    assert _sig(ff[0]) == _sig(want[0])
    assert _sig(plain[0]) == _sig(want[0])
    assert ff.telemetry.to_json() == want.telemetry.to_json()
    assert ff.telemetry.dead_step_fraction > 0.2
    tel = plain.telemetry
    assert tel.stepped_pe_ticks == tel.plain_pe_ticks == \
        want.telemetry.plain_pe_ticks
    assert tel.dead_step_fraction == 0.0


# ----------------------------------------------------------------------
# budget slicing: cycles, not loop iterations
# ----------------------------------------------------------------------
def _engine_args(cfg, wl, n):
    """Fresh engine inputs for one lane on the CPU (the engine updates the
    queues of the state it is given in place)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32))

    st = machine.init_state(cfg, np.asarray(wl.static_ams)[None],
                            np.asarray(wl.amq_len)[None],
                            np.asarray(wl.mem_val)[None],
                            np.asarray(wl.mem_meta)[None], device="cpu")
    args = (t(np.asarray(wl.prog)[None]),
            t([machine.resolve_mode("nexus")]),
            t([[cfg.width, cfg.height]]), t(np.zeros((1, n))),
            t(np.arange(n)[None]))
    return args, st


def _leaves(st):
    return {k: getattr(st, k).numpy().copy()
            for k in machine.MachineState._fields}


def _assert_states_equal(a, b):
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("fast_forward", [True, False],
                         ids=["ff", "plain"])
def test_budget_b_then_bprime_equals_one_call(fast_forward):
    """engine(st, b) then engine(., b') == engine(st, b + b'), on both
    engines, and slicing to idle equals the unbounded run, whose state is
    (on the compressed engine) the reference engine's leaf for leaf."""
    cfgs = _cfgs(8, 8, mem_words=2048, fast_forward=fast_forward)
    cfg = cfgs[1]
    wl_ref, wl = _chain(cfgs, 64)
    n = cfg.width * cfg.height

    def bud(v):
        return torch.full((1, n), v, dtype=torch.int32)

    b1, b2 = 37, 200
    args, st = _engine_args(cfg, wl, n)
    st_a, _, _, _ = machine.run_engine(cfg, *args, st, bud(b1), chunk=16)
    assert int(st_a.cycle.max()) <= b1
    st_a, over_a, idle_a, _ = machine.run_engine(cfg, *args, st_a, bud(b2),
                                                 chunk=16)
    args, st = _engine_args(cfg, wl, n)
    st_b, over_b, idle_b, _ = machine.run_engine(cfg, *args, st,
                                                 bud(b1 + b2), chunk=16)
    _assert_states_equal(_leaves(st_a), _leaves(st_b))
    assert torch.equal(over_a, over_b) and torch.equal(idle_a, idle_b)

    args, st_c = _engine_args(cfg, wl, n)
    for _ in range(200):
        st_c, _, idle_c, _ = machine.run_engine(cfg, *args, st_c, bud(97),
                                                chunk=16)
        if bool(idle_c.all()):
            break
    assert bool(idle_c.all()), "sliced run never went idle"
    args, st_d = _engine_args(cfg, wl, n)
    st_d, _, _, ticks = machine.run_engine(
        cfg, *args, st_d, torch.as_tensor(machine.unbounded_budget(1, n)),
        chunk=16)
    _assert_states_equal(_leaves(st_c), _leaves(st_d))
    if not fast_forward:
        return

    import jax
    eng = ref._get_engine(cfgs[0], chunk=16, n_max=n)
    st0 = jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None],
        ref.init_state(cfgs[0], np.asarray(wl_ref.static_ams),
                       np.asarray(wl_ref.amq_len),
                       np.asarray(wl_ref.mem_val),
                       np.asarray(wl_ref.mem_meta)))
    st_r, _, _, ticks_r = eng(
        np.asarray(wl_ref.prog, np.int32)[None],
        np.array([ref.resolve_mode("nexus")], np.int32),
        np.array([[8, 8]], np.int32), np.zeros((1, n), np.int32),
        np.arange(n, dtype=np.int32)[None], st0, ref.unbounded_budget(1, n))
    _assert_states_equal(
        {k: np.asarray(getattr(st_r, k)) for k in ref.MachineState._fields},
        _leaves(st_d))
    assert ticks == int(np.asarray(ticks_r)[0])
