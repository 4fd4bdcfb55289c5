"""The engine chunk: its plain version against the JAX reference's engine
on the CPU, its dispatch, and (on the card) the hand-written kernel
``csrc/cycle.cu`` against the plain version, every leaf bit for bit.

The card tests import no JAX, so on a machine with a card and without
JAX::

    PYTHONPATH=src python -m pytest tests/test_torch_cycle.py -m cuda -q
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.bench.harness import _placement_for  # noqa: E402
from repro_torch.bench.workloads import (make_all,  # noqa: E402
                                         pointer_chase_graph)
from repro_torch.core import compiler, machine  # noqa: E402
from repro_torch.core.batch import pack_workloads, stack_workloads  # noqa: E402
from repro_torch.core.fastforward import make_lone_probe  # noqa: E402
from repro_torch.kernels import cycle as kc  # noqa: E402

#: the mixed batch's lanes beyond grid A (13 workloads x 3 modes at 4x4):
#: two lanes padded to 4x4, the pointer chase at 4x4 (a lone flight at
#: the chunk's start), a packed super-lane of four 2x2 sub-lanes
CHAIN_LANE, PACKED_LANE, CAPPED_LANE = 41, 42, 0
#: ticks the mixed batch is stepped before the compared chunk
WARM = 20
#: the packed sub-lane that a deadline halts mid-chunk, and its budget
DEADLINE_SUB, DEADLINE = 1, 3


def _t(a, device="cpu"):
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def _assert_same(want, got, where=""):
    diff = kc.first_difference(want, got)
    assert diff is None, f"{where}: {diff}"


@pytest.fixture(scope="module")
def mixed():
    """One (43-lane, 16-PE) batch covering grid A in all three modes
    (Valiant lanes included), PEs padded past w*h (a 2x2 and a 3x3 lane),
    a lane in lone flight (the pointer chase), a packed super-lane whose
    sub-lane ``DEADLINE_SUB`` a deadline halts mid-chunk, and a lane whose
    cycle counters sit 3 below ``max_cycles`` with work left; stepped
    ``WARM`` ticks by the plain version.  Returns the config, the lane
    arrays (numpy) and the warm state's leaves (numpy)."""
    wls = make_all()
    by = {w.name: w for w in wls}
    mw = max(w.mem_words for w in wls)
    rows, modes = [], []
    for m in machine.FABRIC_MODES:
        for wl in wls:
            rows.append(wl.build(machine.MachineConfig(mem_words=wl.mem_words),
                                 _placement_for(m)))
            modes.append(m)
    for name, m, side in (("spmv", "nexus", 2), ("bfs", "tia_valiant", 3)):
        rows.append(by[name].build(machine.MachineConfig(
            width=side, height=side, mem_words=by[name].mem_words),
            _placement_for(m)))
        modes.append(m)
    rowptr, col, src = pointer_chase_graph(32)
    rows.append(compiler.build_bfs(rowptr, col, src,
                                   machine.MachineConfig(mem_words=mw)))
    modes.append("nexus")
    small = [by[n].build(machine.MachineConfig(
        width=2, height=2, mem_words=by[n].mem_words), "rows")
        for n in ("spmv", "bfs", "sddmm", "sssp")]
    packed = pack_workloads(small, super_geom=(4, 4))
    rows.append(tuple(getattr(packed, k)[0] for k in (
        "prog", "static_ams", "amq_len", "mem_val", "mem_meta")))
    modes.append("tia")
    geoms = [tuple(r.geom) for r in rows[:-1]] + [(4, 4)]
    wb = stack_workloads(rows, modes=modes, geoms=geoms)
    b, n = wb.batch, wb.n_pes
    sub_ids = np.zeros((b, n), np.int32)
    local_ids = np.tile(np.arange(n, dtype=np.int32), (b, 1))
    sub_ids[PACKED_LANE] = packed.sub_ids[0]
    local_ids[PACKED_LANE] = packed.local_ids[0]
    cfg = machine.MachineConfig(mem_words=mw, max_cycles=400_000,
                                stream_wait_cap=64)
    lanes = dict(prog=wb.prog, modes=wb.modes, geoms=wb.geoms,
                 sub_ids=sub_ids, local_ids=local_ids)
    st = machine.init_state(cfg, wb.static_ams, wb.amq_len, wb.mem_val,
                            wb.mem_meta, device="cpu")
    args = [_t(lanes[k]) for k in ("prog", "modes", "geoms", "sub_ids",
                                   "local_ids")]
    st = kc.cycle_chunk_plain(cfg, *args, st.cycle.clone(),
                              _t(machine.unbounded_budget(b, n)), st,
                              ticks=WARM, fast_forward=False)
    leaves = convert.state_to_numpy(st)
    leaves["cycle"][CAPPED_LANE] = cfg.max_cycles - 3
    assert machine.lane_work(st)[CAPPED_LANE].sum() > 0
    assert bool(make_lone_probe()(args[3], st)[CHAIN_LANE].all())
    return cfg, lanes, leaves


def _budget(lanes, k):
    """``k`` for every PE, a shorter deadline on one packed sub-lane."""
    budget = np.full(lanes["sub_ids"].shape, k, np.int32)
    rows = lanes["sub_ids"][PACKED_LANE] == DEADLINE_SUB
    budget[PACKED_LANE, rows] = min(DEADLINE, k - 1)
    return budget


@pytest.mark.parametrize("fast_forward", [True, False],
                         ids=["ff", "plain"])
@pytest.mark.parametrize("k", [1, 7])
def test_chunk_plain_equals_reference_engine_chunk(mixed, k, fast_forward):
    """One chunk of ``k`` ticks: the reference engine at chunk = budget = k
    (which runs exactly one chunk) against ``cycle_chunk_plain`` and the
    port's engine from the same numpy state, every leaf bit for bit; the
    speed is the one the reference's lone-flight probe picks."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import machine as ref
    cfg, lanes, leaves = mixed
    cfg = dataclasses.replace(cfg, fast_forward=fast_forward)
    budget = _budget(lanes, k)
    ref_cfg = ref.MachineConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    eng = ref._get_engine(ref_cfg, chunk=k, n_max=leaves["cycle"].shape[1])
    ref_st = ref.MachineState(**{k_: jnp.asarray(v)
                                 for k_, v in leaves.items()})
    out, over, _, ticks = eng(*(jnp.asarray(lanes[k_]) for k_ in (
        "prog", "modes", "geoms", "sub_ids", "local_ids")), ref_st,
        jnp.asarray(budget))
    assert (np.asarray(ticks) == k).all() and not np.asarray(over).any()
    want = convert.state_from_numpy(
        {f: np.asarray(getattr(out, f)) for f in ref.MachineState._fields},
        device="cpu")

    args = [_t(lanes[k_]) for k_ in ("prog", "modes", "geoms", "sub_ids",
                                     "local_ids")]
    st = convert.state_from_numpy(leaves, device="cpu")
    room = (st.cycle < cfg.max_cycles) & (_t(budget) > 0)
    lone = bool((make_lone_probe()(args[3], st) & room).any())
    assert lone, "the pointer chase is in lone flight at the start"
    got = kc.cycle_chunk_plain(cfg, *args, st.cycle.clone(), _t(budget),
                               st, ticks=k, fast_forward=fast_forward and lone)
    _assert_same(want, got, "cycle_chunk_plain")
    st = convert.state_from_numpy(leaves, device="cpu")
    got, _, _, _ = machine._get_engine(cfg, k, st.cycle.shape[1])(
        *args, st, _t(budget))
    _assert_same(want, got, "the port's engine")
    # what the chunk covered: the deadline froze its sub-lane at its
    # budget, the capped lane froze at max_cycles with work left
    rows = lanes["sub_ids"][PACKED_LANE] == DEADLINE_SUB
    spent = got.cycle - _t(leaves["cycle"])
    assert (spent[PACKED_LANE, rows] == min(DEADLINE, k - 1)).all()
    assert int(got.cycle[CAPPED_LANE].max()) <= cfg.max_cycles
    assert int(machine.lane_work(got)[CAPPED_LANE].sum()) > 0


def test_cycle_chunk_on_cpu_runs_the_plain_version(mixed, monkeypatch):
    """CPU tensors go to the plain version (with the same arguments); a
    tensor of another device type raises."""
    cfg, lanes, leaves = mixed
    calls = []
    inner = kc.cycle_chunk_plain
    monkeypatch.setattr(kc, "cycle_chunk_plain",
                        lambda *a, **kw: calls.append(kw) or inner(*a, **kw))
    args = [_t(lanes[k]) for k in ("prog", "modes", "geoms", "sub_ids",
                                   "local_ids")]
    st = convert.state_from_numpy(leaves, device="cpu")
    budget = _t(machine.unbounded_budget(*st.cycle.shape))
    got = kc.cycle_chunk(cfg, *args, st.cycle.clone(), budget, kc.clone_state(st),
                         ticks=2, fast_forward=True)
    assert calls == [dict(ticks=2, fast_forward=True)]
    _assert_same(inner(cfg, *args, st.cycle.clone(), budget, st, ticks=2,
                       fast_forward=True), got)
    meta = st._replace(cycle=torch.empty(st.cycle.shape, dtype=torch.int32,
                                         device="meta"))
    with pytest.raises(ValueError, match="no cycle_chunk for device meta"):
        kc.cycle_chunk(cfg, *args, budget, budget, meta, ticks=1,
                       fast_forward=False)


def test_engine_chunks_go_through_cycle_chunk_unless_static(monkeypatch):
    """The traced engine steps each chunk through ``cycle_chunk`` (once a
    chunk); the static golden engines, oracles of the traced one, call
    ``cycle_chunk_plain`` by their config and never ``cycle_chunk``."""
    seen = []
    kernel, plain = kc.cycle_chunk, kc.cycle_chunk_plain
    monkeypatch.setattr(kc, "cycle_chunk", lambda *a, **kw: seen.append(
        ("cycle_chunk", kw["ticks"])) or kernel(*a, **kw))
    monkeypatch.setattr(kc, "cycle_chunk_plain", lambda *a, **kw: seen.append(
        ("plain", kw["ticks"])) or plain(*a, **kw))
    rowptr, col, src = pointer_chase_graph(8)
    runs = {}
    for name, kw in (("traced", {}),
                     ("static", dict(traced_modes=False,
                                     traced_geometry=False))):
        cfg = machine.MachineConfig(width=2, height=2, mem_words=64, **kw)
        seen.clear()
        res = machine.run_many(cfg, [compiler.build_bfs(rowptr, col, src,
                                                        cfg)],
                               chunk=16, device="cpu")[0]
        runs[name] = (res.to_json(), list(seen))
    traced, static = runs["traced"][1], runs["static"][1]
    chunks = len([c for c in traced if c[0] == "cycle_chunk"])
    assert chunks > 0 and traced == [("cycle_chunk", 16),
                                     ("plain", 16)] * chunks
    assert static and set(static) == {("plain", 16)}
    assert runs["traced"][0] == runs["static"][0]


def test_engine_keeps_the_callers_leaves():
    """An engine call updates the caller's ``pend``, ``swq`` and
    ``mem_val`` in place and leaves every other leaf of its state as it
    was (the chunks update a copy)."""
    wl = {w.name: w for w in make_all()}["bfs"]
    cfg = machine.MachineConfig(width=2, height=2, mem_words=wl.mem_words)
    built = wl.build(cfg, "dissimilarity")
    wb = stack_workloads([built])
    st = machine.init_state(cfg, wb.static_ams, wb.amq_len, wb.mem_val,
                            wb.mem_meta, device="cpu")
    before = convert.state_to_numpy(st)
    n = wb.n_pes
    out, _, idle, _ = machine.run_engine(
        cfg, _t(wb.prog), _t([machine.mode_code(cfg)]), _t(wb.geoms),
        _t(np.zeros((1, n))), _t(np.arange(n)[None]), st,
        _t(machine.unbounded_budget(1, n)), chunk=8)
    assert bool(idle.all())
    for k in machine.MachineState._fields:
        if k in ("pend", "swq", "mem_val"):
            assert getattr(out, k) is getattr(st, k)
        elif k in kc.READ_ONLY:
            assert torch.equal(getattr(out, k), getattr(st, k))
        else:
            assert getattr(out, k) is not getattr(st, k), k
            np.testing.assert_array_equal(getattr(st, k).numpy(), before[k],
                                          err_msg=k)
    assert built.check(out.mem_val[0].numpy())


def test_chunk_bytes_counts_what_the_chunk_moved(mixed):
    """The bound's bytes: a chunk that moved nothing reads the lane
    arguments and the per-PE leaves once; a chunk of 7 ticks adds the
    rows its queues pushed and popped and the words it changed, and stays
    under the whole state read and written once."""
    cfg, lanes, leaves = mixed
    args = [_t(lanes[k]) for k in ("prog", "modes", "geoms", "sub_ids",
                                   "local_ids")]
    st = convert.state_from_numpy(leaves, device="cpu")
    args += [st.cycle.clone(), _t(machine.unbounded_budget(*st.cycle.shape))]

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    regs = nbytes(args) + nbytes(getattr(st, k) for k in st._fields
                                 if k not in kc.QUEUES_AND_MEMORY)
    assert kc.chunk_bytes(cfg, args, st, kc.clone_state(st)) == regs
    after = kc.cycle_chunk_plain(cfg, *args, kc.clone_state(st), ticks=7,
                                 fast_forward=False)
    rows = int((after.amq_head - st.amq_head).sum())
    assert rows > 0
    whole = nbytes(args) + 2 * nbytes(getattr(st, k) for k in st._fields)
    assert regs + rows * 60 < kc.chunk_bytes(cfg, args, st, after) < whole


# ---------------------------------------------------------------------------
# on the card: the kernel against the plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _sized_rows(side: int, lanes: int):
    """The first ``lanes`` lanes at side x side (the pointer chase in the
    three modes, then grid A's workloads in the three modes), stacked on
    the host: ``(cfg, batch)``."""
    wls = make_all()
    mw = max(w.mem_words for w in wls)
    cfg = machine.MachineConfig(width=side, height=side, mem_words=mw,
                                max_cycles=400_000)
    rowptr, col, src = pointer_chase_graph(2 * side * side)
    chase = compiler.build_bfs(rowptr, col, src, cfg)
    todo = [(None, m) for m in machine.FABRIC_MODES]
    todo += [(wl, m) for m in machine.FABRIC_MODES for wl in wls[:12]]
    rows = [chase if wl is None else wl.build(dataclasses.replace(
        cfg, mem_words=wl.mem_words), _placement_for(m))
        for wl, m in todo[:lanes]]
    return cfg, stack_workloads(rows, modes=[m for _, m in todo[:lanes]])


def _sized_batch(side: int, lanes: int, device):
    """:func:`_sized_rows` on ``device``: ``(cfg, args, st)`` with
    ``args`` the chunk's lane arguments (no sub-lanes, an unbounded
    budget)."""
    cfg, wb = _sized_rows(side, lanes)
    b, n = wb.batch, wb.n_pes
    st = machine.init_state(cfg, wb.static_ams, wb.amq_len, wb.mem_val,
                            wb.mem_meta, device=device)
    args = [_t(a, device) for a in (
        wb.prog, wb.modes, wb.geoms, np.zeros((b, n)),
        np.tile(np.arange(n), (b, 1)))]
    args += [st.cycle.clone(), _t(machine.unbounded_budget(b, n), device)]
    return cfg, args, st


@pytest.mark.cuda
@pytest.mark.parametrize("fast_forward", [True, False], ids=["ff", "plain"])
@pytest.mark.parametrize("lanes", [1, 39])
@pytest.mark.parametrize("side", [2, 4, 6, 8])
@pytest.mark.parametrize("chunk", [1, 7, 512])
def test_cuda_kernel_chunk_equals_plain(cuda_device, chunk, side, lanes,
                                        fast_forward):
    """The kernel against ``cycle_chunk_plain`` on the card, from the
    initial state and then from the state after it (chunks 1 and 7: two
    chunks; 512: one), N = 4, 16, 36, 64 and B = 1, 39, both speeds:
    every leaf bit for bit, one launch a chunk."""
    cfg, args, st = _sized_batch(side, lanes, cuda_device)
    want, got = kc.clone_state(st), kc.clone_state(st)
    for i in range(1 if chunk == 512 else 2):
        want = kc.cycle_chunk_plain(cfg, *args, want, ticks=chunk,
                                    fast_forward=fast_forward)
        before = kc.cycle_chunk.launches
        got = kc.cycle_chunk(cfg, *args, got, ticks=chunk,
                             fast_forward=fast_forward)
        assert kc.cycle_chunk.launches == before + 1
        torch.cuda.synchronize()
        _assert_same(want, got, f"chunk {i} of {chunk} ticks")
    assert int(got.cycle.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("fast_forward", [True, False], ids=["ff", "plain"])
@pytest.mark.parametrize("k", [1, 7, 512])
def test_cuda_kernel_mixed_lanes_equal_plain(cuda_device, mixed, k,
                                             fast_forward):
    """The mixed batch on the card: packed sub-lanes (their sums and a
    lone flight per sub-lane), a deadline that halts a sub-lane mid-chunk,
    a lane frozen at ``max_cycles`` with work left, PEs padded past w*h
    and Valiant lanes; the kernel against ``cycle_chunk_plain`` from the
    same state, every leaf bit for bit."""
    cfg, lanes, leaves = mixed
    args = [_t(lanes[k_], cuda_device) for k_ in (
        "prog", "modes", "geoms", "sub_ids", "local_ids")]
    st = convert.state_from_numpy(leaves, device=cuda_device)
    args += [st.cycle.clone(), _t(_budget(lanes, k), cuda_device)]
    want = kc.cycle_chunk_plain(cfg, *args, kc.clone_state(st), ticks=k,
                                fast_forward=fast_forward)
    got = kc.cycle_chunk(cfg, *args, kc.clone_state(st), ticks=k,
                         fast_forward=fast_forward)
    torch.cuda.synchronize()
    _assert_same(want, got, f"the mixed batch, {k} ticks")
    rows = lanes["sub_ids"][PACKED_LANE] == DEADLINE_SUB
    spent = (got.cycle - st.cycle)[PACKED_LANE].cpu().numpy()
    assert (spent[rows] == min(DEADLINE, k - 1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("side", [12, 32])
def test_cuda_kernel_past_shared_memory(cuda_device, side):
    """Lanes of 144 and 1,024 PEs keep their FIFOs in device memory (one
    thread a PE up to the kernel's limit): bit-equal to the plain version;
    a lane of more PEs than the kernel takes raises."""
    cfg, args, st = _sized_batch(side, 3, cuda_device)
    want = kc.cycle_chunk_plain(cfg, *args, kc.clone_state(st), ticks=24,
                                fast_forward=True)
    got = kc.cycle_chunk(cfg, *args, kc.clone_state(st), ticks=24, fast_forward=True)
    torch.cuda.synchronize()
    _assert_same(want, got)
    big = machine.init_state(cfg, np.zeros((1, kc.MAX_PES + 1, 4, 15)),
                             np.zeros((1, kc.MAX_PES + 1)),
                             np.zeros((1, kc.MAX_PES + 1, 8)),
                             np.zeros((1, kc.MAX_PES + 1, 8, 2)),
                             device=cuda_device)
    with pytest.raises(ValueError, match="PEs a lane"):
        kc.cycle_chunk(cfg, *(a[:1] for a in args[:3]),
                       *(big.cycle for _ in range(4)), big, ticks=1,
                       fast_forward=False)


@pytest.mark.cuda
@pytest.mark.parametrize("fast_forward", [True, False], ids=["ff", "plain"])
def test_cuda_engine_budget_b_then_bprime(cuda_device, fast_forward):
    """On the card, through the kernel: an engine call with budget b then
    one with b' equals one call with b + b', and two calls from one state
    are bit-equal."""
    cfg, args, st = _sized_batch(8, 6, cuda_device)
    cfg = dataclasses.replace(cfg, fast_forward=fast_forward)
    lane_args, n = args[:5], st.cycle.shape[1]

    def bud(v):
        return torch.full((st.cycle.shape[0], n), v, dtype=torch.int32,
                          device=cuda_device)

    def call(s, b):
        return machine.run_engine(cfg, *lane_args, s, bud(b), chunk=16)[0]

    before = kc.cycle_chunk.launches
    a = call(call(kc.clone_state(st), 37), 200)
    assert kc.cycle_chunk.launches > before
    b = call(kc.clone_state(st), 237)
    c = call(kc.clone_state(st), 237)
    _assert_same(b, a, "b then b'")
    _assert_same(b, c, "two calls")


@pytest.mark.cuda
def test_cuda_failed_launch_raises(cuda_device):
    """A launch the card refuses is reported: the C entry point returns
    the CUDA error of a PE axis past the kernel's limit, and the check
    raises."""
    from repro_torch.kernels import _build
    fn = _build.bind("cycle", "cycle_chunk", 32, 12)
    err = fn(*([0] * 32), 1, kc.MAX_PES + 1, 1, 1, machine.PEND_CAP, 8, 8,
             8, 1, 1, 0, machine.STREAM_THROTTLE,
             torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        _build.check_launch("cycle_chunk", err)
