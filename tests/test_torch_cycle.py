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
from repro_torch.core import am, compiler, machine  # noqa: E402
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
# the identities ``csrc/cycle.cu`` is written to, in Python
# ---------------------------------------------------------------------------
INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1


def _wrap(x):
    """``x`` as an int32 wraps it."""
    return (x - INT_MIN) % 2 ** 32 + INT_MIN


def _c_div(a, b):
    """C's int32 ``a / b`` (the quotient truncated toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _pick_one_rotated(cand, r, p):
    """The kernel's ``pick_one<P>``: for each mask of ``cand`` (int64
    array), the first set bit of the mask rotated right by r mod p, where
    i - r cannot wrap for any i < p (r >= INT_MIN + p); the priorities
    (i - r) mod p in int32, in turn, below that."""
    if r < INT_MIN + p:
        prio = np.array([_wrap(i - r) % p for i in range(p)])
        bits = (cand[:, None] >> np.arange(p)) & 1
        score = np.where(bits == 1, prio, p + 1)
        return np.where(cand == 0, -1, score.argmin(1))
    s = r - _c_div(r, p) * p             # C's r % p, then made >= 0
    s = s + p if s < 0 else s
    rot = ((cand >> s) | (cand << (p - s))) & ((1 << p) - 1)
    low = rot & -rot                      # the first set bit, as a power
    first = np.log2(np.maximum(low, 1)).astype(np.int64)
    i = first + s
    return np.where(cand == 0, -1, np.where(i >= p, i - p, i))


@pytest.mark.parametrize("p", [machine.PORTS, machine.PORTS * machine.DEPTH])
def test_pick_one_rotated_equals_the_ports_loop(p):
    """The mask-rotate arbitration equals the port's ``_pick_one`` (one
    candidate with the least (i - r) mod p in int32) for every mask of p
    bits, at r in [-20, 20] and near both int32 edges, where i - r
    wraps."""
    cand = np.arange(2 ** p, dtype=np.int64)
    bits = torch.as_tensor(((cand[:, None] >> np.arange(p)) & 1) == 1)
    edges = [INT_MIN + k for k in range(p + 3)] + \
        [INT_MAX - k for k in range(p + 3)]
    for r in list(range(-20, 21)) + edges:
        rr = torch.full((len(cand),), r, dtype=torch.int32)
        onehot = machine._pick_one(bits, rr)
        want = torch.where(onehot.any(-1), onehot.int().argmax(-1),
                           -1).numpy()
        np.testing.assert_array_equal(_pick_one_rotated(cand, r, p), want,
                                      err_msg=f"p={p}, r={r}")


def test_floor_division_by_a_positive_divisor_in_32_bits():
    """The kernel's ``fdivp`` / ``pmodp`` (C's truncating int32 quotient,
    one step down where the remainder is negative) equal Python's ``//``
    and ``%`` for every positive divisor over the int32 edges, and no
    quotient or product leaves int32; the Valiant hash's modulus |d| + 1
    (|d| < 2^31) is exact in uint32."""
    divisors = [1, 2, 3, 4, 5, 7, 8, 15, 16, 64, 512, 2048, 400_000,
                INT_MAX - 1, INT_MAX]
    values = sorted({v for b in divisors for v in (
        INT_MIN, INT_MIN + 1, INT_MIN + b, -b - 1, -b, -b + 1, -1, 0, 1,
        b - 1, b, b + 1, INT_MAX - b, INT_MAX - 1, INT_MAX)
        if INT_MIN <= v <= INT_MAX})
    for b in divisors:
        for a in values:
            q = _c_div(a, b)
            qb = q * b
            assert INT_MIN <= q <= INT_MAX and INT_MIN <= qb <= INT_MAX
            fdiv = q - 1 if a - qb < 0 else q
            r = a - qb
            pmod = r + b if r < 0 else r
            assert (fdiv, pmod) == (a // b, a % b), (a, b)
    for d in (0, 1, 7, 2 ** 31 - 1):
        m = (d + 1) & 0xFFFFFFFF
        for h in (0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1):
            assert m > 0 and h % m == h % (d + 1)


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


#: the kernel's edges, each a state made from the mixed batch: a pending
#: queue past the kernel's shared-memory window of 16 rows (``csrc/
#: cycle.cu``'s PEND_WINDOW), rings whose heads wrap their caps, registers
#: and counters near the int32 edges, heads bound off the mesh, words left
#: in FIFO slots past their counts (the kernel zeroes a slot only where a
#: word can remain)
EDGES = ("window", "wrap", "int32_edges", "far_heads", "stale_slots")
#: rows moved from a PE's static queue onto its pending ring ("window")
OVERFILL = 24
PEND_WINDOW = 16


def _edge_leaves(cfg, lanes, leaves, edge):
    """The mixed batch's warm state (numpy leaves) changed at ``edge``
    (:data:`EDGES`)."""
    lv = {k: v.copy() for k, v in leaves.items()}
    b, n = lv["cycle"].shape
    ids = np.arange(b * n).reshape(b, n)
    if edge == "window":
        # the next static AMs of every PE with some left wait on its
        # pending ring instead: past the window, draining one a tick
        for i, p in zip(*np.nonzero(lv["amq_len"] > lv["amq_head"])):
            h = lv["amq_head"][i, p]
            take = min(OVERFILL, lv["amq_len"][i, p] - h)
            for j in range(take):
                pos = (lv["pend_h"][i, p] + lv["pend_n"][i, p]) \
                    % machine.PEND_CAP
                lv["pend"][i, p, pos] = lv["amq"][i, p, h + j]
                lv["pend_n"][i, p] += 1
            lv["amq_head"][i, p] = h + take
    elif edge == "wrap":
        # the live rows of both rings moved so that their heads sit two
        # rows before the cap
        for ring, cap in (("pend", machine.PEND_CAP),
                          ("swq", cfg.stream_wait_cap)):
            head, count = lv[f"{ring}_h"], lv[f"{ring}_n"]
            for i in range(b):
                for p in range(n):
                    old = (head[i, p] + np.arange(count[i, p])) % cap
                    new = (cap - 2 + np.arange(count[i, p])) % cap
                    lv[ring][i, p, new] = lv[ring][i, p, old].copy()
            head[:] = cap - 2
    elif edge == "int32_edges":
        rr = np.array([INT_MAX, INT_MAX - 1, INT_MIN, INT_MIN + 1,
                       INT_MIN + 4, INT_MIN + 5, INT_MIN + 14, INT_MIN + 15,
                       -1, -6, 7])
        lv["rr"] = rr[ids % len(rr)].astype(np.int32)
        for k in ("st_busy", "st_exec", "st_enroute", "st_hops", "st_inj"):
            lv[k] = (INT_MAX - ids % 3).astype(np.int32)
        lv["st_stall"] = np.full_like(lv["st_stall"], INT_MAX)
        # a third of the lanes frozen near INT32_MAX (past max_cycles, at
        # work), a third near INT32_MIN (the cycles left wrap)
        lane = np.arange(b)[:, None]
        lv["cycle"] = np.where(lane % 3 == 1, INT_MAX - 2 - ids % 2,
                               np.where(lane % 3 == 2, INT_MIN + 3 + ids % 2,
                                        lv["cycle"])).astype(np.int32)
    elif edge == "stale_slots":
        gen = np.random.default_rng(3)
        past = np.arange(machine.DEPTH) >= lv["buf_n"][..., None]
        stale = past & (gen.random(past.shape) < 0.3)
        noise = gen.integers(-50, 50, size=lv["buf"].shape, dtype=np.int32)
        lv["buf"] = np.where(stale[..., None], noise, lv["buf"])
    else:
        # half the live heads and the next static AMs bound to -1, past
        # the mesh, past the PE axis or to INT32_MAX, some by way of a
        # waypoint off the mesh; the lone flight's flit among them
        for i in range(b):
            w, h = (int(v) for v in lanes["geoms"][i])
            far = [-1, w * h + 1, n + 3, INT_MAX]
            for p in range(n):
                for q in range(machine.PORTS):
                    key = i + p + q
                    if lv["buf_n"][i, p, q] > 0 and (key % 2 == 0
                                                     or i == CHAIN_LANE):
                        lv["buf"][i, p, q, 0, am.F_DST0] = far[key // 2 % 4]
                        if key % 3 == 0:
                            lv["buf"][i, p, q, 0, am.F_VIA] = w * h + 2
                j = lv["amq_head"][i, p]
                if j < lv["amq_len"][i, p]:
                    lv["amq"][i, p, j, am.F_DST0] = far[(i + p) % 4]
    return lv


def _edge_state(mixed, edge, device):
    """``(cfg, args, st)`` of :func:`_edge_leaves` on ``device``: ``args``
    the chunk's lane arguments up to ``cycle0`` (the state's cycles)."""
    cfg, lanes, leaves = mixed
    st = convert.state_from_numpy(_edge_leaves(cfg, lanes, leaves, edge),
                                  device=device)
    args = [_t(lanes[k], device) for k in ("prog", "modes", "geoms",
                                           "sub_ids", "local_ids")]
    return cfg, args + [st.cycle.clone()], st


def test_edge_states_reach_their_edges(mixed):
    """The card tests' edge states are what they claim, and the plain
    version steps them: pending queues past the window that drain,
    heads two rows before the caps, registers at the int32 edges, heads
    bound off the mesh."""
    cfg, lanes, leaves = mixed
    states = {e: _edge_state(mixed, e, "cpu") for e in EDGES}
    _, _, st = states["window"]
    over = st.pend_n > PEND_WINDOW
    assert int(over.sum()) >= 8
    _, _, st = states["wrap"]
    assert int(st.pend_h.min()) == machine.PEND_CAP - 2
    assert int(st.swq_h.min()) == cfg.stream_wait_cap - 2
    _, _, st = states["int32_edges"]
    assert int(st.rr.min()) == INT_MIN and int(st.cycle.max()) == INT_MAX - 2
    _, _, st = states["far_heads"]
    dst = st.buf[..., 0, am.F_DST0][st.buf_n > 0]
    assert bool((dst == -1).any()) and bool((dst == INT_MAX).any())
    _, _, st = states["stale_slots"]
    past = torch.arange(machine.DEPTH) >= st.buf_n[..., None]
    assert bool((st.buf[past] != 0).any())
    cfg, args, st = states["window"]
    budget = _t(_budget(lanes, 7))
    after = kc.cycle_chunk_plain(cfg, *args, budget, kc.clone_state(st),
                                 ticks=7, fast_forward=True)
    drained = (st.pend_n - after.pend_n)[over]
    assert int(drained.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("fast_forward", [True, False], ids=["ff", "plain"])
@pytest.mark.parametrize("k", [1, 7, 512])
@pytest.mark.parametrize("edge", EDGES)
def test_cuda_kernel_edges_equal_plain(cuda_device, mixed, edge, k,
                                       fast_forward):
    """The kernel's edges (:data:`EDGES`) on the card: a pending queue
    past the shared-memory window that drains back under it within the
    chunk, ring heads that wrap their caps, ``rr``, ``cycle`` and the
    ``st_*`` counters near the int32 edges, heads bound to -1 or past
    w*h; the kernel against ``cycle_chunk_plain``, every leaf bit for
    bit."""
    cfg, args, st = _edge_state(mixed, edge, cuda_device)
    args.append(_t(_budget(mixed[1], k), cuda_device))
    want = kc.cycle_chunk_plain(cfg, *args, kc.clone_state(st), ticks=k,
                                fast_forward=fast_forward)
    got = kc.cycle_chunk(cfg, *args, kc.clone_state(st), ticks=k,
                         fast_forward=fast_forward)
    torch.cuda.synchronize()
    _assert_same(want, got, f"edge {edge}, {k} ticks")
    if edge == "window" and k == 512:
        # most queues that started past the window end the chunk under it
        over = st.pend_n > PEND_WINDOW
        back = int((got.pend_n[over] < PEND_WINDOW).sum())
        assert back > int(over.sum()) // 2


def _floor_word(ticks):
    """``cycle_floor``'s word after ``ticks`` ticks: x ^ (x + tick) in
    int32."""
    x = 0
    for t in range(ticks):
        x = x ^ _wrap(x + t)
    return x


def test_barrier_floor_times_only_the_card():
    """The barrier floor is a card measurement: no plain version on the
    CPU."""
    with pytest.raises(ValueError, match="times the card"):
        kc.barrier_floor(2, 16, 8, 4, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 64, 144])
def test_cuda_barrier_floor_runs_every_tick(cuda_device, n):
    """``cycle_floor`` at the chunk kernel's launch shapes (shared FIFOs up
    to 128 PEs, device FIFOs past) runs every tick it is given: each PE's
    word is the floor loop's after that many ticks."""
    for ticks in (1, 7, 512):
        out = kc.barrier_floor(3, n, 8, ticks, cuda_device)
        torch.cuda.synchronize()
        assert out.shape == (3, kc.lane_threads(n))
        assert bool((out == _floor_word(ticks)).all())


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
