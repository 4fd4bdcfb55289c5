"""The port's copy of the pre-dispatch verifier and static cost model
(``repro_torch.analysis``) against the reference's ``repro.analysis``:
the same findings and estimates on every benchmark workload and on the
reference tests' seeded corruptions."""
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.analysis as ref_an  # noqa: E402
from benchmarks.workloads import make_all as ref_make_all  # noqa: E402
from repro.analysis import lint as ref_lint  # noqa: E402
from repro.core import batch as ref_batch  # noqa: E402
from repro.core import compiler as ref_compiler  # noqa: E402
from repro.core import machine as ref  # noqa: E402

import repro_torch.analysis as an  # noqa: E402
from repro_torch.analysis import lint  # noqa: E402
from repro_torch.bench.workloads import make_all  # noqa: E402
from repro_torch.core import am, batch, compiler, machine  # noqa: E402


def _norm(x):
    """A comparable plain-Python form of findings, reports and arrays."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, _norm(dataclasses.asdict(x)))
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


@pytest.fixture(scope="module")
def built():
    """Every make_all() workload at 4x4, compiled by both packages."""
    cfg_r = ref.MachineConfig(mem_words=2048)
    cfg_p = machine.MachineConfig(mem_words=2048)
    return [(w.name, w.build(cfg_p, "dissimilarity"),
             r.build(cfg_r, "dissimilarity"))
            for w, r in zip(make_all(), ref_make_all())]


def test_findings_and_estimates_match_on_make_all(built):
    """check_workload, estimate_cycles and cost_report agree on every
    benchmark workload; the real compiler output passes clean."""
    for name, wl, wr in built:
        got = an.check_workload(wl)
        assert _norm(got) == _norm(ref_an.check_workload(wr)), name
        assert [f for f in got if f.severity in ("error", "warn")] == [], \
            name
        assert an.estimate_cycles(wl) == ref_an.estimate_cycles(wr), name
        assert _norm(an.cost_report(wl)) == _norm(ref_an.cost_report(wr))
    assert an.static_hints([b[1] for b in built]) == \
        ref_an.static_hints([b[2] for b in built])
    for w in range(1, 9):
        for h in range(1, 9):
            assert an.fast_forward_bound(w, h) == \
                ref_an.fast_forward_bound(w, h)
    xs, ys = [3, 1, 4, 1, 5], [9, 2, 6, 5, 3]
    assert an.rank_correlation(xs, ys) == ref_an.rank_correlation(xs, ys)


def test_lint_table_matches_reference():
    """``python -m repro_torch.analysis.lint`` prints the reference's
    table (its own workloads) and passes."""
    sizes = [(2, 2), (4, 4)]
    got, want = io.StringIO(), io.StringIO()
    assert lint.run_lint(sizes=sizes, out=got) == 0
    assert ref_lint.run_lint(sizes=sizes, out=want) == 0
    assert got.getvalue() == want.getvalue()


def _spmv(pkg, cfg, rng):
    a = ref_compiler.random_sparse(16, 16, 0.3, rng)
    x = rng.integers(-3, 4, size=(16,))
    return pkg.build_spmv(a, x, cfg)


def _spmspm(pkg, cfg, rng):
    a = ref_compiler.random_sparse(16, 16, 0.4, rng)
    b = ref_compiler.random_sparse(16, 16, 0.4, rng)
    return pkg.build_spmspm(a, b, cfg)


def _bfs(pkg, cfg, rng):
    from repro_torch.bench.workloads import small_world_graph
    rp, col = small_world_graph(24, 4, 3)
    return pkg.build_bfs(rp, col, 0, cfg)


def _live(wl):
    return int(np.argmax(np.asarray(wl.amq_len)))


def _dst_out(wl):
    wl.static_ams[_live(wl), 0, am.F_DST0] = wl.geom[0] * wl.geom[1]


def _pc_off(wl):
    wl.static_ams[_live(wl), 0, am.F_PC] = wl.prog.shape[0]


def _branch(wl):
    wl.prog[0, am.C_NEXT_PC] = wl.prog.shape[0] + 3


def _opcode(wl):
    wl.static_ams[_live(wl), 0, am.F_OP] = am.N_OPCODES + 1


def _strip_meta(wl):
    wl.meta_pe = np.zeros_like(wl.meta_pe)


def _no_meta(wl):
    wl.meta_pe = None


def _meta_off(wl):
    pes, addrs = np.nonzero(wl.meta_pe)
    wl.mem_meta[pes[0], addrs[0], 1] = 10_000


MUTATIONS = {
    "dst-out-of-mesh": (_spmv, _dst_out, {}),
    "pc-off-by-one": (_spmv, _pc_off, {}),
    "bad-branch": (_spmv, _branch, {}),
    "opcode": (_spmv, _opcode, {}),
    "stripped-meta-pe": (_bfs, _strip_meta, {}),
    "missing-meta-pe": (_bfs, _no_meta, {}),
    "meta-pe-off-mesh": (_bfs, _meta_off, {}),
    "stream-fanin": (_spmspm, lambda wl: None, dict(stream_wait_cap=3)),
}


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_mutations_match_reference(name):
    """Each seeded corruption of the reference's mutation suite gives the
    same findings in both packages (and is an error in both)."""
    build, mutate, kw = MUTATIONS[name]
    cfg_r = ref.MachineConfig(mem_words=2048)
    cfg_p = machine.MachineConfig(mem_words=2048)
    wr = build(ref_compiler, cfg_r, np.random.default_rng(5))
    wl = build(compiler, cfg_p, np.random.default_rng(5))
    mutate(wr)
    mutate(wl)
    got = an.check_workload(wl, **kw)
    assert _norm(got) == _norm(ref_an.check_workload(wr, **kw))
    assert any(f.severity == "error" for f in got)


def test_reservation_discipline_reads_the_port_constants(monkeypatch):
    """check_capacity reads the port machine's constants at call time."""
    wl = _spmv(compiler, machine.MachineConfig(mem_words=2048),
               np.random.default_rng(5))
    assert "capacity.reservation-discipline" not in \
        {f.code for f in an.check_workload(wl)}
    monkeypatch.setattr(machine, "STREAM_THROTTLE", machine.PEND_CAP)
    assert "capacity.reservation-discipline" in \
        {f.code for f in an.check_workload(wl)}


def test_packed_rect_escape_and_request_validation_match():
    """check_packed_batch certifies an honest pack and flags the same
    rectangle escape; validate_request rejects the same lanes and modes
    with the same findings."""
    cfg_r = ref.MachineConfig(width=2, height=2, mem_words=4096)
    cfg_p = machine.MachineConfig(width=2, height=2, mem_words=4096)
    lr = [_spmv(ref_compiler, cfg_r, np.random.default_rng(s))
          for s in (1, 2)]
    lp = [_spmv(compiler, cfg_p, np.random.default_rng(s)) for s in (1, 2)]
    wr = ref_batch.pack_workloads(lr, super_geom=(4, 2))
    wp = batch.pack_workloads(lp, super_geom=(4, 2))
    assert an.check_packed_batch(wp) == []
    src = int(np.argmax(np.asarray(wp.amq_len[0])))
    other = int(np.nonzero(np.asarray(wp.sub_ids[0])
                           != wp.sub_ids[0, src])[0][0])
    for b in (wr, wp):
        b.static_ams[0, src, 0, am.F_DST0] = other
    got = an.check_packed_batch(wp)
    assert "cotenancy.rect-escape" in {f.code for f in got}
    assert _norm(got) == _norm(ref_an.check_packed_batch(wr))
    for b in (lr[1], lp[1]):
        b.static_ams[_live(b), 0, am.F_DST0] = 999
    for modes in (None, ["nexus", 9]):
        with pytest.raises(an.WorkloadValidationError) as ei:
            an.validate_request(lp, modes=modes)
        with pytest.raises(ref_an.WorkloadValidationError) as ei_r:
            ref_an.validate_request(lr, modes=modes)
        assert _norm(ei.value.findings) == _norm(ei_r.value.findings)
        assert str(ei.value) == str(ei_r.value)
