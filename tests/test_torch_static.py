"""The port's static golden engines against the reference on the CPU.

``traced_modes=False`` bakes the config's mode flags into the cycle and
``traced_geometry=False`` its mesh; the reference holds its traced engine
to these (``tests/test_traced_modes.py``, ``test_traced_geometry.py``), and
so does the port: every mode's static engine equals the traced engine and
the reference's static engine bit for bit (results, cycles, per-PE stats,
``mem_val``), only the branch a static mode takes runs, static engines
key the engine cache on their whole config, and ``run_many`` refuses what
a static engine cannot run with the reference's messages.  The static
meshes and ``is_idle`` are in ``test_torch_static_geometry.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.workloads import small_world_graph  # noqa: E402
from repro.core import compiler as ref_compiler  # noqa: E402
from repro.core import machine as ref  # noqa: E402

from repro_torch.core import compiler  # noqa: E402
from repro_torch.core import machine as port  # noqa: E402
from repro_torch.core.batch import stack_workloads  # noqa: E402

KW = dict(mem_words=1024, max_cycles=100_000)
CHUNK = 32          # the lanes finish in under 160 cycles
NAMES = ("spmv", "bfs", "sddmm")
SIZES = [(2, 2), (4, 4)]


def _build(comp, cfg, seed=101):
    rng = np.random.default_rng(seed)
    a = comp.random_sparse(16, 16, 0.3, rng)
    x = rng.integers(-4, 5, size=(16,))
    ad = rng.integers(-3, 4, size=(10, 8))
    bd = rng.integers(-3, 4, size=(8, 10))
    mask = (rng.random((10, 10)) < 0.3).astype(np.int64)
    rp, col = small_world_graph(24, 4, 3)
    return {"spmv": comp.build_spmv(a, x, cfg),
            "bfs": comp.build_bfs(rp, col, 0, cfg),
            "sddmm": comp.build_sddmm(ad, bd, mask, cfg)}


@pytest.fixture(scope="module")
def lanes():
    """The same workloads built by both packages' compilers at 2x2 and
    4x4: ``{(w, h): (port lanes, reference lanes)}``."""
    out = {}
    for w, h in SIZES:
        out[w, h] = (
            _build(compiler, port.MachineConfig(width=w, height=h, **KW)),
            _build(ref_compiler, ref.MachineConfig(width=w, height=h, **KW)))
    return out


def _same(got, want):
    """Every metric of two lists of results, bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.to_json() == w.to_json()
        for k in ("per_pe_busy", "stall_per_port", "mem_val"):
            np.testing.assert_array_equal(getattr(g, k),
                                          np.asarray(getattr(w, k)), k)


# -------------------------------------------------------------- the modes --
@pytest.mark.parametrize("mode", list(port.FABRIC_MODES))
def test_static_mode_engine_equals_traced_and_reference(mode, lanes):
    """A mode baked into the cycle: the port's static engine equals its
    traced engine (the lanes' modes given per lane) and the reference's
    static engine, bit for bit; every lane's result is correct."""
    pw, rw = lanes[4, 4]
    flags = port.mode_flags(mode)
    static = port.MachineConfig(traced_modes=False, **KW, **flags)
    got = port.run_many(static, [pw[k] for k in NAMES], chunk=CHUNK,
                        device="cpu")
    traced = port.run_many(port.MachineConfig(**KW), [pw[k] for k in NAMES],
                           modes=[mode] * 3, chunk=CHUNK, device="cpu")
    want = ref.run_many(ref.MachineConfig(traced_modes=False, **KW, **flags),
                        [rw[k] for k in NAMES])
    _same(got, traced)
    _same(got, want)
    for k, r in zip(NAMES, got):
        assert r.completed and pw[k].check(r.mem_val), k


def test_static_engine_runs_only_the_branch_taken(lanes, monkeypatch):
    """The static short-circuit calls only the mode's own branch: TIA
    anchoring is never built on a static nexus engine, while the traced
    engine builds it for every lane and selects."""
    calls = []
    inner = port._anchor_tia
    monkeypatch.setattr(port, "_anchor_tia",
                        lambda *a: calls.append(1) or inner(*a))
    wl = lanes[2, 2][0]["spmv"]
    runs = {}
    for name, cfg in (
            ("static nexus", port.MachineConfig(
                width=2, height=2, traced_modes=False, **KW)),
            ("static tia", port.MachineConfig(
                width=2, height=2, traced_modes=False, **KW,
                **port.mode_flags("tia"))),
            ("traced nexus", port.MachineConfig(**KW))):
        calls.clear()
        runs[name] = (port.run_many(cfg, [wl], chunk=CHUNK, device="cpu")[0],
                      len(calls))
    assert runs["static nexus"][1] == 0
    assert runs["static tia"][1] > 0 and runs["traced nexus"][1] > 0
    assert runs["static nexus"][0].to_json() == \
        runs["traced nexus"][0].to_json()


def test_static_engines_keep_their_whole_config_in_the_cache_key():
    """Static engines key on the full config (one entry per mode or mesh);
    the traced axes fold out of a traced engine's key, as in the
    reference."""
    for kw in (dict(traced_modes=False, **port.mode_flags("tia")),
               dict(traced_geometry=False, width=2, height=2),
               dict(traced_modes=False, traced_geometry=False, width=8,
                    height=8, **port.mode_flags("tia_valiant")),
               dict(width=2, height=2, valiant=True)):
        cfg = port.MachineConfig(**kw)
        rcfg = ref.MachineConfig(**kw)
        assert dataclasses.asdict(port._engine_key_cfg(cfg)) == \
            dataclasses.asdict(ref._engine_key_cfg(rcfg))
    static = port.MachineConfig(traced_modes=False, traced_geometry=False)
    assert port._engine_key_cfg(static) == static


# ------------------------------------------------------------ the refusals --
def _refusals(lanes):
    """(case, port call, reference call, message) for each refusal."""
    pw, rw = lanes[2, 2]
    p4, r4 = lanes[4, 4]
    st_modes = dict(traced_modes=False, **KW)
    st_geom = dict(traced_geometry=False, width=4, height=4, **KW)
    return {
        "pack": (lambda m, cfg, wls: m.run_many(cfg(**st_modes), wls,
                                                pack=True),
                 [pw["spmv"], pw["bfs"]], [rw["spmv"], rw["bfs"]],
                 "pack=True requires the traced engine axes"),
        "geoms": (lambda m, cfg, wls: m.run_many(cfg(**st_geom), wls,
                                                 geoms=[(4, 4), (2, 2)]),
                  [pw["spmv"], pw["bfs"]], [rw["spmv"], rw["bfs"]],
                  "per-lane geometries differing from the config"),
        "padding": (lambda m, cfg, wls: m.run_many(cfg(**st_geom), wls),
                    [pw["spmv"], p4["bfs"]], [rw["spmv"], r4["bfs"]],
                    "per-lane geometries differing from the config"),
        "modes": (lambda m, cfg, wls: m.run_many(cfg(**st_modes), wls,
                                                 modes=["nexus", "tia"]),
                  [p4["spmv"], p4["bfs"]], [r4["spmv"], r4["bfs"]],
                  "per-lane modes differing from the config flags"),
    }


@pytest.mark.parametrize("case", ["pack", "geoms", "padding", "modes"])
def test_static_engines_refuse_what_they_cannot_run(case, lanes):
    """``pack=True``, per-lane meshes or padding other than the config's
    on a static mesh, and per-lane modes other than the config's on a
    static mode raise the reference's ``ValueError``, with its message."""
    call, pw, rw, msg = _refusals(lanes)[case]
    with pytest.raises(ValueError) as want:
        call(ref, ref.MachineConfig, rw)
    with pytest.raises(ValueError, match=msg) as got:
        call(port, lambda **kw: port.MachineConfig(**kw), pw)
    assert str(got.value) == str(want.value)


def test_padded_static_mesh_refuses_a_wider_batch(lanes):
    """A batch padded past a static mesh's PEs (every lane at the config's
    2x2): the reference's message; the cycle itself asserts it."""
    wb = stack_workloads([lanes[2, 2][0]["spmv"], lanes[4, 4][0]["spmv"]])
    wb = dataclasses.replace(wb, geoms=np.array([[2, 2], [2, 2]], np.int32))
    cfg = port.MachineConfig(width=2, height=2, traced_geometry=False, **KW)
    with pytest.raises(ValueError, match="batch padded to 16 PEs but the "
                                         "static-geometry cfg has 4"):
        port.run_many(cfg, wb, device="cpu")
    with pytest.raises(AssertionError, match="cannot pad the PE axis"):
        port._make_cycle(cfg, 16)
