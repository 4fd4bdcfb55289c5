"""The yardstick against the program: the frozen generators give the
program's inputs, the frozen bytes floor its count, and the reference
its answers on the program's CPU path.  CPU only, small sizes.

    PYTHONPATH=src python3 -m pytest -q nexusbench
"""
import dataclasses

import numpy as np
import pytest
import torch

from nexusbench import harness, inputs, reference
from nexusbench.roofline import chunk_bytes
from repro_torch.bench import fig17, workloads
from repro_torch.core import machine
from repro_torch.core.machine import MachineConfig


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_generators_equal_the_programs(seed):
    for m, n, d in ((24, 24, 0.3), (17, 31, 0.5)):
        assert np.array_equal(
            inputs.powerlaw_sparse(m, n, np.random.default_rng(seed), d),
            workloads.powerlaw_sparse(m, n, np.random.default_rng(seed), d))
    assert np.array_equal(
        inputs.attention_mask(40, np.random.default_rng(seed), 0.3),
        workloads.attention_mask(40, np.random.default_rng(seed), 0.3))
    for got, want in zip(inputs.small_world_graph(60, 4, seed),
                         workloads.small_world_graph(60, 4, seed)):
        assert np.array_equal(got, want)


def _same_lane(a, b):
    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in
               ("prog", "static_ams", "amq_len", "mem_val", "mem_meta"))


@pytest.mark.parametrize("strategy", ["dissimilarity", "rows"])
def test_make_all_inputs_equal_the_programs(strategy):
    mine = inputs.draw_all(inputs.MAKE_ALL, 7, inputs.MAKE_ALL_GRAPH_SEEDS)
    for spec, inp, wl in zip(inputs.MAKE_ALL, mine, workloads.make_all(7)):
        assert spec["name"] == wl.name
        cfg = MachineConfig(mem_words=wl.mem_words)
        assert _same_lane(
            harness.compile_lane(spec["kind"], inp, cfg, strategy),
            wl.build(cfg, strategy)), spec["name"]


def test_fig17_inputs_equal_the_programs():
    mine = inputs.draw_all(inputs.FIG17, 5, inputs.FIG17_GRAPH_SEEDS)
    cfg = fig17._size_cfg(4, 4)
    for spec, inp in zip(inputs.FIG17, mine):
        want = fig17._builders()[spec["name"]](cfg)
        got = harness.compile_lane(spec["kind"], inp, cfg, "dissimilarity")
        assert _same_lane(got, want), spec["name"]


def _tiny_state():
    """A 2-lane batch of a small spmv at 2x2 and the arguments of one
    chunk of the program's plain engine."""
    from repro_torch.core.batch import stack_workloads
    cfg = MachineConfig(width=2, height=2, mem_words=1024, queue_cap=1024)
    inp = inputs.draw_all(inputs.MAKE_ALL[4:5], 3)[0]
    wl = harness.compile_lane("spmv", inp, cfg, "dissimilarity")
    bw = stack_workloads([wl, wl], modes=["nexus", "tia"])
    st = machine.init_state(cfg, bw.static_ams, bw.amq_len, bw.mem_val,
                            bw.mem_meta, device="cpu")
    b, n = st.cycle.shape

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32)
    args = dict(prog=t(bw.prog), modes=t(bw.modes), geoms=t(bw.geoms),
                sub_ids=t(np.zeros((b, n))),
                local_ids=t(np.tile(np.arange(n), (b, 1))),
                cycle0=st.cycle.clone(),
                budget=t(machine.unbounded_budget(b, n)))
    return cfg, args, st


def test_chunk_bytes_equals_the_programs():
    from repro_torch.kernels import cycle
    cfg, args, st = _tiny_state()
    before = cycle.clone_state(st)
    after = cycle.cycle_chunk_plain(cfg, *args.values(),
                                    cycle.clone_state(st), ticks=24,
                                    fast_forward=False)
    want = cycle.chunk_bytes(cfg, list(args.values()), before, after)
    got = chunk_bytes(list(args.values()), before._asdict(),
                      after._asdict())
    assert got == want > 0


#: one tiny lane of each kind of kernel
TINY = [
    dict(name="spmspm", kind="spmspm", n=6, density_a=0.5, density_b=0.5),
    dict(name="spmv", kind="spmv", m=8, density=0.4),
    dict(name="spmadd", kind="spmadd", n=6, density_a=0.3, density_b=0.3),
    dict(name="sddmm", kind="sddmm", s=6, dk=4, density=0.4),
    dict(name="matmul", kind="matmul", n=4),
    dict(name="mv", kind="mv", m=6),
    dict(name="conv", kind="conv", h=5, cin=2, cout=2, k=3),
    dict(name="bfs", kind="bfs", nodes=12, degree=4),
    dict(name="sssp", kind="sssp", nodes=12, degree=4),
    dict(name="pagerank", kind="pagerank", nodes=12, degree=4, rank=1024),
]


@pytest.mark.parametrize("spec", TINY, ids=[s["name"] for s in TINY])
@pytest.mark.parametrize("mode", ["nexus", "tia_valiant"])
def test_reference_agrees_with_the_programs_cpu_path(spec, mode):
    cfg = dataclasses.replace(MachineConfig(width=2, height=2, mem_words=256,
                                            queue_cap=256),
                              **machine.mode_flags(mode))
    inp = inputs.draw_all([spec], 11)[0]
    wl = harness.compile_lane(spec["kind"], inp, cfg, "dissimilarity")
    res = machine.run(cfg, wl.prog, wl.static_ams, wl.amq_len, wl.mem_val,
                      wl.mem_meta, device="cpu")
    assert res.completed
    assert reference.same(wl.read_result(res.mem_val),
                          reference.answer(spec["kind"], inp))
