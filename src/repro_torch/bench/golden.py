"""Golden results the card runs are held to.

**The paper grids** (``golden/paper_grid.json``).

The golden file holds the JAX reference's results for two grids:

* ``grid_a``: every ``make_all()`` workload x nexus / tia / tia_valiant
  on the default 4x4 mesh (the Figs. 11-14 grid, 39 lanes);
* ``grid_b``: spmv, sddmm and bfs under nexus at 2x2, 4x4 and 8x8 (the
  padded traced-geometry axis of Fig. 17).

Each lane records ``RunResult.to_json()``, the full per-PE stall matrix
and a sha256 of the lane's ``mem_val`` image.  A test regenerates the
file from the reference and fails on any difference; a run on the card
is held to it bit for bit with :func:`check_lanes`.

**The sweep legs** (``golden/sweeps.json``): the reference's
``sweep(cfg, SweepRequest(...))`` on three legs (:data:`SWEEPS`, built by
:func:`sweep_leg`): ``fig17``, the packed Fig. 17 grid (9 lanes in waves
of 8x8 super-lanes); ``chain``, eight lanes of a scrambled 512-node
pointer chase at 8x8 (the fast-forward engine's workload); ``deadline``,
spmv + bfs at 2x2, 3x3 and 4x4 packed into 6x6 super-lanes with a
deadline on the 3x3 bfs lane.  Each record holds every lane's record (as
above) and the report's ``pack`` and ``telemetry``; :func:`check_sweep`
holds a run to it.

**Reduced serving** (``golden/serve_reduced.json``): the JAX reference's
``serve_batch`` greedy tokens at the reduced Phi-3.5-MoE config (2 layers,
d 128, 4 experts top-2) with f32 parameters from :func:`serve_params_numpy`
on the requests of ``examples/serve_moe.py`` (:func:`serve_requests`), and
each token's top-2 logit margin from the port's f32 CPU run, whose tokens
equal the reference's.  A test regenerates the file; a card run is held to
it with :func:`check_serve_tokens`.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "golden")
GOLDEN_PATH = os.path.join(GOLDEN_DIR, "paper_grid.json")
SERVE_GOLDEN_PATH = os.path.join(GOLDEN_DIR, "serve_reduced.json")
SWEEP_GOLDEN_PATH = os.path.join(GOLDEN_DIR, "sweeps.json")
#: the reduced serving run: arch, traffic of examples/serve_moe.py, seed
SERVE_SPEC = dict(arch="phi3.5-moe-42b-a6.6b", max_new_tokens=8,
                  batch_slots=3, cache_len=128, param_seed=0)
#: tokens are compared up to the first one won by less than this margin
SERVE_MARGIN = 1e-3
MAX_CYCLES = 400_000

#: name -> (workload names or None for all, modes or None for all, sizes)
GRIDS = {
    "grid_a": dict(workloads=None, modes=None, sizes=None),
    "grid_b": dict(workloads=["spmv", "sddmm", "bfs"], modes=["nexus"],
                   sizes=[[2, 2], [4, 4], [8, 8]]),
}


#: the sweep legs: ``fig17`` is the packed grid of the Fig. 17 script;
#: ``chain`` the shape of the reference CI's fast-forward leg (8 lanes of
#: a 512-node pointer chase at 8x8, chunk 512); ``deadline`` the packed
#: per-size lanes of the reference's packing tests, the 3x3 bfs lane cut
#: at 21 cycles (half of its 43, so the deadline bites).  That lane is
#: sub-lane 0 of its 6x6 super-lane, whose uncovered PEs share its slot
#: and keep ticking after the cut until ``max_cycles`` (a reference fault,
#: ROADMAP.md section 3, kept bit for bit): the leg's cap of 2,048 bounds
#: that to four chunks; every lane finishes in under 100 cycles.
SWEEPS = {
    "fig17": dict(pack=True),
    "chain": dict(n_nodes=512, lanes=8, mesh=[8, 8], mem_words=8192,
                  max_cycles=400_000, chunk=512),
    "deadline": dict(sizes=[[2, 2], [3, 3], [4, 4]], density=0.35,
                     super_geom=[6, 6], mem_words=1024, max_cycles=2048,
                     deadlines={"bfs@3x3": 21}),
}


def sweep_leg(name: str, *, compiler, config, workloads, fig17):
    """Build one sweep leg from a package's modules: ``compiler``,
    ``config`` (its ``MachineConfig``), ``workloads`` (the benchmark
    generators) and ``fig17`` (the Fig. 17 grid script) — the port's, or
    the reference's in the test that writes the golden file.  Returns
    ``(cfg, request_kwargs, lane_keys)``."""
    spec = SWEEPS[name]
    if name == "fig17":
        lanes = fig17.build_grid(fig17._builders())
        return (fig17._size_cfg(*fig17.SIZES[0]),
                dict(workloads=[wl for _, _, wl in lanes],
                     pack=spec["pack"]),
                [f"{n}@{w}x{h}" for (w, h), n, _ in lanes])
    if name == "chain":
        w, h = spec["mesh"]
        cfg = config(width=w, height=h, mem_words=spec["mem_words"],
                     max_cycles=spec["max_cycles"])
        rowptr, col, src = workloads.pointer_chase_graph(spec["n_nodes"])
        wl = compiler.build_bfs(rowptr, col, src, cfg)
        return (cfg, dict(workloads=[wl] * spec["lanes"],
                          chunk=spec["chunk"]),
                [f"pointer_chase/{i}" for i in range(spec["lanes"])])
    rng = np.random.default_rng(21)
    a = compiler.random_sparse(14, 14, spec["density"], rng)
    x = rng.integers(-4, 5, size=(14,))
    rp, col = workloads.small_world_graph(20, 4, 3)
    wls, keys = [], []
    for (w, h) in spec["sizes"]:
        cfg = config(width=w, height=h, mem_words=spec["mem_words"],
                     max_cycles=spec["max_cycles"])
        wls += [compiler.build_spmv(a, x, cfg),
                compiler.build_bfs(rp, col, 0, cfg)]
        keys += [f"spmv@{w}x{h}", f"bfs@{w}x{h}"]
    cfg = config(mem_words=spec["mem_words"], max_cycles=spec["max_cycles"])
    return (cfg, dict(workloads=wls, pack=True,
                      super_geom=tuple(spec["super_geom"]),
                      deadlines=[spec["deadlines"].get(k) for k in keys]),
            keys)


def port_sweep_leg(name: str):
    """:func:`sweep_leg` built from the port's own modules."""
    from repro_torch.bench import fig17, workloads
    from repro_torch.core import compiler
    from repro_torch.core.machine import MachineConfig
    return sweep_leg(name, compiler=compiler, config=MachineConfig,
                     workloads=workloads, fig17=fig17)


def sweep_record(name: str, keys: list, report) -> dict:
    """The golden record of one sweep leg's report (reference's or
    port's), as it reads back from JSON."""
    return json.loads(json.dumps(dict(
        spec=SWEEPS[name],
        lanes={k: lane_record(r) for k, r in zip(keys, report.lanes)},
        pack=None if report.pack is None else report.pack.to_json(),
        telemetry=report.telemetry.to_json())))


def load_sweep_golden(path: str = SWEEP_GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def check_sweep(got: dict, want: dict, *, telemetry: bool = True) -> None:
    """Raise unless a sweep record equals the golden one: every lane, the
    packing schedule and (with ``telemetry``) the engine counters."""
    if got["spec"] != want["spec"]:
        raise AssertionError(f"spec {got['spec']} != {want['spec']}")
    check_lanes(got["lanes"], want["lanes"])
    if got["pack"] != want["pack"]:
        raise AssertionError(f"pack {got['pack']} != golden {want['pack']}")
    if telemetry and got["telemetry"] != want["telemetry"]:
        raise AssertionError(f"telemetry {got['telemetry']} != golden "
                             f"{want['telemetry']}")


def grid_workloads(spec: dict, all_wls: list) -> list:
    """The workloads of a grid spec, in ``make_all()`` order."""
    names = spec["workloads"]
    return list(all_wls) if names is None else \
        [w for w in all_wls if w.name in names]


def lane_record(res) -> dict:
    """The golden record of one lane's ``RunResult`` (reference's or
    port's: both have the same fields)."""
    rec = res.to_json()
    rec["stall_per_pe_port"] = np.asarray(res.stall_per_port).tolist()
    mem = np.ascontiguousarray(np.asarray(res.mem_val, np.int32))
    rec["mem_shape"] = list(mem.shape)
    rec["mem_sha256"] = hashlib.sha256(mem.tobytes()).hexdigest()
    return rec


def lane_key(workload: str, mode, size) -> str:
    at = "" if size is None else f"@{size[0]}x{size[1]}"
    return f"{workload}/{mode}{at}"


def load_golden(path: str = GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def check_lanes(got: dict, want: dict) -> None:
    """Raise unless the ``{lane_key: record}`` maps are equal."""
    if list(got) != list(want):
        raise AssertionError(f"lane sets differ: {list(got)} vs "
                             f"{list(want)}")
    bad = [k for k in want if got[k] != want[k]]
    if bad:
        k = bad[0]
        diff = {f: (got[k].get(f), want[k][f]) for f in want[k]
                if got[k].get(f) != want[k][f]}
        raise AssertionError(f"{len(bad)} lanes differ from the golden "
                             f"results, first {k}: {diff}")


def serve_requests() -> list:
    """The six requests of ``examples/serve_moe.py`` (4-11 prompt
    tokens in [1, 500), from ``default_rng(0)``)."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, 500, size=(rng.integers(4, 12),))
            for _ in range(6)]


def first_wave_tokens(slots: int, device) -> torch.Tensor:
    """(slots, plen) int32: the first ``slots`` of :func:`serve_requests`
    left-padded with 0 to the longest, as ``serve_batch``'s prefill."""
    reqs = serve_requests()[:slots]
    plen = max(len(r) for r in reqs)
    toks = torch.zeros((slots, plen), dtype=torch.int32, device=device)
    for i, r in enumerate(reqs):
        toks[i, plen - len(r):] = torch.as_tensor(r)
    return toks


def serve_params_numpy(cfg, seed: int = 0) -> dict:
    """f32 parameters of a dense / MoE transformer in the reference's
    pytree layout (a leading layer axis under ``"blocks"``), drawn from
    ``default_rng(seed)`` at the reference's scales; norms are ones."""
    rng = np.random.default_rng(seed)
    n, d, v = cfg.n_layers, cfg.d_model, cfg.vocab

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def ones(shape):
        return np.ones(shape, np.float32)

    hq, hk = cfg.n_heads * cfg.hd, cfg.n_kv * cfg.hd
    blocks = {"ln1": {"g": ones((n, d))}, "ln2": {"g": ones((n, d))},
              "attn": {"wq": normal((n, d, hq), d ** -0.5),
                       "wk": normal((n, d, hk), d ** -0.5),
                       "wv": normal((n, d, hk), d ** -0.5),
                       "wo": normal((n, hq, d), hq ** -0.5)}}
    if cfg.moe is not None:
        e, f = cfg.moe.n_experts, cfg.moe.d_expert
        blocks["moe"] = {"router": normal((n, d, e), d ** -0.5),
                         "wi": normal((n, e, d, f), e ** -0.5),
                         "wg": normal((n, e, d, f), e ** -0.5),
                         "wo": normal((n, e, f, d), f ** -0.5)}
        if cfg.moe.n_shared:
            fs = cfg.moe.n_shared * max(cfg.moe.d_shared, 1)
            blocks["moe"]["shared"] = {"wi": normal((n, d, fs), d ** -0.5),
                                       "wg": normal((n, d, fs), d ** -0.5),
                                       "wo": normal((n, fs, d), fs ** -0.5)}
    else:
        f = cfg.d_ff
        blocks["mlp"] = {"wi": normal((n, d, f), d ** -0.5),
                         "wg": normal((n, d, f), d ** -0.5),
                         "wo": normal((n, f, d), f ** -0.5)}
    tree = {"embed": {"e": normal((v, d), 1.0)},
            "final_norm": {"g": ones((d,))}, "blocks": blocks}
    if not cfg.tie_embeddings:
        tree["unembed"] = {"w": normal((d, v), d ** -0.5)}
    return tree


def load_serve_golden(path: str = SERVE_GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def check_serve_tokens(outputs: list, want: dict) -> int:
    """Hold served token lists to the golden record: each request's tokens
    must equal the golden ones up to (not including) its first token won
    by less than :data:`SERVE_MARGIN`.  Returns how many were compared."""
    if len(outputs) != len(want["tokens"]):
        raise AssertionError(f"{len(outputs)} requests served, golden has "
                             f"{len(want['tokens'])}")
    compared = 0
    for i, (got, toks, marg) in enumerate(zip(outputs, want["tokens"],
                                              want["margins"])):
        got = [int(t) for t in got]
        if len(got) != len(toks):
            raise AssertionError(f"request {i}: {len(got)} tokens, golden "
                                 f"has {len(toks)}")
        for j, (g, t, m) in enumerate(zip(got, toks, marg)):
            if m < SERVE_MARGIN:
                break
            if g != t:
                raise AssertionError(f"request {i} token {j}: {g} != golden "
                                     f"{t} (margin {m:.3g}); got {got}, "
                                     f"golden {toks}")
            compared += 1
    return compared
