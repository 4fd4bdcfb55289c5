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
of 8x8 super-lanes); ``chain``, eight lanes of a scrambled 256-node
pointer chase at 8x8 (the fast-forward engine's workload); ``deadline``,
spmv + bfs at 2x2, 3x3 and 4x4 packed into 6x6 super-lanes with a
deadline on the 3x3 bfs lane.  Each record holds every lane's record (as
above) and the report's ``pack`` and ``telemetry``; :func:`check_sweep`
holds a run to it.

**The sharded sweeps** (``golden/shard.json``): the reference's
``sweep(cfg, SweepRequest(..., shard=True))`` under four forced host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``) on the
legs of its own multi-device tests (``tests/test_lane_sharding.py``,
:data:`SHARD_LEGS`, built by :func:`shard_leg`): ``grid``, spmv + bfs x
nexus / tia / tia_valiant at 2x2, 3x3 and 4x4 (18 lanes); ``odd``, 5 spmv
lanes (3 inert pad lanes); ``cap``, 2 lanes (so 2 devices); ``pack``, the
18 lanes packed.  Each record holds every lane's record, the report's
``shard`` plan and ``telemetry`` (per shard: each device's loop stops on
its own, so they differ from the unsharded run's) and, packed, ``pack``;
:func:`check_shard` holds a run over four shards to it.

**The sweep service** (``golden/service.json``): the reference's one-shot
``run_many`` records of the ``fig17_traffic(copies=2)`` lanes
(:data:`SERVICE`; ``repro_torch.bench.serve_bench.fig17_traffic``, the
Fig. 17 sizes x the reference CI's small SpMV and BFS, two copies), and
its ``run_many(..., deadlines=[d])`` record of the chaos soak's deadline
lane (the longest lane, cut at half its cycles), built by
:func:`service_record`.  The card's chaos soak and clean soak are held to
it.

**Reduced serving** (``golden/serve_reduced.json``): the JAX reference's
``serve_batch`` greedy tokens at the reduced Phi-3.5-MoE config (2 layers,
d 128, 4 experts top-2) with f32 parameters from :func:`serve_params_numpy`
on the requests of ``examples/serve_moe.py`` (:func:`serve_requests`), and
each token's top-2 logit margin from the port's f32 CPU run, whose tokens
equal the reference's.  A test regenerates the file; a card run is held to
it with :func:`check_serve_tokens`.

**Reduced families** (``golden/families_reduced.json``): the reference's
``serve_batch`` greedy tokens of the reduced Zamba2, xLSTM,
DeepSeek-V2-Lite and LLaVA (as text) on the serving traffic above, with
each token's top-2 margin from the port's f32 CPU run; its
``encode_step`` logits of the reduced HuBERT over seeded frames; and its
``lm.forward`` logits of the reduced LLaVA over seeded patches and tokens
(:data:`FAMILIES_SPEC`, :func:`family_inputs`), all with f32 parameters
from :func:`serve_params_numpy`.  A card run is held to it with
:func:`check_serve_tokens` and :func:`check_logits`.

**Reduced training** (``golden/train_reduced.json``): the JAX reference's
``make_train_step`` on the reduced Phi-3.5-MoE (:data:`TRAIN_SPEC`) with
f32 parameters from :func:`serve_params_numpy` and the batches of
``SyntheticTokenStream``, on the CPU: each step's loss, aux loss and
gradient norm.  The card has no JAX, so it is held to this file with
:func:`check_train` (:data:`TRAIN_RTOL`).

**Reduced family training** (``golden/train_families_reduced.json``): the
reference's ``make_train_step`` on the reduced DeepSeek-V2-Lite, Zamba2,
xLSTM, HuBERT and LLaVA (:data:`TRAIN_FAMILIES_SPEC`) in f32 on the CPU,
each from :func:`serve_params_numpy`'s parameters on one numpy-seeded
batch (:func:`train_family_batch`) passed at every step: each step's loss,
aux loss and gradient norm.  :func:`train_family_run` makes the port's
run, and :func:`check_train` holds it to the record.
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
SERVICE_GOLDEN_PATH = os.path.join(GOLDEN_DIR, "service.json")
SHARD_GOLDEN_PATH = os.path.join(GOLDEN_DIR, "shard.json")
TRAIN_GOLDEN_PATH = os.path.join(GOLDEN_DIR, "train_reduced.json")
FAMILIES_GOLDEN_PATH = os.path.join(GOLDEN_DIR, "families_reduced.json")
TRAIN_FAMILIES_GOLDEN_PATH = os.path.join(GOLDEN_DIR,
                                          "train_families_reduced.json")
#: the reduced training run: arch, parameter seed, data stream and steps
#: (the batches are ``SyntheticTokenStream(vocab, batch, seq, seed=
#: data_seed)``'s, as ``train()``'s pipeline draws them)
TRAIN_SPEC = dict(arch="phi3.5-moe-42b-a6.6b", param_seed=0, data_seed=0,
                  steps=8, batch=4, seq=32, lr=3e-4)
#: losses, aux losses and gradient norms are held to the reference's
#: within this relative tolerance, the CPU tests' own: the sums run in
#: other orders (f32), and Adam's normalised step turns the last bits of a
#: tiny gradient into whole steps of ``lr``; the port's CPU run is within
#: 6e-7 of the reference over the 8 steps
TRAIN_RTOL = 1e-5
#: the reduced families' training record: ``steps`` AdamW steps of each
#: arch at ``lr`` with ``aux_weight``, on one batch of ``batch`` x ``seq``
#: (the VLM's text is ``max(seq - n_patches, 8)`` tokens after its
#: patches, as ``synth_batch`` cuts it) drawn from
#: ``default_rng(input_seed)``, repeated at every step so the loss falls
TRAIN_FAMILIES_SPEC = dict(
    archs=["deepseek-v2-lite-16b", "zamba2-1.2b", "xlstm-350m",
           "hubert-xlarge", "llava-next-mistral-7b"],
    param_seed=0, input_seed=0, steps=4, lr=3e-4, aux_weight=0.01,
    batch=2, seq=16)
#: the service legs' traffic: ``fig17_traffic(copies=2)``
SERVICE = dict(traffic="fig17", copies=2)
#: the reduced serving run: arch, traffic of examples/serve_moe.py, seed
SERVE_SPEC = dict(arch="phi3.5-moe-42b-a6.6b", max_new_tokens=8,
                  batch_slots=3, cache_len=128, param_seed=0)
#: tokens are compared up to the first one won by less than this margin
SERVE_MARGIN = 1e-3
#: the reduced families' records: the decoder families served with
#: SERVE_SPEC's traffic (``serve``), HuBERT's encode of seeded frames
#: (``encode``: batch, frames) and LLaVA's vision forward over seeded
#: patches and tokens (``vision``: the tokens after the config's patches)
FAMILIES_SPEC = dict(
    serve=["zamba2-1.2b", "xlstm-350m", "deepseek-v2-lite-16b",
           "llava-next-mistral-7b"],
    encode=dict(arch="hubert-xlarge", batch=2, frames=16),
    vision=dict(arch="llava-next-mistral-7b", tokens=8),
    param_seed=0, input_seed=0)
#: the encode and vision logits are held within this (rtol = atol), the
#: CPU tests' f32 tolerance
FAMILIES_TOL = 1e-4
MAX_CYCLES = 400_000

#: name -> (workload names or None for all, modes or None for all, sizes)
GRIDS = {
    "grid_a": dict(workloads=None, modes=None, sizes=None),
    "grid_b": dict(workloads=["spmv", "sddmm", "bfs"], modes=["nexus"],
                   sizes=[[2, 2], [4, 4], [8, 8]]),
}


#: the sweep legs: ``fig17`` is the packed grid of the Fig. 17 script;
#: ``chain`` the shape of the reference CI's fast-forward leg (8 lanes of
#: a pointer chase at 8x8, chunk 512), its depth cut from the CI's 512
#: nodes to 256 so that ``chip_smoke.py`` stays inside its time budget
#: (a serial walk: half the nodes, half the ticks); ``deadline`` the
#: packed per-size lanes of the reference's packing tests, the 3x3 bfs
#: lane cut at 21 cycles (half of its 43, so the deadline bites).  That
#: lane is sub-lane 0 of its 6x6 super-lane, whose uncovered PEs share its
#: slot and keep ticking after the cut until ``max_cycles`` (a reference
#: fault, ROADMAP.md section 3, kept bit for bit): the leg's cap of 1,024
#: (2,048 up to the same budget cut as the chain's) bounds that to two
#: chunks; every lane finishes in under 100 cycles.
SWEEPS = {
    "fig17": dict(pack=True),
    "chain": dict(n_nodes=256, lanes=8, mesh=[8, 8], mem_words=8192,
                  max_cycles=400_000, chunk=512),
    "deadline": dict(sizes=[[2, 2], [3, 3], [4, 4]], density=0.35,
                     super_geom=[6, 6], mem_words=1024, max_cycles=1024,
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


#: the sharded legs, recorded over ``SHARD_DEVICES`` devices: the workload
#: x mode x size grid of the reference's ``test_lane_sharding.py`` (its
#: ``per_size`` fixture's SpMV and BFS at each size, all three modes); 5
#: spmv lanes (one more than the devices, so the plan pads); 2 lanes
#: (the device count caps at the batch); and the grid packed.  The
#: reference tests run the default chunk of 512, under which every shard
#: of these legs (40-100 cycles a lane) stops after its first chunk; at
#: :data:`SHARD_CHUNK` a shard whose lanes all finish within 64 cycles
#: stops a chunk before the others, so the per-shard ticks differ and the
#: records show each shard stopping on its own (lane results do not
#: depend on the chunk)
SHARD_DEVICES = 4
SHARD_CHUNK = 64
SHARD_LEGS = {
    "grid": dict(sizes=[[2, 2], [3, 3], [4, 4]], names=["spmv", "bfs"],
                 modes=True, chunk=SHARD_CHUNK),
    "odd": dict(sizes=[[2, 2], [3, 3], [4, 4], [2, 2], [3, 3]],
                names=["spmv"], modes=False, chunk=SHARD_CHUNK),
    "cap": dict(sizes=[[2, 2], [4, 4]], names=["spmv"], modes=False,
                chunk=SHARD_CHUNK),
    "pack": dict(sizes=[[2, 2], [3, 3], [4, 4]], names=["spmv", "bfs"],
                 modes=True, pack=True, chunk=SHARD_CHUNK),
}


def shard_leg(name: str, *, compiler, config, fabric_modes, workloads):
    """Build one sharded leg from a package's modules: ``compiler``,
    ``config`` (its ``MachineConfig``), ``fabric_modes`` (its
    ``machine.FABRIC_MODES``) and ``workloads`` (the benchmark
    generators).  The inputs are the reference test's: ``default_rng(33)``
    draws a 14 x 14 SpMV at 0.35 and its vector, and the BFS runs on
    ``small_world_graph(20, 4, 3)``.  Returns ``(cfg, request_kwargs,
    lane_keys)``."""
    spec = SHARD_LEGS[name]
    rng = np.random.default_rng(33)
    a = compiler.random_sparse(14, 14, 0.35, rng)
    x = rng.integers(-4, 5, size=(14,))
    rp, col = workloads.small_world_graph(20, 4, 3)

    def cfg_for(w=4, h=4):
        return config(width=w, height=h, mem_words=1024, max_cycles=100_000)

    built = {}
    for w, h in {tuple(sz) for sz in spec["sizes"]}:
        c = cfg_for(w, h)
        built[w, h] = {"spmv": compiler.build_spmv(a, x, c),
                       "bfs": compiler.build_bfs(rp, col, 0, c)}
    modes = list(fabric_modes) if spec["modes"] else [None]
    wls, lane_modes, keys = [], [], []
    for i, (w, h) in enumerate(spec["sizes"]):
        for n in spec["names"]:
            for m in modes:
                wls.append(built[w, h][n])
                lane_modes.append(m)
                keys.append(f"{n}/{m}@{w}x{h}" if spec["modes"]
                            else f"{n}@{w}x{h}/{i}")
    kw = dict(workloads=wls, shard=True, pack=spec.get("pack", False),
              chunk=spec["chunk"])
    if spec["modes"]:
        kw["modes"] = lane_modes
    return cfg_for(), kw, keys


def port_shard_leg(name: str):
    """:func:`shard_leg` built from the port's own modules."""
    from repro_torch.bench import workloads
    from repro_torch.core import compiler, machine
    return shard_leg(name, compiler=compiler,
                     config=machine.MachineConfig,
                     fabric_modes=machine.FABRIC_MODES, workloads=workloads)


def shard_record(name: str, keys: list, report) -> dict:
    """The golden record of one sharded leg's report (reference's or
    port's), as it reads back from JSON."""
    return json.loads(json.dumps(dict(
        spec=SHARD_LEGS[name], n_devices=SHARD_DEVICES,
        lanes={k: lane_record(r) for k, r in zip(keys, report.lanes)},
        shard=report.shard.to_json(),
        pack=None if report.pack is None else report.pack.to_json(),
        telemetry=report.telemetry.to_json())))


def load_shard_golden(path: str = SHARD_GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def check_shard(got: dict, want: dict) -> None:
    """Raise unless a sharded leg's record equals the golden one: every
    lane, the shard plan, the packing schedule and the engine
    telemetry."""
    for field in ("spec", "n_devices"):
        if got[field] != want[field]:
            raise AssertionError(f"{field} {got[field]} != {want[field]}")
    check_lanes(got["lanes"], want["lanes"])
    for field in ("shard", "pack", "telemetry"):
        if got[field] != want[field]:
            raise AssertionError(f"{field} {got[field]} != golden "
                                 f"{want[field]}")


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


def service_lane_keys(sizes, copies: int = SERVICE["copies"]) -> list:
    """The lane keys of ``fig17_traffic(copies)`` in its lane order:
    every copy, every mesh size, ``bfs`` then ``spmv``."""
    return [f"{name}@{w}x{h}/{c}" for c in range(copies)
            for (w, h) in sizes for name in ("bfs", "spmv")]


def service_record(run_many, cfg, lanes, keys) -> dict:
    """The golden record of the service traffic from a package's
    ``run_many`` (the reference's, or the port's bound to a device):
    every lane's one-shot record, and the deadline lane (the longest,
    cut at half its cycles, as the chaos soak picks it) run alone with
    ``deadlines=[d]``."""
    results = run_many(cfg, lanes)
    dl_lane = max(range(len(results)), key=lambda i: results[i].cycles)
    d = max(1, results[dl_lane].cycles // 2)
    (frozen,) = run_many(cfg, [lanes[dl_lane]], deadlines=[d])
    return json.loads(json.dumps(dict(
        spec=SERVICE,
        lanes={k: lane_record(r) for k, r in zip(keys, results)},
        deadline=dict(lane=dl_lane, cycles=d, record=lane_record(frozen)))))


def load_service_golden(path: str = SERVICE_GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


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
    """f32 parameters of any family in the reference's pytree layout (a
    leading layer axis under each stacked group), drawn from
    ``default_rng(seed)`` at the reference's scales; norms are ones.  The
    Mamba-2 ``a_log`` and ``dt_bias`` are small normals where the
    reference's init has zeros, so that the decay differs from head to
    head.  The dense and MoE trees draw in the order of the records made
    before the other families were added."""
    rng = np.random.default_rng(seed)
    n, d, v = cfg.n_layers, cfg.d_model, cfg.vocab

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def ones(shape):
        return np.ones(shape, np.float32)

    def dense(shape):          # the reference's _init: 1/sqrt(fan-in)
        return normal(shape, shape[-2] ** -0.5)

    def gqa(lead):
        hq, hk = cfg.n_heads * cfg.hd, cfg.n_kv * cfg.hd
        return {"wq": dense(lead + (d, hq)), "wk": dense(lead + (d, hk)),
                "wv": dense(lead + (d, hk)), "wo": dense(lead + (hq, d))}

    if cfg.xlstm:
        nm, ns, di = (n + 1) // 2, n // 2, 2 * d
        tree = {
            "mlstm": {"ln": {"g": ones((nm, d))}, "mixer": {
                "wup": dense((nm, d, 2 * di)),
                "wqkv": dense((nm, di, 3 * di)),
                "wif": dense((nm, di, 2 * cfg.n_heads)),
                "norm": {"g": ones((nm, di))},
                "wdown": dense((nm, di, d))}},
            "slstm": {"ln": {"g": ones((ns, d))}, "mixer": {
                "wg": dense((ns, d, 4 * d)), "norm": {"g": ones((ns, d))},
                "wout": dense((ns, d, d))}}}
    elif cfg.ssm is not None:
        sc = cfg.ssm
        di, nh = sc.expand * d, sc.n_heads
        tree = {
            "mamba": {"ln": {"g": ones((n, d))}, "mixer": {
                "win": dense((n, d, 2 * di + 2 * nh * sc.d_state + nh)),
                "conv": normal((n, sc.d_conv, di), 0.5),
                "a_log": normal((n, nh), 0.5),
                "dt_bias": normal((n, nh), 0.5),
                "dnorm": {"g": ones((n, di))},
                "wout": dense((n, di, d))}},
            "shared_attn": {"ln": {"g": ones((d,))}, "attn": gqa(())}}
    else:
        blocks = {"ln1": {"g": ones((n, d))}, "ln2": {"g": ones((n, d))}}
        if cfg.mla is not None:
            m, h = cfg.mla, cfg.n_heads
            blocks["attn"] = {
                "wq": dense((n, d, h * (m.nope_dim + m.rope_dim))),
                "wdkv": dense((n, d, m.kv_lora + m.rope_dim)),
                "wukv": dense((n, m.kv_lora, h * (m.nope_dim + m.v_dim))),
                "wo": dense((n, h * m.v_dim, d))}
        else:
            blocks["attn"] = gqa((n,))
        if cfg.moe is not None:
            e, f = cfg.moe.n_experts, cfg.moe.d_expert
            # the reference's _init scales the (e, d, f) leaves by e^-0.5
            blocks["moe"] = {"router": dense((n, d, e)),
                             "wi": normal((n, e, d, f), e ** -0.5),
                             "wg": normal((n, e, d, f), e ** -0.5),
                             "wo": normal((n, e, f, d), f ** -0.5)}
            if cfg.moe.n_shared:
                fs = cfg.moe.n_shared * max(cfg.moe.d_shared, 1)
                blocks["moe"]["shared"] = {"wi": dense((n, d, fs)),
                                           "wg": dense((n, d, fs)),
                                           "wo": dense((n, fs, d))}
        elif cfg.encoder_only:
            blocks["mlp"] = {"wi": dense((n, d, cfg.d_ff)),
                             "wo": dense((n, cfg.d_ff, d))}
        else:
            f = cfg.d_ff
            blocks["mlp"] = {"wi": dense((n, d, f)), "wg": dense((n, d, f)),
                             "wo": dense((n, f, d))}
        tree = {"blocks": blocks}
    tree = {"embed": {"e": normal((v, d), 1.0)},
            "final_norm": {"g": ones((d,))}, **tree}
    if not cfg.tie_embeddings:
        tree["unembed"] = {"w": dense((d, v))}
    if cfg.frontend == "audio":
        tree["frontend"] = {"proj": dense((512, d))}
        tree["head"] = {"w": dense((d, v))}
    elif cfg.frontend == "vision":
        tree["frontend"] = {"w1": dense((cfg.d_frontend, d)),
                            "w2": dense((d, d))}
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


def family_inputs(cfg, kind: str) -> dict:
    """The seeded inputs of a reduced family's record (f32 numpy, from
    ``default_rng(FAMILIES_SPEC["input_seed"])``): ``"encode"`` gives
    ``{"frames": (batch, frames, 512)}``, ``"vision"`` gives
    ``{"patches": (1, n_patches, d_frontend), "tokens": (1, tokens)}``."""
    rng = np.random.default_rng(FAMILIES_SPEC["input_seed"])
    spec = FAMILIES_SPEC[kind]
    if kind == "encode":
        return {"frames": rng.standard_normal(
            (spec["batch"], spec["frames"], 512)).astype(np.float32)}
    return {"patches": rng.standard_normal(
                (1, cfg.n_patches, cfg.d_frontend)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, (1, spec["tokens"])
                                   ).astype(np.int32)}


def load_families_golden(path: str = FAMILIES_GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def check_logits(got, want: dict, tol: float = FAMILIES_TOL) -> float:
    """Raise unless ``got`` (an array or tensor) has the record's shape and
    is within ``tol`` of its logits (rtol = atol); returns max |err|."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().cpu().numpy()
    got = np.asarray(got, np.float32)
    ref = np.asarray(want["logits"], np.float32).reshape(want["shape"])
    if got.shape != ref.shape:
        raise AssertionError(f"logits of shape {got.shape}, golden "
                             f"{ref.shape}")
    err = float(np.abs(got - ref).max())
    if not np.allclose(got, ref, rtol=tol, atol=tol):
        raise AssertionError(f"logits differ from the golden record by up "
                             f"to {err} (rtol = atol = {tol})")
    return err


def train_family_batch(cfg, *, batch: int | None = None,
                       seed: int | None = None) -> dict:
    """The numpy batch of a reduced family's training record (f32 frames and
    patches, int32 ids; ``batch`` rows, by default the record's, from
    ``default_rng(seed)``, by default ``TRAIN_FAMILIES_SPEC["input_seed"]``),
    shaped as ``synth_batch`` shapes it: the encoder's ``frames``,
    ``labels`` and a ``mask`` of ones, the VLM's ``patches`` before its
    ``tokens`` (its own ``labels``), a text model's ``tokens`` (its own
    ``labels``)."""
    spec = TRAIN_FAMILIES_SPEC
    rng = np.random.default_rng(spec["input_seed"] if seed is None else seed)
    b, s = batch or spec["batch"], spec["seq"]

    def ids(shape):
        return rng.integers(0, cfg.vocab, shape).astype(np.int32)

    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal((b, s, 512)).astype(np.float32),
                "labels": ids((b, s)), "mask": np.ones((b, s), np.float32)}
    if cfg.frontend == "vision":
        toks = ids((b, max(s - cfg.n_patches, 8)))
        return {"tokens": toks, "labels": toks, "patches": rng.standard_normal(
            (b, cfg.n_patches, cfg.d_frontend)).astype(np.float32)}
    toks = ids((b, s))
    return {"tokens": toks, "labels": toks}


def train_family_run(arch: str, device, *, mesh=None,
                     steps: int | None = None) -> dict:
    """The port's run of one arch of the reduced families' training record
    on ``device`` (f32): its ``loss``, ``aux_loss`` and ``grad_norm`` at
    each of ``steps`` steps (by default the record's), as floats.  With
    ``mesh`` (a named ``DeviceMesh`` whose ranks each call this alike) the
    parameters are placed by ``param_shardings`` and the batch over the
    batch axes, and the steps run on that mesh."""
    from repro_torch import configs
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import make_train_step
    spec = TRAIN_FAMILIES_SPEC
    cfg = configs.get_arch(configs.ALIASES[arch]).reduced()
    params = params_from_numpy(serve_params_numpy(cfg, spec["param_seed"]),
                               cfg, device)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in train_family_batch(cfg).items()}
    if mesh is not None:
        params = shd.place_params(params, mesh)
        batch = {k: shd.place(v, shd.batch_sharding(mesh, v.shape))
                 for k, v in batch.items()}
    state = adamw_init(params.tree())
    step = make_train_step(cfg, lr=spec["lr"], aux_weight=spec["aux_weight"])
    out: dict = {"loss": [], "aux_loss": [], "grad_norm": []}
    for _ in range(spec["steps"] if steps is None else steps):
        with dctx.use_mesh(mesh):
            params, state, m = step(params, state, batch)
        for k in out:
            out[k].append(float(m[k]))
    return out


def load_train_families_golden(path: str = TRAIN_FAMILIES_GOLDEN_PATH
                               ) -> dict:
    with open(path) as f:
        return json.load(f)


def load_train_golden(path: str = TRAIN_GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def check_train(losses, aux_losses, grad_norms, want: dict,
                rtol: float = TRAIN_RTOL) -> dict:
    """Raise unless each step's loss, aux loss and gradient norm equal the
    golden record's within ``rtol``; returns each one's largest relative
    error over the steps."""
    errs = train_rel_errs(losses, aux_losses, grad_norms, want)
    got = dict(loss=losses, aux_loss=aux_losses, grad_norm=grad_norms)
    for k, vals in got.items():
        ref = want[k]
        if len(vals) != len(ref):
            raise AssertionError(f"{len(vals)} steps of {k}, golden has "
                                 f"{len(ref)}")
        bad = [i for i, (g, r) in enumerate(zip(vals, ref))
               if not abs(g - r) <= rtol * abs(r)]
        if bad:
            i = bad[0]
            raise AssertionError(f"{k} at step {i}: {vals[i]!r} != golden "
                                 f"{ref[i]!r} (rtol {rtol}); got {vals}")
    return errs


def train_rel_errs(losses, aux_losses, grad_norms, want: dict) -> dict:
    """The largest |got - golden| / |golden| over the steps of the loss, the
    aux loss and the gradient norm (over the steps both have); a golden 0
    (the aux loss of a model without experts) counts 0 if met exactly and
    inf otherwise."""
    def rel(g, r):
        return abs(g - r) / abs(r) if r else (0.0 if g == r else float("inf"))

    got = dict(loss=losses, aux_loss=aux_losses, grad_norm=grad_norms)
    return {k: max((rel(g, r) for g, r in zip(vals, want[k])), default=0.0)
            for k, vals in got.items()}
