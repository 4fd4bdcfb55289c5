"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build every CUDA kernel under ``src/repro_torch/csrc`` with ``nvcc``
   (in parallel) and print the build seconds and ptxas reports;
2. print the card's name and power limit, and turn TF32 off;
3. the simulator and kernel-leg path, every launch count set to 0 just
   before it and read just after: the paper grids (grid A: 13 workloads x
   nexus/tia/tia_valiant at 4x4; grid B: spmv/sddmm/bfs under nexus at
   2x2, 4x4, 8x8) through ``repro_torch.bench.harness``, then the
   ``bcsr_spmm``, ``sddmm`` and ``group_matmul`` benchmark legs in f32 and
   bf16; every lane must complete, pass its workload's numpy oracle and
   equal the JAX reference's golden records
   (``src/repro_torch/golden/paper_grid.json``) bit for bit, each leg must
   agree with its kernel's plain PyTorch version (rtol = atol = 1e-4 in
   f32, 2e-2 in bf16), and each of the three kernels must have been
   launched.  Between the grids and the kernel legs, the ``[sweep]``
   legs run through ``repro_torch.core.sweep.sweep(..., device="cuda")``
   and are held to ``src/repro_torch/golden/sweeps.json`` (every lane bit
   for bit, the packing schedule and the engine telemetry field for
   field): the packed Fig. 17 grid (9 lanes, 4 waves of 8x8
   super-lanes), the 512-node pointer chase (8 lanes at 8x8) on the
   fast-forward and on the plain engine, and a packed leg with a
   per-lane deadline; each prints its wall, engine ticks, lane-cycles/s,
   dead-step fraction, waves, packing efficiency and peak memory.  After
   the ``[sweep]`` legs, the ``[service]`` phase drives the resident
   sweep service (``repro_torch.serve.SweepService``) on the card: the
   chaos soak of ``repro_torch.bench.chaos_soak`` (seed 5: the
   ``fig17_traffic(copies=2)`` lanes at chunk 8 with seeded transients
   and a scheduler kill, a deadline lane cut at half its cycles,
   duplicates, a checkpoint every 2 slices, then a restore from the
   middle checkpoint that finishes the in-flight lanes) and one clean
   ``serve_bench.soak`` round of the same traffic; every survivor,
   duplicate and restored lane must equal its record in
   ``src/repro_torch/golden/service.json`` bit for bit, the deadline
   lane must freeze exactly at its bound with the reference's frozen
   record, both a transient and a kill must have fired, and the clean
   soak must have run on one cached engine;
4. the serving path, launch counts again from 0: Phi-3.5-MoE at full
   width (d 4096, 32/8 heads of 128, 16 experts top-2 of 6400, vocab
   32064), depth cut to 4 layers, bf16 parameters from a seeded
   generator, serving the 6 requests of ``examples/serve_moe.py`` (8 new
   tokens, 3 slots, cache 128) through ``repro_torch.launch.serve``, five
   times on the same parameters (median and spread of the speeds); every
   request must get its 8 tokens in [0, vocab), the same in every serve,
   the prefill logits must be finite, ``group_matmul`` must have been
   launched, and its outputs in the first prefill's and first decode
   step's three expert products of layer 0 must agree with the plain
   version (rtol = atol = 2e-2);
5. the reduced Phi-3.5-MoE (2 layers, d 128, 4 experts) served with f32
   parameters on the card, its greedy tokens held to the reference's in
   ``src/repro_torch/golden/serve_reduced.json`` up to each request's
   first token won by a top-2 logit margin under 1e-3;
6. time each kernel and its plain version with CUDA events over
   CUDA-graph replays, and one PyTorch library call of the same function
   with CUDA events over back-to-back calls (median of 21 each), at the
   f32 legs' shapes and, for ``group_matmul``, also at the serving
   path's decode and prefill shapes; compute each kernel's bound from the
   bytes and FLOPs its data needs, its share of that bound
   (``bound_share``) and its time over the library call's
   (``vs_library``);
7. print the kernels line (a row per leg with the legs' launches,
   ``bcsr_spmm``'s with the cluster split ``S`` its wrapper launched, and a
   ``group_matmul_serve`` row at the decode shape, with ``wo`` and the
   prefill's ``prefill_wg`` / ``prefill_wo`` in it, with the serving
   path's launches), the card line and, last, the ok line.

Needs one card, and exits non-zero without printing a result when CUDA
is not available.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.bench import golden, harness  # noqa: E402
from repro_torch.bench import chaos_soak, serve_bench  # noqa: E402
from repro_torch.bench import kernels as bench_kernels  # noqa: E402
from repro_torch.bench.workloads import make_all  # noqa: E402
from repro_torch.core.sweep import SweepRequest, sweep  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import (_build, bcsr_spmm, group_matmul,  # noqa: E402
                                 group_matmul_plain, sddmm_blocks)
from repro_torch.kernels.bcsr_spmm import launch_split  # noqa: E402
from repro_torch.kernels.group_matmul import tile_by_expert  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.serve.steps import make_prefill_step  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and f32 FLOP/s outside
# the tensor cores (the kernels run plain f32 FMA; bf16 inputs are widened)
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: the full-width serving run: Phi-3.5-MoE, depth cut 32 -> 4 layers (the
#: 41.9 B parameters are 83.7 GB in bf16, more than the card's 80 GB)
SERVE_LAYERS = 4
SERVE_TRAFFIC = dict(max_new_tokens=8, batch_slots=3, cache_len=128)
#: serves of that traffic in one run (one pass is ~1.5 s, too short to
#: read the speed from once): their median and spread are reported
SERVE_REPEATS = 5
KERNELS = {
    "bcsr_spmm": dict(wrapper=bcsr_spmm,
                      source="src/repro_torch/csrc/bcsr_spmm.cu",
                      replaces="src/repro/kernels/bcsr_spmm/kernel.py:40"),
    "sddmm_blocks": dict(wrapper=sddmm_blocks,
                         source="src/repro_torch/csrc/sddmm.cu",
                         replaces="src/repro/kernels/sddmm/kernel.py:39"),
    "group_matmul": dict(wrapper=group_matmul,
                         source="src/repro_torch/csrc/group_matmul.cu",
                         replaces="src/repro/kernels/group_matmul/"
                                  "kernel.py:42"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 21, inner: int = 10) -> float:
    """Median device milliseconds of one ``fn()`` call: ``inner`` calls
    are captured in a CUDA graph, and each of ``reps`` replays is timed
    with CUDA events (so the wrappers' host overhead does not count)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def library_call(name: str, args: dict):
    """One PyTorch call computing the leg's function (the yardstick;
    the port never calls it): a BSR sparse-dense product, or a batched
    matmul of the pre-gathered panels or of the expert-grouped rows."""
    if name == "bcsr_spmm":
        a, b = args["a"], args["b"]
        live = a.n_blocks
        sp = torch.sparse_bsr_tensor(
            a.indptr, a.indices[:live], a.blocks[:live], size=a.shape,
            check_invariants=True)
        return lambda: torch.sparse.mm(sp, b)
    if name == "group_matmul":
        w = args["w"]
        xe = args["x"].reshape(w.shape[0], -1, w.shape[1])
        return lambda: torch.bmm(xe, w)
    bm, bn = args["bm"], args["bn"]
    a, b = args["a"], args["b"]
    d = a.shape[1]
    arows = a.reshape(-1, bm, d)[args["brow"].long()]
    bcols = b.reshape(d, -1, bn).permute(1, 0, 2)[args["bcol"].long()]
    return lambda: torch.bmm(arows, bcols)


def library_ms(fn, reps: int = 21, inner: int = 10) -> float:
    """Median device milliseconds of one library call, timed with CUDA
    events around ``inner`` back-to-back calls (no graph capture: a
    library may allocate inside the call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def run_grids() -> dict:
    """Grids A and B on the card, held to the golden records."""
    want = golden.load_golden()
    all_wls = make_all()
    stats = {}
    for name, spec in golden.GRIDS.items():
        wls = golden.grid_workloads(spec, all_wls)
        torch.cuda.reset_peak_memory_stats()
        tel: dict = {}
        lanes, wall = harness.run_grid_lanes(
            wls, spec["modes"], max_cycles=golden.MAX_CYCLES,
            sizes=spec["sizes"], device="cuda", telemetry=tel)
        got = {golden.lane_key(ln.workload.name, ln.mode, ln.size):
               golden.lane_record(ln.result) for ln in lanes}
        golden.check_lanes(got, want[name]["lanes"])
        cycles = [ln.result.cycles for ln in lanes]
        # one engine call over every lane, each padded to the widest mesh
        rows = len(lanes) * max(int(np.prod(ln.size or (4, 4)))
                                for ln in lanes)
        ticks = tel["stepped_pe_ticks"] // rows
        stats[name] = dict(
            lanes=len(lanes), wall_s=wall, lane_cycles=sum(cycles),
            engine_ticks=ticks, lane_cycles_per_s=sum(cycles) / wall,
            engine_ticks_per_s=ticks / wall,
            dead_step_fraction=tel["dead_step_fraction"],
            peak_mem_bytes=torch.cuda.max_memory_allocated())
        print(f"[sim] {name}: {len(lanes)} lanes match the golden records; "
              f"{json.dumps(stats[name])}", flush=True)
    return stats


def sweep_rows(report, workloads) -> int:
    """PE rows one engine call of a sweep steps a tick: the super-lanes of
    a wave times the packing mesh, or the lanes times the widest mesh."""
    if report.pack is not None:
        per_wave = report.pack.n_super_lanes // report.pack.n_waves
        return per_wave * max(int(np.prod(w["super_geom"]))
                              for w in report.pack.plan)
    return len(workloads) * max(int(np.prod(wl.geom)) for wl in workloads)


def run_sweeps() -> dict:
    """The ``[sweep]`` legs on the card through ``sweep(..., device=
    "cuda")``, held to ``sweeps.json``: every lane bit for bit, the
    packing schedule and the engine telemetry field for field; the chain
    also on the plain engine (``fast_forward=False``), whose lanes must
    equal the same golden lanes and which compresses nothing."""
    want = golden.load_sweep_golden()
    stats = {}
    for name in golden.SWEEPS:
        cfg, kw, keys = golden.port_sweep_leg(name)
        engines = [("ff", cfg)]
        if name == "chain":
            engines.append(("plain", dataclasses.replace(
                cfg, fast_forward=False)))
        for eng, run_cfg in engines:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            report = sweep(run_cfg, SweepRequest(**kw), device="cuda")
            torch.cuda.synchronize()
            wall = time.time() - t0
            got = golden.sweep_record(name, keys, report)
            golden.check_sweep(got, want[name], telemetry=eng == "ff")
            tel = report.telemetry
            if eng == "plain" and not (
                    tel.stepped_pe_ticks == tel.plain_pe_ticks
                    == want[name]["telemetry"]["plain_pe_ticks"]):
                raise AssertionError(f"plain engine telemetry {tel}")
            for key, wl, r in zip(keys, kw["workloads"], report):
                if r.completed and not wl.check(r.mem_val):
                    raise AssertionError(f"{name} {key}: WRONG RESULT")
            cycles = [r.cycles for r in report]
            ticks = tel.stepped_pe_ticks // sweep_rows(report,
                                                       kw["workloads"])
            row = dict(
                leg=name, engine=eng, lanes=len(keys), wall_s=wall,
                engine_ticks=ticks, engine_ticks_per_s=ticks / wall,
                lane_cycles=sum(cycles), lane_cycles_per_s=sum(cycles) / wall,
                dead_step_fraction=tel.dead_step_fraction,
                stepped_pe_ticks=tel.stepped_pe_ticks,
                plain_pe_ticks=tel.plain_pe_ticks,
                n_waves=None if report.pack is None else report.pack.n_waves,
                packing_efficiency=(None if report.pack is None
                                    else report.pack.packing_efficiency),
                peak_mem_bytes=torch.cuda.max_memory_allocated())
            stats[f"{name}/{eng}"] = row
            print(f"[sweep] {name} ({eng}): {len(keys)} lanes match the "
                  f"golden records; {json.dumps(row)}", flush=True)
    chain_ff, chain_plain = stats["chain/ff"], stats["chain/plain"]
    print(f"[sweep] chain fast-forward speedup "
          f"{chain_plain['wall_s'] / chain_ff['wall_s']:.3f}x "
          f"({chain_plain['wall_s']:.3f} s plain, {chain_ff['wall_s']:.3f} "
          f"s fast-forward)", flush=True)
    return stats


def run_service() -> dict:
    """The ``[service]`` phase: the chaos soak (with its restore) and one
    clean soak round of the service traffic on the card, held to
    ``service.json``."""
    want = golden.load_service_golden()
    keys = list(want["lanes"])
    t0 = time.time()
    chaos = chaos_soak.run(5, golden=want, device="cuda", verbose=False)
    chaos_s = time.time() - t0
    if chaos["failures"]:
        raise AssertionError(f"chaos soak: {chaos['failures']}")
    kinds = {k for _, _, k in chaos["fired"]}
    if not {"transient", "kill"} <= kinds:
        raise AssertionError(f"chaos soak fired {chaos['fired']}")
    if chaos["restored_lanes"] == 0:
        raise AssertionError("the restore finished no in-flight lane")
    cfg, lanes = serve_bench.fig17_traffic(golden.SERVICE["copies"])
    rounds: list = []
    t0 = time.time()
    clean = serve_bench.soak(cfg, lanes, rounds=1, slice_chunks=1,
                             device="cuda", results=rounds)
    clean_s = time.time() - t0
    if clean["drift"]:
        raise AssertionError(f"clean soak: {clean['drift']}")
    if clean["engine_cache_size"] != 1:
        raise AssertionError(f"clean soak used "
                             f"{clean['engine_cache_size']} engines")
    golden.check_lanes({keys[i]: golden.lane_record(r)
                        for i, r in sorted(rounds[0].items())},
                       want["lanes"])
    row = dict(
        lanes=len(lanes),
        chaos=dict((k, chaos[k]) for k in (
            "n_slices", "engine_ticks", "n_retries", "n_restarts",
            "n_checkpoints", "refill_occupancy", "dead_step_fraction",
            "fired", "deadline_lane", "deadline_cycles", "restored_lanes",
            "restored_from_step", "reference_s", "soak_s", "restore_s")),
        chaos_wall_s=chaos_s,
        clean=dict((k, clean[k]) for k in (
            "n_slices", "engine_ticks", "n_refills", "refill_occupancy",
            "dead_step_fraction", "engine_cache_size", "service_wall_s")),
        clean_wall_s=clean_s)
    print(f"[service] {len(lanes)} lanes of fig17_traffic(copies=2): the "
          "chaos soak, its restore and the clean soak match the golden "
          f"records; {json.dumps(row)}", flush=True)
    return row


def plain_grouped(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``grouped_expert_matmul`` through the plain version: the same
    capacity padding and tiles, then :func:`group_matmul_plain`."""
    e, c, _ = xe.shape
    x, eid, tile_m = tile_by_expert(xe)
    out = group_matmul_plain(x, eid, w, tile_m=tile_m)
    return out.reshape(e, -1, w.shape[2])[:, :c]


class ExpertCalls:
    """Records the operands and output of chosen ``grouped_expert_matmul``
    calls of ``moe_apply`` (by call index), while the call itself runs as
    it would."""

    def __init__(self, keep):
        self.keep, self.n, self.calls = set(keep), 0, {}
        self.inner = moe.grouped_expert_matmul

    def __call__(self, xe, w, **kw):
        out = self.inner(xe, w, **kw)
        if self.n in self.keep:
            self.calls[self.n] = (xe.clone(), w, out.clone())
        self.n += 1
        return out


def run_serve() -> tuple[dict, dict]:
    """Phi-3.5-MoE at full width, depth cut to :data:`SERVE_LAYERS`,
    served :data:`SERVE_REPEATS` times on the card, every launch count
    from 0; returns the stats and the expert products recorded for the
    kernel checks."""
    cfg = dataclasses.replace(configs.get_arch("phi35_moe_42b"),
                              n_layers=SERVE_LAYERS)
    reqs = golden.serve_requests()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_params(cfg, gen)
    torch.cuda.synchronize()
    # first prefill's and first decode step's wg / wi / wo of layer 0
    per_fwd = 3 * cfg.n_layers
    rec = ExpertCalls([0, 1, 2, per_fwd, per_fwd + 1, per_fwd + 2])
    moe.grouped_expert_matmul = rec
    torch.cuda.reset_peak_memory_stats()
    for meta in KERNELS.values():
        meta["wrapper"].launches = 0
    runs = []
    try:
        for _ in range(SERVE_REPEATS):
            runs.append(serve.serve_batch(cfg, reqs, reduced=False,
                                          device="cuda", params=params,
                                          **SERVE_TRAFFIC))
        torch.cuda.synchronize()
    finally:
        moe.grouped_expert_matmul = rec.inner
    launches = group_matmul.launches
    peak = torch.cuda.max_memory_allocated()
    res = runs[0]
    n_new = SERVE_TRAFFIC["max_new_tokens"]
    for i, out in enumerate(res.outputs):
        if len(out) != n_new or out.min() < 0 or out.max() >= cfg.vocab:
            raise AssertionError(f"request {i}: bad tokens {out.tolist()}")
    for k, other in enumerate(runs[1:], 1):
        if [o.tolist() for o in other.outputs] != \
                [o.tolist() for o in res.outputs]:
            raise AssertionError(f"serve {k} gave other tokens than serve 0")
    if launches <= 0:
        raise AssertionError("group_matmul was not launched on the "
                             "serving path")
    # the first wave's prefill again: finite logits, and its greedy tokens
    # are the first tokens served (no kernel sums with atomics)
    slots = SERVE_TRAFFIC["batch_slots"]
    toks = golden.first_wave_tokens(slots, "cuda")
    with torch.inference_mode():
        last, _ = make_prefill_step(cfg, SERVE_TRAFFIC["cache_len"])(
            params, toks)
    if not torch.isfinite(last).all():
        raise AssertionError("prefill logits are not finite")
    first = torch.argmax(last, dim=-1).cpu().tolist()
    if first != [int(res.outputs[i][0]) for i in range(slots)]:
        raise AssertionError(f"prefill tokens {first} differ from the "
                             "first served tokens")
    # the kernel against its plain version on the path's own operands
    errs = {}
    for n, (xe, w, got) in sorted(rec.calls.items()):
        want = plain_grouped(xe, w)
        name = ("prefill" if n < per_fwd else "decode") + \
            f"_{['wg', 'wi', 'wo'][n % 3]}"
        if not torch.allclose(got, want, rtol=2e-2, atol=2e-2):
            raise AssertionError(f"group_matmul on the serving path ({name})"
                                 f": max |err| "
                                 f"{(got - want).abs().max().item()}")
        errs[name] = (got - want).abs().max().item()
    if len(errs) != 6:
        raise AssertionError(f"recorded {sorted(rec.calls)} expert calls")
    speed = {}
    for key in ("prefill_s", "decode_s", "decode_tok_s"):
        vals = [getattr(r, key) for r in runs]
        speed[key] = dict(median=statistics.median(vals), min=min(vals),
                          max=max(vals), runs=vals)
    stats = dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_experts=cfg.moe.n_experts, d_expert=cfg.moe.d_expert,
        vocab=cfg.vocab, params=cfg.param_count(),
        requests=len(reqs), tokens=res.tokens_generated,
        serves=SERVE_REPEATS, **speed, group_matmul_launches=launches,
        launches_per_serve=launches / SERVE_REPEATS,
        peak_mem_bytes=peak, max_abs_err=errs,
        outputs=[o.tolist() for o in res.outputs])
    print(f"[serve] {json.dumps(stats)}", flush=True)
    return stats, rec.calls


def run_reduced_serve() -> int:
    """The reduced Phi-3.5-MoE with f32 parameters, held to the
    reference's golden tokens; returns how many tokens were compared."""
    spec = golden.SERVE_SPEC
    cfg = configs.get_arch(configs.ALIASES[spec["arch"]]).reduced()
    params = params_from_numpy(
        golden.serve_params_numpy(cfg, spec["param_seed"]), cfg, "cuda")
    res = serve.serve_batch(
        spec["arch"], golden.serve_requests(), device="cuda", params=params,
        max_new_tokens=spec["max_new_tokens"],
        batch_slots=spec["batch_slots"], cache_len=spec["cache_len"])
    compared = golden.check_serve_tokens(res.outputs,
                                         golden.load_serve_golden())
    print(f"[serve-reduced] {compared} of {res.tokens_generated} tokens "
          "compared, all equal to the reference's golden tokens",
          flush=True)
    return compared


def shares(row: dict) -> dict:
    """The row's ranking keys: ``bound_share`` (bound_ms / ms: the share of
    the card's least time the kernel reaches) and ``vs_library`` (ms /
    library_ms: above 1 the kernel is slower than one PyTorch call)."""
    lib = row.get("library_ms")
    return dict(row, bound_share=row["bound_ms"] / row["ms"],
                vs_library=None if lib is None else row["ms"] / lib)


def serving_shape_times(served: dict, calls: dict) -> dict:
    """The ``group_matmul_serve`` row: the kernel on the serving path's
    layer-0 operands (bf16, tile_m 8) at the first decode step (capacity
    1), ``wg``'s shape 4096 -> 6400 (``wi``'s too) in the row's own keys
    and ``wo``'s 6400 -> 4096 beside it, and at the first prefill
    (capacity 6 in one 8-row tile) for both: kernel, plain and
    ``torch.bmm`` times and the bound of the rows each call needs;
    launches and max |err| are the serving path's."""
    meta = KERNELS["group_matmul"]
    per_fwd = 3 * SERVE_LAYERS
    shapes = {}
    for n, tag in ((per_fwd, "wg"), (per_fwd + 2, "wo"), (0, "prefill_wg"),
                   (2, "prefill_wo")):
        xe, w, _ = calls[n]
        e, c, d = xe.shape
        f = w.shape[2]
        nbytes = (e * c * d + e * d * f) * w.element_size() + e * c * f * 4
        flops = 2 * e * c * d * f
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_F32_FLOPS
        shapes[tag] = shares(dict(
            shape=[e, c, d, f],
            ms=time_ms(lambda: moe.grouped_expert_matmul(xe, w)),
            plain_ms=time_ms(lambda: plain_grouped(xe, w)),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms(lambda: torch.bmm(xe, w)),
            bytes=nbytes, flops=flops))
    wg = shapes.pop("wg")
    return dict(
        name="group_matmul_serve", route="cuda", source=meta["source"],
        replaces=meta["replaces"],
        launches=served["group_matmul_launches"],
        max_abs_err=max(served["max_abs_err"].values()), dtype="bfloat16",
        **wg, **shapes)


def check_kernels(errs: dict) -> list:
    """Each kernel timed beside its plain version and its bound; ``errs``
    is the legs' max |kernel - plain| per kernel and dtype."""
    rows = []
    legs = bench_kernels.leg_inputs(torch.float32, "cuda")
    for name, meta in KERNELS.items():
        args = legs[name]
        w = bench_kernels.work(name, args)
        t_bytes = w["bytes"] / HBM_BYTES_PER_S
        t_ops = w["flops"] / PEAK_F32_FLOPS
        row = dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=None,
            max_abs_err=errs[name]["float32"],
            ms=time_ms(lambda: bench_kernels.run_kernel(name, args)),
            plain_ms=time_ms(lambda: bench_kernels.run_plain(name, args)),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, dtype="float32",
            max_abs_err_bf16=errs[name]["bfloat16"],
            flops=w["flops"], bytes=w["bytes"])
        if name == "bcsr_spmm":   # the cluster size the wrapper launched
            row["split"] = launch_split(args["a"], args["b"])
        rows.append(row)
    # the library yardsticks last: a refused call cannot disturb the rest
    for row in rows:
        try:
            row["library_ms"] = library_ms(
                library_call(row["name"], legs[row["name"]]))
        except (RuntimeError, NotImplementedError) as e:
            row["library_error"] = f"{type(e).__name__}: {e}"[:300]
    rows = [shares(row) for row in rows]
    for row in rows:
        print(f"[kernel] {json.dumps(row)}", flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.time()
    build_s = _build.build_all()
    print(f"[build] {build_s:.1f} s for {_build.sources()}", flush=True)
    for src, log in _build.BUILD_LOG.items():
        print(f"[build] {src}: {log.strip()}", flush=True)
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- the simulator and kernel-leg path, launch counts from zero ----------
    for meta in KERNELS.values():
        meta["wrapper"].launches = 0
    sim = run_grids()
    sim["sweeps"] = run_sweeps()
    sim["service"] = run_service()
    errs = bench_kernels.main(device="cuda")
    torch.cuda.synchronize()
    launches = {n: m["wrapper"].launches for n, m in KERNELS.items()}
    print(f"[legs] launches {launches}; legs max |err| {errs}", flush=True)
    for n, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{n} was not launched on the legs' path")

    # --- the serving path, launch counts from zero ---------------------------
    served, calls = run_serve()
    compared = run_reduced_serve()
    serve_row = serving_shape_times(served, calls)
    print(f"[kernel] {json.dumps(serve_row)}", flush=True)
    del calls

    rows = check_kernels(errs)
    for row in rows:
        row["launches"] = launches[row["name"]]
    rows.append(serve_row)
    print(f"[done] {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"simulator": sim, "serve": {
        k: served[k] for k in ("serves", "prefill_s", "decode_s",
                               "decode_tok_s", "group_matmul_launches",
                               "peak_mem_bytes")},
        "serve_reduced_tokens_compared": compared}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
