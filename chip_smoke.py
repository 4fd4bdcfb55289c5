"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build every CUDA kernel under ``src/repro_torch/csrc`` with ``nvcc``
   (in parallel) and print the build seconds and ptxas reports;
2. print the card's name and power limit, and turn TF32 off;
3. drive the port's main path with every kernel launch count set to 0:
   the paper grids (grid A: 13 workloads x nexus/tia/tia_valiant at 4x4;
   grid B: spmv/sddmm/bfs under nexus at 2x2, 4x4, 8x8) through
   ``repro_torch.bench.harness`` on the card, then the ``bcsr_spmm`` and
   ``sddmm`` benchmark legs in f32 and bf16; every lane must complete,
   pass its workload's numpy oracle and equal the JAX reference's golden
   records (``src/repro_torch/golden/paper_grid.json``) bit for bit, each
   leg must agree with its kernel's plain PyTorch version (rtol = atol =
   1e-4 in f32, 2e-2 in bf16), and every kernel must have been launched;
4. at the f32 legs' shapes, time each kernel and its plain version with
   CUDA events over CUDA-graph replays, and one PyTorch library call of
   the same function with CUDA events over back-to-back calls (median of
   21 each); compute each kernel's bound from the bytes and FLOPs its data
   needs;
5. print the kernels line, the card line and, last, the ok line.

Needs one card, and exits non-zero without printing a result when CUDA
is not available.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

from repro_torch.bench import golden, harness  # noqa: E402
from repro_torch.bench import kernels as bench_kernels  # noqa: E402
from repro_torch.bench.workloads import make_all  # noqa: E402
from repro_torch.kernels import _build, bcsr_spmm, sddmm_blocks  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and f32 FLOP/s outside
# the tensor cores (the kernels run plain f32 FMA)
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
KERNELS = {
    "bcsr_spmm": dict(wrapper=bcsr_spmm,
                      source="src/repro_torch/csrc/bcsr_spmm.cu",
                      replaces="src/repro/kernels/bcsr_spmm/kernel.py:40"),
    "sddmm_blocks": dict(wrapper=sddmm_blocks,
                         source="src/repro_torch/csrc/sddmm.cu",
                         replaces="src/repro/kernels/sddmm/kernel.py:39"),
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
    matmul of the pre-gathered panels."""
    if name == "bcsr_spmm":
        a, b = args["a"], args["b"]
        live = a.n_blocks
        sp = torch.sparse_bsr_tensor(
            a.indptr, a.indices[:live], a.blocks[:live], size=a.shape,
            check_invariants=True)
        return lambda: torch.sparse.mm(sp, b)
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
        lanes, wall = harness.run_grid_lanes(
            wls, spec["modes"], max_cycles=golden.MAX_CYCLES,
            sizes=spec["sizes"], device="cuda")
        got = {golden.lane_key(ln.workload.name, ln.mode, ln.size):
               golden.lane_record(ln.result) for ln in lanes}
        golden.check_lanes(got, want[name]["lanes"])
        cycles = [ln.result.cycles for ln in lanes]
        ticks = -(-max(cycles) // 512) * 512
        stats[name] = dict(
            lanes=len(lanes), wall_s=wall, lane_cycles=sum(cycles),
            engine_ticks=ticks, lane_cycles_per_s=sum(cycles) / wall,
            engine_ticks_per_s=ticks / wall,
            peak_mem_bytes=torch.cuda.max_memory_allocated())
        print(f"[sim] {name}: {len(lanes)} lanes match the golden records; "
              f"{json.dumps(stats[name])}", flush=True)
    return stats


def check_kernels(errs: dict) -> list:
    """Each kernel timed beside its plain version and its bound; ``errs``
    is the main path's max |kernel - plain| per kernel and dtype."""
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
        rows.append(row)
    # the library yardsticks last: a refused call cannot disturb the rest
    for row in rows:
        try:
            row["library_ms"] = library_ms(
                library_call(row["name"], legs[row["name"]]))
        except (RuntimeError, NotImplementedError) as e:
            row["library_error"] = f"{type(e).__name__}: {e}"[:300]
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

    # --- the main path, launch counts from zero ------------------------------
    for meta in KERNELS.values():
        meta["wrapper"].launches = 0
    sim = run_grids()
    errs = bench_kernels.main(device="cuda")
    torch.cuda.synchronize()
    launches = {n: m["wrapper"].launches for n, m in KERNELS.items()}
    print(f"[main path] launches {launches}; legs max |err| {errs}",
          flush=True)
    for n, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{n} was not launched on the main path")

    rows = check_kernels(errs)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(f"[done] {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"simulator": sim}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
