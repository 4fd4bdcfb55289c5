"""Where the port's hand-written matmul kernels lose time, on the card.

    PYTHONPATH=src python -m repro_torch.bench.profile_kernels [--reps 20]

Profiles ``group_matmul`` at the f32 benchmark leg (the 128 x 128 tile
core) and at the serving path's decode shape (the bf16 weight stream,
16 experts, 4096 -> 6400, tile_m 8), and ``sddmm`` at its f32 leg
(128 x 64 tiles), and prints one JSON line per kernel:

* ``ms``: device time per call, the mean over the kernel events that
  ``torch.profiler`` kept of ``--reps`` calls (``events``);
* ``launch``: what the profiler records of the kernel's launch (grid,
  block, registers per thread, shared memory, blocks and warps per SM,
  estimated achieved occupancy);
* ``no_loads_ms`` (the two tile-core kernels): the same sources built
  with the tile core's global loads replaced by constants, so that the
  shared-memory and FMA loop runs alone.  That loop is the floor the
  kernel cannot go below without a new inner loop; ``ms - no_loads_ms``
  is what waiting on the loads costs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.bench import kernels as bench_kernels
from repro_torch.kernels import _build, group_matmul

#: the tile core's fetch, and what the no-loads build puts in its place
FETCH = "constexpr bool full = decltype(flag)::value;"
NO_LOADS = (FETCH + " for (int u = 0; u < AL; ++u) ra[u] = make_float4(k0, "
            "0.f, 0.f, 1.f); for (int u = 0; u < BL; ++u) rb[u] = "
            "make_float4(0.f, k0, 1.f, 0.f); if (k0 >= 0) return;")
#: kernel-event keys that say nothing about the launch
_SKIP = {"device", "stream", "correlation", "external id", "context",
         "queued", "ev_idx"}


def kernel_profile(fn, symbol: str, reps: int) -> dict:
    """Mean device ms of the ``symbol`` kernel over ``reps`` calls of
    ``fn``, and the launch record of its first event."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"trace-{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if os.path.exists(path):
            os.remove(path)
    # the profiler may drop an event at the edge of its window: average
    # the events it kept, and say how many
    mine = [e for e in events
            if e.get("cat") == "kernel" and symbol in e.get("name", "")]
    if not mine:
        raise RuntimeError(f"{symbol}: no kernel events in {reps} calls")
    launch = {k: v for k, v in mine[0].get("args", {}).items()
              if k.lower() not in _SKIP}
    return dict(ms=sum(e["dur"] for e in mine) / len(mine) / 1e3,
                events=len(mine), launch=launch)


def build_no_loads() -> dict:
    """``group_matmul.cu`` and ``sddmm.cu`` built against a copy of
    ``tile_f32.cuh`` whose fetch loads constants; {name: CDLL}."""
    out = os.path.join(_build.BUILD_DIR, "no_loads")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(_build.CSRC, "tile_f32.cuh")) as f:
        header = f.read()
    if FETCH not in header:
        raise RuntimeError("tile_f32.cuh no longer has the fetch this "
                           "build replaces")
    with open(os.path.join(out, "tile_f32.cuh"), "w") as f:
        f.write(header.replace(FETCH, NO_LOADS))
    jobs = {}
    for name in ("group_matmul", "sddmm"):
        with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
            src = f.read()
        with open(os.path.join(out, f"{name}.cu"), "w") as f:
            f.write(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               os.path.join(out, f"{name}.so"), os.path.join(out, f"{name}.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the no-loads {name}.cu:\n"
                               f"{log}")
        libs[name] = ctypes.CDLL(os.path.join(out, f"{name}.so"))
    return libs


def _entry(lib, symbol: str, n_ptrs: int, n_ints: int):
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    legs = bench_kernels.leg_inputs(torch.float32, "cuda")
    gm, sd = legs["group_matmul"], legs["sddmm_blocks"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.zeros((128, 4096), device="cuda", dtype=torch.bfloat16)
    x[::8] = torch.randn((16, 4096), generator=gen, device="cuda").to(
        torch.bfloat16)                     # capacity 1 in 8-row tiles
    w = (torch.randn((16, 4096, 6400), generator=gen, device="cuda")
         * 0.02).to(torch.bfloat16)
    eid = torch.arange(16, dtype=torch.int32, device="cuda")
    rows = [
        dict(name="group_matmul", shape="leg, f32, tile_m 32",
             **kernel_profile(lambda: bench_kernels.run_kernel(
                 "group_matmul", gm), "group_matmul_tiled", ns.reps)),
        dict(name="group_matmul_serve", shape="decode wg, bf16, tile_m 8",
             **kernel_profile(lambda: group_matmul(x, eid, w, tile_m=8),
                              "group_matmul_stream", ns.reps)),
        dict(name="sddmm_blocks", shape="leg, f32",
             **kernel_profile(lambda: bench_kernels.run_kernel(
                 "sddmm_blocks", sd), "sddmm_kernel", ns.reps)),
    ]
    del w
    libs = build_no_loads()
    stream = torch.cuda.current_stream().cuda_stream
    t, d = gm["x"].shape
    n_exp, _, f = gm["w"].shape
    gm_out = torch.empty((t, f), device="cuda")
    gm_fn = _entry(libs["group_matmul"], "group_matmul_f32", 4, 5)
    sd_out = torch.empty((sd["brow"].numel(), sd["bm"], sd["bn"]),
                         device="cuda")
    sd_fn = _entry(libs["sddmm"], "sddmm_f32", 5, 6)
    bcap = sd["brow"].numel()

    def gm_call():
        _build.check_launch("group_matmul_f32", gm_fn(
            gm["x"].data_ptr(), gm["eid"].data_ptr(), gm["w"].data_ptr(),
            gm_out.data_ptr(), t // gm["tile_m"], gm["tile_m"], d, f, n_exp,
            stream))

    def sd_call():
        _build.check_launch("sddmm_f32", sd_fn(
            sd["brow"].data_ptr(), sd["bcol"].data_ptr(), sd["a"].data_ptr(),
            sd["b"].data_ptr(), sd_out.data_ptr(), bcap, bcap, sd["bm"],
            sd["bn"], sd["a"].shape[1], sd["b"].shape[1], stream))

    no_loads = {
        "group_matmul": kernel_profile(gm_call, "group_matmul_tiled",
                                       ns.reps),
        "sddmm_blocks": kernel_profile(sd_call, "sddmm_kernel", ns.reps),
    }
    card = torch.cuda.get_device_name(0)
    for row in rows:
        if row["name"] in no_loads:
            row["no_loads_ms"] = no_loads[row["name"]]["ms"]
        row["device"] = card
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
