"""Where the port's hand-written matmul kernels lose time, on the card.

    PYTHONPATH=src python -m repro_torch.bench.profile_kernels [--reps 20]

Profiles ``group_matmul`` at the f32 benchmark leg (the 128 x 128 tile
core), at the serving rows' decode shapes (the bf16 TMA weight stream,
tile_m 8: Phi-3.5-MoE's 16 experts and a ``[mesh]`` rank's 8, 4096 <->
6400; DeepSeek-V2-Lite's 64 and a rank's 32, 2048 <-> 1408) and at the
training shapes of
Phi-3.5-MoE (16 experts x 256 rows, 160 of them tokens, tile_m 128,
4096 -> 6400) and DeepSeek-V2-Lite (64 experts x 60 rows, tile_m 60,
2048 -> 1408), forward and dx (``trans_w``), on the tensor-core shape;
``sddmm`` at its f32 leg
(128 x 64 tiles) and ``bcsr_spmm`` at its f32 leg (128 x 64 tiles, each
row's contraction split over a cluster of ``split`` ranks), and prints
one JSON line per kernel:

* ``ms``: device time per call, the mean over the kernel events that
  ``torch.profiler`` kept of ``--reps`` calls (``events``);
* ``launch``: what the profiler records of the kernel's launch (grid,
  block, registers per thread, shared memory, blocks and warps per SM,
  estimated achieved occupancy);
* ``no_loads_ms`` (the tile-core, tensor-core and weight-stream kernels):
  the same sources built with the tile core's global loads replaced by
  constants and, with ``-DGM_NO_LOADS``, the TMA shapes' loads left out
  (each stage's barrier released at once, the products run on what shared
  memory holds), so that the inner loop, the partial sums and the stores
  run alone.
  That is the floor the kernel cannot go below without a new inner loop;
  ``ms - no_loads_ms`` is what waiting on the loads costs.
* the training rows also: ``cta_shape``, ``bound_ms`` / ``bound_by``
  (the bytes and FLOPs of the 160 or 60 token rows, as ``chip_smoke.py``
  counts them), ``bound_share`` (bound_ms / ms) and ``math_ms``, the
  padded rows' FLOPs at the card's bf16 peak (989 TFLOP/s).
* the serving rows also: ``cta_shape`` and ``split`` (the launch's
  :class:`~repro_torch.kernels.group_matmul.StreamPlan`: CTAs, stages a
  CTA, CTAs a unit), ``ctas``, ``bound_ms`` / ``bound_by`` (one token row
  an expert, as ``chip_smoke.py`` counts a decode step) and
  ``bound_share``.
* ``bcsr_spmm`` also: ``split`` (the wrapper's choice, the launch's
  cluster size), ``ms_by_split`` (the time at each split of 1, 2, 4 and
  8, each with its no-loads floor and its ``phases``) and ``empty_ms``
  (the same launch with ``n_blocks = 0``: every output written as zeros,
  the floor of the launch and of the output's bytes).  ``phases`` comes
  from a build with ``-DBCSR_PHASES``, whose CTAs log the card's clock
  (``%globaltimer``, us from the first CTA's start) at each phase of one
  launch: the span, the row's index loads, the core's products (median
  and max over the CTAs with work), the partials' sends, the cluster
  barrier and the sum (medians), when the CTAs without work end, and how
  many SMs hold 0, 1, 2, ... CTAs with work.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.bench import kernels as bench_kernels
from repro_torch.kernels import _build, bcsr_spmm, group_matmul
from repro_torch.kernels.bcsr_spmm import (MAX_SPLIT, TILE_M, TILE_N,
                                           launch_split)
from repro_torch.kernels.group_matmul import (call_token, launch_plan,
                                              launch_shape, stream_workspace)

#: the training shapes: experts, capacity slots (padded), token rows,
#: d, f; tile_m = min(128, slots)
TRAIN_SHAPES = {"group_matmul_train": (16, 256, 160, 4096, 6400),
                "group_matmul_deepseek_train": (64, 60, 60, 2048, 1408)}
#: the serving rows' decode shapes: experts, d, f of ``wg`` (``wo`` swaps
#: d and f)
SERVE_SHAPES = {"group_matmul_serve": (16, 4096, 6400),
                "group_matmul_mesh_serve": (8, 4096, 6400),
                "group_matmul_deepseek_serve": (64, 2048, 1408),
                "group_matmul_deepseek_mesh_serve": (32, 2048, 1408)}
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

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
    """``group_matmul.cu``, ``sddmm.cu`` and ``bcsr_spmm.cu`` built against
    a copy of ``tile_f32.cuh`` whose fetch loads constants; {name: CDLL}."""
    header = _build.source("tile_f32.cuh")
    if FETCH not in header:
        raise RuntimeError("tile_f32.cuh no longer has the fetch this "
                           "build replaces")
    out = os.path.join(_build.BUILD_DIR, "no_loads")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "tile_f32.cuh"), "w") as f:
        f.write(header.replace(FETCH, NO_LOADS))
    return _build.build_copies("no_loads", {
        name: _build.source(f"{name}.cu")
        for name in ("group_matmul", "sddmm", "bcsr_spmm")})


def build_tma_no_loads():
    """``group_matmul.cu`` built with ``-DGM_NO_LOADS``: the loading
    thread of the tensor-core shape and of the weight stream issues no
    TMA load."""
    return _build.build_copies(
        "tma_no_loads", {"group_matmul": _build.source("group_matmul.cu")},
        ("-DGM_NO_LOADS",))["group_matmul"]


def build_phases():
    """``bcsr_spmm.cu`` built with its phase log (``-DBCSR_PHASES``)."""
    return _build.build_copies(
        "phases", {"bcsr_spmm": _build.source("bcsr_spmm.cu")},
        ("-DBCSR_PHASES",))["bcsr_spmm"]


def phases(lib, call, n_ctas: int, n_sms: int) -> dict:
    """The phase log of one ``call()`` (after three untimed ones) of the
    phases build: us from the first CTA's start."""
    log = np.zeros((8192, 8), np.uint64)
    read = lib.bcsr_spmm_phases
    read.argtypes = [ctypes.c_void_p]
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    _build.check_launch("bcsr_spmm_phases", read(log.ctypes.data))
    call()
    torch.cuda.synchronize()
    _build.check_launch("bcsr_spmm_phases", read(log.ctypes.data))
    t = log[:n_ctas, :6].astype(np.int64)
    sm = log[:n_ctas, 7].astype(np.int64)
    t = np.where(t > 0, t - t[:, 0].min(), -1) / 1e3
    work = t[:, 2] >= 0

    def med(x):   # the clock ticks in ns: keep three decimals of a us
        return round(float(np.median(x)), 3) if len(x) else None

    out = dict(span_us=round(float(t[:, 5].max()), 3),
               index_us=med(t[:, 1] - t[:, 0]),
               core_us=med(t[work, 2] - t[work, 1]),
               core_max_us=round(float((t[work, 2] - t[work, 1]).max()), 3)
               if work.any() else None,
               idle_ctas_end_us=med(t[~work, 5]),
               sms_by_working_ctas=np.bincount(np.bincount(
                   sm[work], minlength=n_sms)).tolist())
    if work.any() and (t[work, 3] >= 0).all():
        out.update(send_us=med(t[work, 3] - t[work, 2]),
                   barrier_us=med(t[work, 4] - t[work, 3]),
                   sum_us=med(t[work, 5] - t[work, 4]))
    return out


def _entry(lib, symbol: str, n_ptrs: int, n_ints: int, n_u64: int = 0):
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_uint64] * n_u64 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def training_operands(name: str, gen: torch.Generator) -> dict:
    """bf16 operands at a training shape: x with its padding rows zero,
    ``w`` (e, d, f), the dx's cotangent (e x slots, f), the expert ids."""
    e, slots, rows, d, f = TRAIN_SHAPES[name]
    x = torch.zeros((e, slots, d), device="cuda", dtype=torch.bfloat16)
    x[:, :rows] = torch.randn((e, rows, d), generator=gen, device="cuda")
    dy = torch.zeros((e, slots, f), device="cuda", dtype=torch.bfloat16)
    dy[:, :rows] = torch.randn((e, rows, f), generator=gen, device="cuda")
    w = (torch.randn((e, d, f), generator=gen, device="cuda")
         * d ** -0.5).to(torch.bfloat16)
    tile_m = min(128, slots)
    eid = torch.arange(e, dtype=torch.int32, device="cuda"
                       ).repeat_interleave(slots // tile_m)
    return dict(x=x.reshape(e * slots, d), dy=dy.reshape(e * slots, f),
                w=w, eid=eid, tile_m=tile_m)


def training_bound(name: str, trans_w: bool) -> dict:
    """The least time of a training call's token rows (bytes over HBM's
    rate against FLOPs over the bf16 peak), and the padded rows' FLOPs at
    that peak."""
    e, slots, rows, d, f = TRAIN_SHAPES[name]
    k, n = (f, d) if trans_w else (d, f)
    nbytes = (e * rows * k + e * k * n) * 2 + e * rows * n * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * e * rows * k * n / PEAK_BF16_FLOPS
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                math_ms=2 * e * slots * k * n / PEAK_BF16_FLOPS * 1e3)


def training_rows(gen: torch.Generator, stream: int, reps: int,
                  tc_fn) -> list:
    """The tensor-core shape at each training shape, forward and dx: the
    profile of the kernel through the wrapper, its bound, and its
    no-loads floor (``tc_fn``: :func:`build_tma_no_loads`' entry)."""
    rows = []
    for name in TRAIN_SHAPES:
        op = training_operands(name, gen)
        for suffix, xin, tw in (("", op["x"], False), ("_dx", op["dy"], True)):
            w, eid, tile_m = op["w"], op["eid"], op["tile_m"]
            out = torch.empty((xin.shape[0], w.shape[1 if tw else 2]),
                              device="cuda")

            def floor(xin=xin, tw=tw, out=out):
                _build.check_launch("group_matmul_bf16", tc_fn(
                    xin.data_ptr(), eid.data_ptr(), w.data_ptr(),
                    out.data_ptr(), None, xin.shape[0] // tile_m, tile_m,
                    xin.shape[1], out.shape[1], w.shape[0], int(tw), 0, 0,
                    stream))
            row = dict(
                name=name + suffix,
                shape=f"{'dx' if tw else 'forward'} wg, bf16, tile_m {tile_m}",
                cta_shape=launch_shape(xin, w, tile_m=tile_m, trans_w=tw),
                **training_bound(name, tw),
                **kernel_profile(lambda xin=xin, tw=tw: group_matmul(
                    xin, eid, w, tile_m=tile_m, trans_w=tw),
                    "group_matmul_tc", reps))
            row["no_loads_ms"] = kernel_profile(floor, "group_matmul_tc",
                                                reps)["ms"]
            row["bound_share"] = row["bound_ms"] / row["ms"]
            rows.append(row)
        del op
    return rows


def serving_rows(gen: torch.Generator, stream: int, reps: int,
                 fn) -> list:
    """The TMA weight stream at each serving row's decode shapes, ``wg``
    and ``wo`` (one token row an expert in 8-row tiles): the profile of
    the kernel through the wrapper, its plan, its bound and its no-loads
    floor (``fn``: :func:`build_tma_no_loads`' entry)."""
    rows = []
    for name, (e, dg, fg) in SERVE_SHAPES.items():
        for tag, d, f in (("wg", dg, fg), ("wo", fg, dg)):
            x = torch.zeros((e * 8, d), device="cuda", dtype=torch.bfloat16)
            x[::8] = torch.randn((e, d), generator=gen, device="cuda")
            w = (torch.randn((e, d, f), generator=gen, device="cuda")
                 * d ** -0.5).to(torch.bfloat16)
            eid = torch.arange(e, dtype=torch.int32, device="cuda")
            plan = launch_plan(x, w, tile_m=8)
            ws = stream_workspace(plan, "cuda")
            out = torch.empty((e * 8, f), device="cuda")
            nbytes = (e * d + e * d * f) * 2 + e * f * 4
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = 2 * e * d * f / PEAK_BF16_FLOPS

            def floor(x=x, w=w, eid=eid, out=out, ws=ws, plan=plan):
                _build.check_launch("group_matmul_bf16", fn(
                    x.data_ptr(), eid.data_ptr(), w.data_ptr(),
                    out.data_ptr(), ws.data_ptr(), e, 8, x.shape[1],
                    out.shape[1], e, 0, plan.ctas, call_token(), stream))
            row = dict(
                name=name, shape=f"decode {tag}, bf16, tile_m 8, {e} x "
                f"{d} -> {f}", cta_shape=launch_shape(x, w, tile_m=8),
                split=plan.describe(), ctas=plan.ctas,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                **kernel_profile(lambda x=x, w=w, eid=eid: group_matmul(
                    x, eid, w, tile_m=8), "group_matmul_sk", reps))
            row["no_loads_ms"] = kernel_profile(floor, "group_matmul_sk",
                                                reps)["ms"]
            row["bound_share"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            del x, w, ws, out
    return rows


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
    rows = [
        dict(name="group_matmul", shape="leg, f32, tile_m 32",
             **kernel_profile(lambda: bench_kernels.run_kernel(
                 "group_matmul", gm), "group_matmul_tiled", ns.reps)),
        dict(name="sddmm_blocks", shape="leg, f32",
             **kernel_profile(lambda: bench_kernels.run_kernel(
                 "sddmm_blocks", sd), "sddmm_kernel", ns.reps)),
    ]
    bc = legs["bcsr_spmm"]
    a, b = bc["a"], bc["b"]
    bm, bn = a.block
    mb, kp = a.shape[0] // bm, b.shape[1]   # k = 512 needs no padding
    split = launch_split(a, b)
    splits = [1 << i for i in range(MAX_SPLIT.bit_length())]
    bc_row = dict(name="bcsr_spmm", shape="leg, f32", split=split,
                  **kernel_profile(lambda: bcsr_spmm(a, b), "bcsr_spmm_kernel",
                                   ns.reps))
    bc_row["launch"]["cluster"] = [split, 1, 1]
    bc_row["ms_by_split"] = {
        str(s): {"ms": kernel_profile(lambda s=s: bcsr_spmm(a, b, split=s),
                                      "bcsr_spmm_kernel", ns.reps)["ms"]}
        for s in splits}
    empty = dataclasses.replace(a, n_blocks=0)
    bc_row["empty_ms"] = kernel_profile(lambda: bcsr_spmm(empty, b),
                                        "bcsr_spmm_kernel", ns.reps)["ms"]
    rows.append(bc_row)
    libs = build_no_loads()
    stream = torch.cuda.current_stream().cuda_stream
    t, d = gm["x"].shape
    n_exp, _, f = gm["w"].shape
    gm_out = torch.empty((t, f), device="cuda")
    gm_fn = _entry(libs["group_matmul"], "group_matmul_f32", 5, 7, 1)
    sd_out = torch.empty((sd["brow"].numel(), sd["bm"], sd["bn"]),
                         device="cuda")
    sd_fn = _entry(libs["sddmm"], "sddmm_f32", 5, 6)
    bcap = sd["brow"].numel()
    bc_out = torch.empty((a.shape[0], kp), device="cuda")
    bc_fn = _entry(libs["bcsr_spmm"], "bcsr_spmm_f32", 5, 6)

    def gm_call():
        _build.check_launch("group_matmul_f32", gm_fn(
            gm["x"].data_ptr(), gm["eid"].data_ptr(), gm["w"].data_ptr(),
            gm_out.data_ptr(), None, t // gm["tile_m"], gm["tile_m"], d, f,
            n_exp, 0, 0, 0, stream))


    def sd_call():
        _build.check_launch("sddmm_f32", sd_fn(
            sd["brow"].data_ptr(), sd["bcol"].data_ptr(), sd["a"].data_ptr(),
            sd["b"].data_ptr(), sd_out.data_ptr(), bcap, bcap, sd["bm"],
            sd["bn"], sd["a"].shape[1], sd["b"].shape[1], stream))

    def bc_call(fn, s):
        _build.check_launch("bcsr_spmm_f32", fn(
            a.indptr.data_ptr(), a.indices.data_ptr(), a.blocks.data_ptr(),
            b.data_ptr(), bc_out.data_ptr(), mb, bm, bn, kp, a.n_blocks, s,
            stream))

    no_loads = {
        "group_matmul": kernel_profile(gm_call, "group_matmul_tiled",
                                       ns.reps),
        "sddmm_blocks": kernel_profile(sd_call, "sddmm_kernel", ns.reps),
    }
    for s in splits:
        bc_row["ms_by_split"][str(s)]["no_loads_ms"] = kernel_profile(
            lambda s=s: bc_call(bc_fn, s), "bcsr_spmm_kernel", ns.reps)["ms"]
    phase_lib = build_phases()
    phase_fn = _entry(phase_lib, "bcsr_spmm_f32", 5, 6)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = mb * -(-bm // TILE_M) * -(-kp // TILE_N)
    for s in splits:
        bc_row["ms_by_split"][str(s)]["phases"] = phases(
            phase_lib, lambda s=s: bc_call(phase_fn, s), tiles * s, n_sms)
    no_loads["bcsr_spmm"] = dict(ms=bc_row["ms_by_split"][str(split)][
        "no_loads_ms"])

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    for row in rows:
        if row["name"] in no_loads:
            row["no_loads_ms"] = no_loads[row["name"]]["ms"]
        row["device"] = card
        print(json.dumps(row), flush=True)
    # last, so that the small kernels' sessions above run as they did
    # before these rows existed
    tma_fn = _entry(build_tma_no_loads(), "group_matmul_bf16", 5, 7, 1)
    for row in (serving_rows(gen, stream, ns.reps, tma_fn)
                + training_rows(gen, stream, ns.reps, tma_fn)):
        row["device"] = card
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
