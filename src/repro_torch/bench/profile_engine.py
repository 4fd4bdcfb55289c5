"""Where an engine tick's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.bench.profile_engine [--ticks 64]
    PYTHONPATH=src python -m repro_torch.bench.profile_engine --fast-forward

Builds grid A of the golden file (13 workloads x nexus / tia /
tia_valiant at 4x4, 39 lanes), warms the batched engine up, then steps
``--ticks`` engine ticks twice: once timed on the host clock around a
``torch.cuda.synchronize()``, once under ``torch.profiler``.  Prints one
JSON line with the wall milliseconds per tick, the device (kernel)
milliseconds per tick, the device's busy share, the kernel launches per
tick and the operators that take the most device time.

``--fast-forward`` profiles the chain leg of ``golden/sweeps.json``
instead (8 lanes of a scrambled 512-node pointer chase at 8x8) on the
compressed tick and on the plain tick (each after the same 32 warm-up
ticks from the leg's initial state), and prints one JSON line with both
records.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.bench import golden
from repro_torch.bench.harness import _placement_for
from repro_torch.bench.workloads import make_all
from repro_torch.core import machine
from repro_torch.core.batch import stack_workloads
from repro_torch.core.fastforward import make_fast_forward


def grid_a_engine(device):
    """The grid-A batch, ready to step: ``(step, st, lanes)`` where
    ``step(st)`` is one engine tick."""
    wls = golden.grid_workloads(golden.GRIDS["grid_a"], make_all())
    modes = list(machine.FABRIC_MODES)
    built = [wl.build(machine.MachineConfig(mem_words=wl.mem_words),
                      _placement_for(m)) for m in modes for wl in wls]
    lane_modes = [m for m in modes for _ in wls]
    cfg = machine.MachineConfig(mem_words=max(w.mem_words for w in wls),
                                max_cycles=golden.MAX_CYCLES)
    wb = stack_workloads(built, modes=lane_modes)
    n = wb.n_pes

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    st = machine.init_state(cfg, wb.static_ams, wb.amq_len, wb.mem_val,
                            wb.mem_meta, device=device)
    cyc = machine._make_cycle(cfg, n)
    args = (t(wb.prog), t(wb.modes), t(wb.geoms),
            t(np.zeros((wb.batch, n))),
            t(np.tile(np.arange(n), (wb.batch, 1))), st.cycle.clone(),
            t(np.full((wb.batch, n), machine.ENGINE_UNBOUNDED)))

    def step(s):
        return machine._step(cyc, cfg, *args, s)

    return step, st, wb.batch


def chain_engine(device, fast_forward: bool):
    """The chain leg's batch, ready to step: ``(step, st, lanes)``, one
    tick of the compressed engine when ``fast_forward`` else of the
    plain one."""
    cfg, kw, _ = golden.port_sweep_leg("chain")
    wb = stack_workloads(kw["workloads"])
    n = wb.n_pes

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    st = machine.init_state(cfg, wb.static_ams, wb.amq_len, wb.mem_val,
                            wb.mem_meta, device=device)
    cyc = machine._make_cycle(cfg, n)
    ffwd = make_fast_forward(cfg, n) if fast_forward else None
    args = (t(wb.prog), t(np.full((wb.batch,), machine.mode_code(cfg))),
            t(wb.geoms), t(np.zeros((wb.batch, n))),
            t(np.tile(np.arange(n), (wb.batch, 1))), st.cycle.clone(),
            t(machine.unbounded_budget(wb.batch, n)))

    def step(s):
        return machine._step(cyc, cfg, *args, s, ffwd)

    return step, st, wb.batch


def profile_ticks(step, st, lanes, ticks: int, dev) -> dict:
    """Warm ``step`` up, then time ``ticks`` ticks on the host clock and
    again under ``torch.profiler``."""
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(32):                         # warm-up: caches, allocator
        st = step(st)
    sync()
    t0 = time.perf_counter()
    for _ in range(ticks):
        st = step(st)
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ticks

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(ticks):
            st = step(st)
        sync()
    avgs = prof.key_averages()
    on_device = torch.autograd.DeviceType.CUDA

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0.0) or 0.0

    # a kernel's time is in its own (device) event and again in the self
    # device time of the operator that launched it: sum the device events
    # for the total, rank the operators for the breakdown
    device_us = sum(dev_us(e) for e in avgs if e.device_type == on_device)
    kernels = sum(1 for e in prof.events() if e.device_type == on_device)
    top = sorted((e for e in avgs if e.device_type != on_device),
                 key=dev_us, reverse=True)[:8]
    return dict(
        device=(torch.cuda.get_device_name(0) if cuda else "cpu"),
        lanes=lanes, ticks=ticks, wall_ms_per_tick=wall_ms,
        device_ms_per_tick=device_us / 1e3 / ticks,
        device_busy_share=(device_us / 1e3 / ticks) / wall_ms,
        kernel_launches_per_tick=kernels / ticks,
        top_device_ops=[dict(name=e.key, us_per_tick=dev_us(e) / ticks,
                             calls_per_tick=e.count / ticks)
                        for e in top])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fast-forward", action="store_true",
                    help="profile the chain leg's compressed and plain "
                         "ticks instead of grid A's")
    ns = ap.parse_args(argv)
    dev = torch.device(ns.device)
    if ns.fast_forward:
        out = {f"chain_{name}": profile_ticks(
            *chain_engine(dev, ff), ns.ticks, dev)
            for name, ff in (("fast_forward", True), ("plain", False))}
    else:
        out = profile_ticks(*grid_a_engine(dev), ns.ticks, dev)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
