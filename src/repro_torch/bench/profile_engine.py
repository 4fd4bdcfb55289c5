"""Where an engine tick's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.bench.profile_engine [--ticks 64]
    PYTHONPATH=src python -m repro_torch.bench.profile_engine --fast-forward
    PYTHONPATH=src python -m repro_torch.bench.profile_engine --static

Builds grid A of the golden file (13 workloads x nexus / tia /
tia_valiant at 4x4, 39 lanes), warms the batched engine up, then steps
``--ticks`` engine ticks twice: once timed on the host clock around a
``torch.cuda.synchronize()``, once under ``torch.profiler``.  Prints one
JSON line with the wall milliseconds per tick, the device (kernel)
milliseconds per tick, the device's busy share, the kernel launches per
tick and the operators that take the most device time.

``--static`` profiles grid A's 13 nexus lanes twice instead: on the
static golden engine (``traced_modes=False``, ``traced_geometry=False``:
the mode and the 4x4 mesh baked into the cycle) and on the traced one,
and prints one JSON line with both records.

``--fast-forward`` profiles the chain leg of ``golden/sweeps.json``
instead (8 lanes of a scrambled 256-node pointer chase at 8x8) on the
compressed tick and on the plain tick (each after the same 32 warm-up
ticks from the leg's initial state), and prints one JSON line with both
records.

``--kernel`` profiles grid A and the chain (both speeds) on the engine
chunk kernel (``kernels.cycle.cycle_chunk``, ``csrc/cycle.cu``): after
one warm-up chunk of :data:`KERNEL_CHUNK` ticks, :data:`KERNEL_CHUNKS`
chunks timed with CUDA events (a pair a chunk) and on the host clock and
as many more under ``torch.profiler`` (all inside the runs' busy
stretch), each beside the torch-op reading of the same batch; one JSON
line with the wall and device milliseconds a tick and the launches a
chunk.  ``--kernel --phases`` reads the kernel instead on grid A, the
chain at both speeds and the first packed wave of the fig17 sweep leg,
each from its initial state: the CUDA-event median of a
:data:`PHASE_TICKS`-tick chunk, the kernel's barrier floor for the same
launch shape and ticks (``kernels.cycle.barrier_floor``: its grid, block
and shared memory running its four barriers a tick and nothing else) and
its phase log (``cycle.cu`` built with ``-DCYCLE_PHASES``: the median ns
(``%globaltimer``) and SM cycles of each of a tick's four phases, and the
SM cycles between its finer marks, over the lanes and ticks,
:func:`phase_log`); ``--against PATH`` also times the
``cycle.cu`` at PATH (an earlier version) in turns with this one.

``--chase`` times ``bench_ci``'s pointer-chase leg (8 lanes of a
512-node chase at 8x8, chunk 512) through ``sweep`` on both speeds, each
warmed first: the sweep's wall, the engine calls' seconds (synchronised
around each call) and the chunk kernel's launches, so that the wall's
share outside the engine shows.
"""
from __future__ import annotations

import argparse
import dataclasses
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


#: ``--kernel``'s chunk and the chunks timed (and profiled) after one
#: warm-up chunk: 640 ticks in all, inside grid A's and the chain's work
KERNEL_CHUNK, KERNEL_CHUNKS = 128, 2
#: ``csrc/cycle.cu``'s phase log (``-DCYCLE_PHASES``): the lanes and the
#: first ticks of a launch it covers, and its marks a tick in time order
#: (the tick's start, the end of barrier 1, five marks inside phase 2,
#: the ends of barriers 2 and 3, three marks inside phase 4, the end of
#: barrier 4)
PHASE_LANES, PHASE_TICKS, PHASE_MARKS = 64, 512, 13
#: a tick's phases, each ending at its barrier, and their first and last
#: marks: the sub-lane sums, the PE-local work, the copy of the
#: neighbours' grants, the FIFOs' rewrite
PHASES = {"sums": (0, 1), "local": (1, 7), "inbox": (7, 8),
          "fifos": (8, 12)}
#: the stretches between consecutive marks (thread 0's warp)
STEPS = ("sums", "routes", "select", "decode_alu", "issue_write_push",
         "emit", "arbitrate", "inbox", "teleport", "compact_receive",
         "inject", "stats")


def _lane_args(cfg, wb, device):
    """The engine's lane arguments and initial state of batch ``wb``:
    ``(args, st)`` with ``args`` = (prog, modes, geoms, sub_ids,
    local_ids, cycle0, budget) as :func:`machine._step` and
    :func:`repro_torch.kernels.cycle.cycle_chunk` take them (no sub-lanes,
    an unbounded budget)."""
    n = wb.n_pes

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    st = machine.init_state(cfg, wb.static_ams, wb.amq_len, wb.mem_val,
                            wb.mem_meta, device=device)
    modes = (np.full((wb.batch,), machine.mode_code(cfg)) if wb.modes is None
             else wb.modes)
    packed = wb.sub_ids is not None
    args = (t(wb.prog), t(modes), t(wb.geoms),
            t(wb.sub_ids if packed else np.zeros((wb.batch, n))),
            t(wb.local_ids if packed else np.tile(np.arange(n),
                                                  (wb.batch, 1))),
            st.cycle.clone(), t(machine.unbounded_budget(wb.batch, n)))
    return args, st


def grid_a_batch(device, modes=None, static: bool = False):
    """The grid-A batch (its lanes of ``modes``, by default all three):
    ``(cfg, args, st)``; ``static`` gives the static golden engine's
    config, which bakes in the one mode of ``modes`` and the 4x4 mesh."""
    wls = golden.grid_workloads(golden.GRIDS["grid_a"], make_all())
    modes = list(machine.FABRIC_MODES) if modes is None else list(modes)
    built = [wl.build(machine.MachineConfig(mem_words=wl.mem_words),
                      _placement_for(m)) for m in modes for wl in wls]
    lane_modes = [m for m in modes for _ in wls]
    cfg = machine.MachineConfig(mem_words=max(w.mem_words for w in wls),
                                max_cycles=golden.MAX_CYCLES)
    if static:
        (mode,) = set(modes)
        cfg = dataclasses.replace(cfg, traced_modes=False,
                                  traced_geometry=False,
                                  **machine.mode_flags(mode))
    wb = stack_workloads(built, modes=lane_modes)
    return (cfg, *_lane_args(cfg, wb, device))


def chain_batch(device):
    """The chain leg's batch (8 lanes of a 256-node pointer chase at
    8x8): ``(cfg, args, st)``."""
    cfg, kw, _ = golden.port_sweep_leg("chain")
    return (cfg, *_lane_args(cfg, stack_workloads(kw["workloads"]), device))


def fig17_wave_batch(device):
    """The first packed wave of the fig17 sweep leg as ``run_many(pack=
    True)`` plans it (one 8x8 super-lane of packed sub-lanes, mem_words
    8192): ``(cfg, args, st)``."""
    from repro_torch.core.batch import pack_schedule, static_cycle_hints
    cfg, kw, _ = golden.port_sweep_leg("fig17")
    wls = kw["workloads"]
    batches, _, _ = pack_schedule(wls, cycle_hints=static_cycle_hints(wls))
    wb = batches[0]
    cfg = dataclasses.replace(cfg, mem_words=max(cfg.mem_words, wb.mem_words))
    return (cfg, *_lane_args(cfg, wb, device))


def lone_speed(args, st) -> bool:
    """The speed the engine steps a chunk from ``st`` at: compressed when
    a sub-lane is in lone flight (its probe, as ``machine.run_engine``)."""
    from repro_torch.core.fastforward import make_lone_probe
    return bool(make_lone_probe()(args[3], st).any())


def grid_a_engine(device, modes=None, static: bool = False):
    """The grid-A batch ready to step: ``(step, st, lanes)`` where
    ``step(st)`` is one torch-op engine tick (see :func:`grid_a_batch`)."""
    cfg, args, st = grid_a_batch(device, modes, static)
    cyc = machine._make_cycle(cfg, st.cycle.shape[1])

    def step(s):
        return machine._step(cyc, cfg, *args, s)

    return step, st, st.cycle.shape[0]


def chain_engine(device, fast_forward: bool):
    """The chain leg's batch, ready to step: ``(step, st, lanes)``, one
    torch-op tick of the compressed engine when ``fast_forward`` else of
    the plain one."""
    cfg, args, st = chain_batch(device)
    n = st.cycle.shape[1]
    cyc = machine._make_cycle(cfg, n)
    ffwd = make_fast_forward(cfg, n) if fast_forward else None

    def step(s):
        return machine._step(cyc, cfg, *args, s, ffwd)

    return step, st, st.cycle.shape[0]


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


def profile_chunks(cfg, args, st, chunk: int, chunks: int,
                   fast_forward: bool, dev) -> dict:
    """Warm the engine chunk kernel up with one chunk, then step
    ``chunks`` chunks of ``chunk`` ticks, each between its own pair of
    CUDA events (the device time; a chunk that launched the kernel and
    reads 0 ms raises), all of them on the host clock (the wall, up to a
    ``torch.cuda.synchronize()``), and ``chunks`` more under
    ``torch.profiler`` (the kernels it saw a chunk; None when it saw
    none, as happens to a profile taken after another in one process)."""
    from repro_torch.kernels.cycle import cycle_chunk

    def run(s):
        return cycle_chunk(cfg, *args, s, ticks=chunk,
                           fast_forward=fast_forward)

    st = run(st)
    torch.cuda.synchronize()
    launched, pairs = cycle_chunk.launches, []
    t0 = time.perf_counter()
    for _ in range(chunks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        st = run(st)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ticks = chunks * chunk
    wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    launches = cycle_chunk.launches - launched
    chunk_ms = [s.elapsed_time(e) for s, e in pairs]
    if launches > 0 and min(chunk_ms) <= 0:
        raise RuntimeError(f"profile_chunks: {launches} launches read "
                           f"{chunk_ms} ms on the CUDA events")
    device_ms = sum(chunk_ms) / ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(chunks):
            st = run(st)
        torch.cuda.synchronize()
    on_device = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == on_device]
    return dict(
        device=torch.cuda.get_device_name(0), lanes=st.cycle.shape[0],
        pes=st.cycle.shape[1], chunk=chunk, chunks=chunks,
        fast_forward=fast_forward, wall_ms_per_tick=wall_ms,
        device_ms_per_tick=device_ms, device_busy_share=device_ms / wall_ms,
        chunk_device_ms=chunk_ms,
        cycle_chunk_launches_per_chunk=launches / chunks,
        profiled_kernel_launches_per_chunk=(len(events) / chunks
                                            if events else None),
        kernels=sorted({e.name for e in events}),
        max_cycle=int(st.cycle.max()))


def _chunk_fn(lib):
    """The ``cycle_chunk`` entry point of a built copy of ``cycle.cu``."""
    import ctypes
    fn = lib.cycle_chunk
    fn.argtypes = [ctypes.c_void_p] * 32 + [ctypes.c_int] * 12 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build_phases(against: str | None = None) -> dict:
    """``cycle.cu`` built with its phase log (``-DCYCLE_PHASES``) and, with
    ``against``, the ``cycle.cu`` at that path as it is (an earlier
    version, timed in turns with this one); {name: CDLL}."""
    from repro_torch.kernels import _build
    jobs = {"phases": ({"cycle": _build.source("cycle.cu")},
                       ("-DCYCLE_PHASES",))}
    if against is not None:
        with open(against) as f:
            jobs["against"] = ({"cycle": f.read()}, ())
    return {name: _build.build_copies(f"cycle_{name}", srcs, flags)["cycle"]
            for name, (srcs, flags) in jobs.items()}


def _launch_on(fn, cfg, args, st, ticks: int, fast_forward: bool) -> None:
    from repro_torch.kernels import _build, cycle as kc
    lane_args = dict(zip(("prog", "modes", "geoms", "sub_ids", "local_ids",
                          "cycle0", "budget"), args))
    _build.check_launch("cycle_chunk (a built copy)", kc._launch(
        cfg, lane_args, st, ticks, fast_forward,
        torch.cuda.current_stream().cuda_stream, fn=fn))


def phase_log(lib, cfg, args, st, ticks: int, fast_forward: bool) -> dict:
    """One chunk of ``ticks`` ticks from ``st`` on the phases build ``lib``
    (``st`` updated in place): the median ns (``%globaltimer``) and SM
    cycles of each phase of a tick (:data:`PHASES`), the SM cycles of
    each stretch between its marks (:data:`STEPS`) and of the whole
    tick, over the logged lanes and ticks."""
    import ctypes
    from repro_torch.kernels import _build
    read = lib.cycle_phases
    read.argtypes = [ctypes.c_void_p]
    log = np.zeros((PHASE_LANES, PHASE_TICKS, PHASE_MARKS, 2), np.uint64)
    torch.cuda.synchronize()
    _build.check_launch("cycle_phases", read(log.ctypes.data))   # zeroes
    _launch_on(_chunk_fn(lib), cfg, args, st, ticks, fast_forward)
    torch.cuda.synchronize()
    _build.check_launch("cycle_phases", read(log.ctypes.data))
    lanes = min(st.cycle.shape[0], PHASE_LANES)
    ticks = min(ticks, PHASE_TICKS)
    ns = log[:lanes, :ticks, :, 0].astype(np.int64)
    cyc = log[:lanes, :ticks, :, 1].astype(np.int64)
    if (np.diff(ns, axis=2) < 0).any() or not ns.any():
        raise RuntimeError("phase_log: the phase log is empty or out of "
                           "order")

    def med(t, a, b):
        return float(np.median(t[..., b] - t[..., a]))

    return dict(lanes=lanes, ticks=ticks, fast_forward=fast_forward,
                phase_ns={k: med(ns, a, b) for k, (a, b) in PHASES.items()},
                phase_cycles={k: med(cyc, a, b)
                              for k, (a, b) in PHASES.items()},
                step_cycles={k: med(cyc, i, i + 1)
                             for i, k in enumerate(STEPS)},
                tick_ns=med(ns, 0, -1), tick_cycles=med(cyc, 0, -1),
                sm_ghz=float((cyc[..., -1] - cyc[..., 0]).sum()
                             / (ns[..., -1] - ns[..., 0]).sum()))


def event_ms(fn) -> float:
    """Milliseconds between CUDA events recorded around ``fn()``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def floor_ms(lanes: int, n: int, p_rows: int, ticks: int, dev,
             reps: int = 11) -> float:
    """The median CUDA-event ms of ``reps`` launches of the chunk kernel's
    barrier floor (``kernels.cycle.barrier_floor``) of ``ticks`` ticks,
    after three untimed ones."""
    from repro_torch.kernels.cycle import barrier_floor
    for _ in range(3):
        barrier_floor(lanes, n, p_rows, ticks, dev)
    return float(np.median([event_ms(lambda: barrier_floor(
        lanes, n, p_rows, ticks, dev)) for _ in range(reps)]))


def profile_phases(libs: dict, cfg, args, st0, fast_forward: bool, dev,
                   reps: int = 5) -> dict:
    """The chunk kernel on one batch: the median CUDA-event ms of ``reps``
    chunks of :data:`PHASE_TICKS` ticks from ``st0`` (a fresh copy each)
    on ``cycle_chunk`` and, when ``libs`` holds ``"against"``, on that
    build in turns (this, that, that, this, ...); the barrier floor of the
    same launch shape and ticks; the phase log of one such chunk."""
    from repro_torch.kernels.cycle import clone_state, cycle_chunk
    ticks = PHASE_TICKS
    runs = {"kernel": lambda s: cycle_chunk(cfg, *args, s, ticks=ticks,
                                            fast_forward=fast_forward)}
    if "against" in libs:
        fn = _chunk_fn(libs["against"])
        runs["against"] = lambda s: _launch_on(fn, cfg, args, s, ticks,
                                               fast_forward)
    work = clone_state(st0)
    times = {k: [] for k in runs}
    for r in range(reps):
        for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            for name in st0._fields:
                getattr(work, name).copy_(getattr(st0, name))
            times[k].append(event_ms(lambda: runs[k](work)))
    b, n = st0.cycle.shape
    ms = float(np.median(times["kernel"]))
    flo = floor_ms(b, n, int(args[0].shape[1]), ticks, dev)
    out = dict(lanes=b, pes=n, ticks=ticks, fast_forward=fast_forward,
               ms=ms, ms_all=times["kernel"], us_per_tick=ms * 1e3 / ticks,
               floor_ms=flo, floor_us_per_tick=flo * 1e3 / ticks,
               floor_share=flo / ms)
    if "against" in times:
        out.update(against_ms=float(np.median(times["against"])),
                   against_ms_all=times["against"])
    out["phases"] = phase_log(libs["phases"], cfg, args, clone_state(st0),
                              ticks, fast_forward)
    return out


def profile_chase(dev, reps: int = 2) -> dict:
    """``bench_ci``'s pointer-chase leg on both speeds (see the module
    docstring); ``reps`` timed sweeps a speed after one warm-up, in
    turns.  The engine calls are timed by
    :class:`repro_torch.bench.multidevice.EngineCalls`, their chunk
    kernels by CUDA events around each sweep's engine calls."""
    from repro_torch.bench.multidevice import EngineCalls
    from repro_torch.bench.workloads import pointer_chase_graph
    from repro_torch.core import compiler
    from repro_torch.core.sweep import SweepRequest, sweep
    from repro_torch.kernels.cycle import cycle_chunk
    cfg = machine.MachineConfig(width=8, height=8, mem_words=8192,
                                max_cycles=400_000)
    rowptr, col, src = pointer_chase_graph(512)
    req = SweepRequest(workloads=[compiler.build_bfs(rowptr, col, src,
                                                     cfg)] * 8, chunk=512)
    cfgs = {"fast_forward": cfg,
            "plain": dataclasses.replace(cfg, fast_forward=False)}
    out = {name: dict(wall_s=[], engine_s=[]) for name in cfgs}
    with EngineCalls(timed_on=[dev]) as rec:
        for c in cfgs.values():
            sweep(c, req, device=dev)
        for _ in range(reps):
            for name, c in cfgs.items():
                rec.seconds.clear()
                launched = cycle_chunk.launches
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                report = sweep(c, req, device=dev)
                torch.cuda.synchronize(dev)
                out[name]["wall_s"].append(time.perf_counter() - t0)
                out[name]["engine_s"].append(sum(rec.seconds))
                out[name]["launches"] = cycle_chunk.launches - launched
                out[name]["dead_step_fraction"] = \
                    report.telemetry.dead_step_fraction
                rec.outs.clear()
    return dict(device=torch.cuda.get_device_name(0), lanes=8, **out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fast-forward", action="store_true",
                    help="profile the chain leg's compressed and plain "
                         "ticks instead of grid A's")
    ap.add_argument("--static", action="store_true",
                    help="profile grid A's nexus lanes on the static and "
                         "on the traced engine instead")
    ap.add_argument("--kernel", action="store_true",
                    help="profile grid A and the chain on the engine chunk "
                         "kernel, beside the torch-op ticks")
    ap.add_argument("--phases", action="store_true",
                    help="with --kernel: the chunk kernel's phase log and "
                         "barrier floor (grid A, the chain, fig17's first "
                         "wave) instead of the torch-op readings")
    ap.add_argument("--against", default=None,
                    help="with --kernel --phases: a cycle.cu (an earlier "
                         "version) whose chunks are timed in turns with "
                         "this one's")
    ap.add_argument("--chase", action="store_true",
                    help="time bench_ci's pointer-chase sweep on both "
                         "speeds, the engine calls apart from the wall")
    ns = ap.parse_args(argv)
    dev = torch.device(ns.device)
    if ns.chase:
        out = profile_chase(dev)
    elif ns.kernel and ns.phases:
        libs = build_phases(ns.against)
        out = {"device": torch.cuda.get_device_name(0)}
        for name, build, ff in (
                ("grid_a", grid_a_batch, False),
                ("chain_fast_forward", chain_batch, True),
                ("chain_plain", chain_batch, False),
                ("fig17_wave", fig17_wave_batch, None)):
            cfg, args, st = build(dev)
            if ff is None:
                ff = lone_speed(args, st)
            out[name] = profile_phases(libs, cfg, args, st, ff, dev)
    elif ns.kernel:
        out = {}
        for name, build, ff in (
                ("grid_a", grid_a_batch, False),
                ("chain_fast_forward", chain_batch, True),
                ("chain_plain", chain_batch, False)):
            cfg, args, st = build(dev)
            engine = (grid_a_engine(dev) if name == "grid_a"
                      else chain_engine(dev, ff))
            out[name] = dict(
                kernel=profile_chunks(cfg, args, st, KERNEL_CHUNK,
                                      KERNEL_CHUNKS, ff, dev),
                torch_ops=profile_ticks(*engine, ns.ticks, dev))
    elif ns.static:
        out = {name: profile_ticks(
            *grid_a_engine(dev, ["nexus"], static), ns.ticks, dev)
            for name, static in (("static", True), ("traced", False))}
    elif ns.fast_forward:
        out = {f"chain_{name}": profile_ticks(
            *chain_engine(dev, ff), ns.ticks, dev)
            for name, ff in (("fast_forward", True), ("plain", False))}
    else:
        out = profile_ticks(*grid_a_engine(dev), ns.ticks, dev)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
