"""One run of one cell: set-up, the measured window, the check, the line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the fabric (``MachineConfig``'s fields), the
  sweep service's settings and the guarantees the deployment gives;
* ``traffic/<traffic>.json``: the kernels and their sizes, the modes and
  meshes each is compiled for, and the clients (a closed loop);
* ``records/<config>.<traffic>.json``: every pool lane's simulated record
  (cycles, executed, en-route, hops, injected, per-PE busy and stall) as
  the JAX reference simulator gives it for the lane run alone, made once,
  offline (``PERF.md`` says how);
* ``metrics/<metric>.py``: a reader ``read(ctx)`` of one per-layer metric,
  returning a number or None when the run holds nothing to read.

The timed path is the program's ``repro_torch.serve.SweepService``: lanes
compiled by the program's compiler are submitted by ``clients`` clients,
each keeping one lane outstanding and submitting the next lane of a
fixed order the moment its last one returns.  A lane's latency runs from
its ``submit`` to its future's result.  Once the window closes every lane
is waited for (a minute at most), each answer is judged against
:mod:`nexusbench.reference` and each simulated record against the
records file.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import queue
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np

from nexusbench import inputs, reference

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: the top-level modules no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
#: seconds a lane may come back after the window closes
GRACE_S = 60.0


def load_json(kind: str, name: str, base: str = HERE) -> dict:
    with open(os.path.join(base, kind, name + ".json")) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def reader(name: str, base: str = HERE):
    """The ``read`` function of per-layer metric ``name``
    (``metrics/<name>.py``)."""
    path = os.path.join(base, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "nexusbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    chips: int


def cell(name: str, bench: dict | None = None, base: str = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration and
    traffic files (under ``base``) loaded, and the metrics it reports."""
    bench = bench or load_benchmark()
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def mine(ms):
        return [m for m in ms if name in m.get("workloads", [name])]
    return Cell(name=name, config=load_json("configs", wl["config"], base),
                traffic=load_json("traffic", wl["traffic"], base),
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]), chips=int(wl["chips"]))


# ---------------------------------------------------------------------------
# the program: its config, its compiler, its service
# ---------------------------------------------------------------------------

def machine_config(conf: dict):
    from repro_torch.core.machine import MachineConfig
    return MachineConfig(**conf["fabric"])


def compile_lane(kind: str, inp: dict, cfg, strategy: str):
    """One lane compiled by the program's compiler."""
    from repro_torch.core import compiler as c
    s = dict(strategy=strategy)
    if kind == "spmspm":
        return c.build_spmspm(inp["a"], inp["b"], cfg, **s)
    if kind == "spmadd":
        return c.build_spmadd(inp["a"], inp["b"], cfg, **s)
    if kind == "matmul":
        return c.build_matmul(inp["a"], inp["b"], cfg, **s)
    if kind == "spmv":
        return c.build_spmv(inp["a"], inp["x"], cfg, **s)
    if kind == "mv":
        return c.build_mv(inp["a"], inp["x"], cfg, **s)
    if kind == "sddmm":
        return c.build_sddmm(inp["a"], inp["b"], inp["mask"], cfg, **s)
    if kind == "conv":
        return c.build_conv(inp["x"], inp["w"], cfg, **s)
    if kind == "bfs":
        return c.build_bfs(inp["rowptr"], inp["col"], 0, cfg, **s)
    if kind == "sssp":
        return c.build_sssp(inp["rowptr"], inp["col"], inp["weight"], 0, cfg,
                            **s)
    if kind == "pagerank":
        return c.build_pagerank(inp["rowptr"], inp["col"], inp["rank"], cfg,
                                **s)
    raise ValueError(f"unknown kernel kind {kind!r}")


@dataclasses.dataclass
class PoolLane:
    """One lane of a cell's pool: a kernel's inputs compiled for one mesh
    and placement, run under one mode."""
    name: str
    kind: str
    kernel: int          # index into the traffic file's kernels
    mode: str
    mesh: tuple          # (width, height)
    strategy: str        # the placement
    wl: object = None    # the compiled workload


def pool_lanes(traffic: dict) -> list[PoolLane]:
    """The pool's lanes in order (every mode, then every mesh, then every
    kernel), not yet compiled."""
    spec = traffic["pool"]
    return [PoolLane(f"{k['name']}/{mode}@{w}x{h}", k["kind"], i, mode,
                     (w, h), spec["placement"][mode])
            for mode in spec["modes"] for w, h in spec["meshes"]
            for i, k in enumerate(traffic["kernels"])]


def build_pool(traffic: dict, conf: dict, seed: int):
    """``(inputs, pool)``: every kernel's inputs for ``seed``, and the
    pool's lanes compiled by the program (modes sharing a placement share
    the compiled lane)."""
    base = machine_config(conf)
    inps = inputs.draw_traffic(traffic, seed)
    pool, built = pool_lanes(traffic), {}
    for p in pool:
        key = (p.kernel, p.strategy, p.mesh)
        if key not in built:
            cfg = dataclasses.replace(base, width=p.mesh[0],
                                      height=p.mesh[1])
            built[key] = compile_lane(p.kind, inps[p.kernel], cfg,
                                      p.strategy)
        p.wl = built[key]
    return inps, pool


def load_records(config: str, traffic: str, conf: dict,
                 base: str = HERE) -> dict:
    """The reference simulator's record of every pool lane, keyed by the
    lane's name; refuses a file made for another fabric."""
    with open(os.path.join(base, "records", f"{config}.{traffic}.json")) as f:
        table = json.load(f)
    if table["fabric"] != conf["fabric"]:
        raise ValueError(f"records/{config}.{traffic}.json was made for "
                         f"{table['fabric']}, not {conf['fabric']}")
    return table["lanes"]


def order(traffic: dict, n_pool: int):
    """The pool lanes the clients submit, in turn, without end: whole
    passes over the pool, pass ``k`` in an order drawn from the traffic's
    ``pattern_seed`` and ``k``.  Every seed submits the same lanes in the
    same order, on its own values."""
    k = 0
    while True:
        rng = np.random.default_rng([traffic["pattern_seed"], 2, k])
        yield from (int(i) for i in rng.permutation(n_pool))
        k += 1


# ---------------------------------------------------------------------------
# spans (the traced run) and the per-launch samples of the chunk kernel
# ---------------------------------------------------------------------------

class Spans:
    """Host spans ``(name, t0_ns, t1_ns)`` on ``time.monotonic_ns``, kept
    in memory; :meth:`wrap` puts one around every call of a method."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []
        self._lock = threading.Lock()

    def wrap(self, obj, attr: str, name: str) -> None:
        fn = getattr(obj, attr)

        def spanned(*a, **k):
            t0 = time.monotonic_ns()
            try:
                return fn(*a, **k)
            finally:
                self.add(name, t0)
        setattr(obj, attr, spanned)

    def add(self, name: str, t0: int) -> None:
        """A span from ``t0`` to now."""
        with self._lock:
            self.items.append((name, t0, time.monotonic_ns()))


class LaunchSampler:
    """Wraps the program's chunk kernel entry (``kernels.cycle.cycle_chunk``)
    in a traced run: CUDA events around every launch, and for every
    ``stride``-th launch, up to ``limit``, copies of the state before and
    after it, for the bytes floor."""

    def __init__(self, stride: int, limit: int):
        from repro_torch.kernels import cycle
        self.mod, self.orig = cycle, cycle.cycle_chunk
        self.stride, self.limit = stride, limit
        self.events: list = []      # (start, end) CUDA events
        self.samples: list = []     # (lane_args, before, after, i)
        self.n = 0
        self.on = False

    def __enter__(self):
        import torch

        def sampled(cfg, prog, modes, geoms, sub_ids, local_ids, cycle0,
                    budget, st, *, ticks, fast_forward):
            if not self.on:
                return self.orig(cfg, prog, modes, geoms, sub_ids, local_ids,
                                 cycle0, budget, st, ticks=ticks,
                                 fast_forward=fast_forward)
            cuda = st.cycle.is_cuda
            take = (cuda and self.n % self.stride == 0
                    and len(self.samples) < self.limit)
            if take:
                before = {k: v.clone() for k, v in st._asdict().items()}
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            out = self.orig(cfg, prog, modes, geoms, sub_ids, local_ids,
                            cycle0, budget, st, ticks=ticks,
                            fast_forward=fast_forward)
            if cuda:
                e1.record()
                self.events.append((e0, e1))
            if take:
                after = {k: v.clone() for k, v in out._asdict().items()}
                self.samples.append(((prog, modes, geoms, sub_ids, local_ids,
                                      cycle0, budget), before, after,
                                     len(self.events) - 1))
            self.n += 1
            return out
        # the entry counts its launches on the module's ``cycle_chunk``
        sampled.launches = self.orig.launches
        self.mod.cycle_chunk = sampled
        return self

    def __exit__(self, *exc):
        self.orig.launches = self.mod.cycle_chunk.launches
        self.mod.cycle_chunk = self.orig

    def times_s(self) -> list[float]:
        return [a.elapsed_time(b) / 1e3 for a, b in self.events]


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Lane:
    pick: int
    sent: float = math.nan
    done: float = math.nan
    future: object = None


def _wait(lanes, until: float) -> None:
    for ln in lanes:
        left = until - time.monotonic()
        if left <= 0:
            return
        try:
            ln.future.result(timeout=left)
        except Exception:   # judged below: a failed future is a lost lane
            pass


@dataclasses.dataclass
class Seen:
    """What the check reads of one lane that came back: whether it reached
    idle, its answer and its simulated record."""
    completed: bool
    answer: object
    record: dict


def record(res) -> dict:
    """A lane's simulated record, in the records file's form."""
    return dict(completed=bool(res.completed), cycles=int(res.cycles),
                executed=int(res.executed), enroute=int(res.enroute),
                hops=int(res.hops), injected=int(res.injected),
                per_pe_busy=np.asarray(res.per_pe_busy).astype(int).tolist(),
                stall_per_pe_port=np.asarray(res.stall_per_port)
                .astype(int).tolist())


def seen(p: PoolLane, res) -> Seen:
    """What the check reads of the program's result ``res`` of lane
    ``p``: the answer through the compiled lane's own ``read_result``."""
    return Seen(bool(res.completed), p.wl.read_result(res.mem_val),
                record(res))


def judge(pool, inps, records: dict, lanes) -> tuple[dict, list]:
    """The numbers ``correct`` compares, each ``(value, limit)``, and
    whether each lane passed.  ``lanes`` is ``[(pick, Seen or None)]``,
    None for a lane that never came back or came back failed.

    ``lost``: lanes that never came back or came back failed.
    ``incomplete``: lanes back without reaching idle.  ``wrong``: lanes
    whose answer differs from :mod:`nexusbench.reference`'s.
    ``bad_record``: lanes whose simulated record (cycles, executed,
    en-route, hops, injected, per-PE busy and stall) differs from the
    reference simulator's record of the same pool lane run alone."""
    want = {}
    lost = incomplete = wrong = bad_record = 0
    ok = []
    for pick, s in lanes:
        if s is None:
            lost += 1
            ok.append(False)
            continue
        p = pool[pick]
        if pick not in want:
            want[pick] = reference.answer(p.kind, inps[p.kernel])
        good = True
        if not s.completed:
            incomplete += 1
            good = False
        if not reference.same(s.answer, want[pick]):
            wrong += 1
            good = False
        if s.record != records.get(p.name):
            bad_record += 1
            good = False
        ok.append(good)
    compared = dict(lost=(lost, 0), incomplete=(incomplete, 0),
                    wrong=(wrong, 0), bad_record=(bad_record, 0))
    return compared, ok


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _failed(exc: Exception) -> Future:
    f = Future()
    f.set_exception(exc)
    return f


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        t_process: float, device: str = "cuda", grace_s: float = GRACE_S,
        bench: dict | None = None, base: str = HERE,
        on_window=None) -> dict:
    """One run of ``cell_name``; returns the result line as a dict.
    ``device="cpu"`` runs the program's plain engine, and ``base`` names
    another folder of configs, traffic, records and metrics, and
    ``on_window`` is called once set-up is done, just before the window
    (tests only)."""
    import torch
    from repro_torch.serve import SweepService

    bench = bench or load_benchmark()
    c = cell(cell_name, bench, base)
    wl_entry = next(w for w in bench["workloads"] if w["name"] == cell_name)
    conf, traffic = c.config, c.traffic
    records = load_records(wl_entry["config"], wl_entry["traffic"], conf,
                           base)
    svc_conf = conf["service"]
    cuda = device != "cpu"
    if cuda:
        dev = torch.device(device)
        if dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    # --- set-up: the pool from the seed, the service, one warm pass ----
    inps, pool = build_pool(traffic, conf, seed)
    svc = SweepService(
        machine_config(conf), template=[p.wl for p in pool],
        super_geom=svc_conf.get("super_geom"),
        n_supers=svc_conf["n_supers"],
        slots_per_super=svc_conf.get("slots_per_super"),
        chunk=svc_conf["chunk"], slice_chunks=svc_conf["slice_chunks"],
        device=dev if cuda else device)
    futs = [svc.submit(p.wl, mode=p.mode) for p in pool]
    warm = [(i, seen(pool[i], f.result(timeout=600)))
            for i, f in enumerate(futs)]
    picks = order(traffic, len(pool))
    n_clients = int(traffic["clients"]["count"])

    spans = sampler = prof = None
    if trace:
        spans = Spans()
        for attr, name in (("_pump", "pump"), ("_admit", "admit"),
                           ("_install_lanes", "install"),
                           ("_run_slice", "engine"), ("_retire", "retire")):
            spans.wrap(svc, attr, name)
        sampler = LaunchSampler(stride=64, limit=24).__enter__()
        from nexusbench import trace as tr
        prof = tr.start()
    stats0 = dict(svc.stats)
    if cuda:
        torch.cuda.synchronize()
    marker = None
    if trace:
        marker = tr.marker()
        sampler.on = True

    if on_window is not None:
        on_window(svc)

    # --- the window: a closed loop of n_clients clients ------------------
    lanes: list[Lane] = []
    back: queue.Queue = queue.Queue()

    def returned(f, ln):
        ln.done = time.monotonic()
        back.put(ln)

    def submit() -> None:
        if trace:
            t_ns = time.monotonic_ns()
        ln = Lane(next(picks))
        p = pool[ln.pick]
        ln.sent = time.monotonic()
        try:
            ln.future = svc.submit(p.wl, mode=p.mode)
        except Exception as e:      # a service that refuses is judged lost
            ln.future = _failed(e)
        lanes.append(ln)
        if trace:
            spans.add("client", t_ns)
        ln.future.add_done_callback(lambda f, ln=ln: returned(f, ln))

    t0 = time.monotonic()
    setup_s = t0 - t_process
    t_end = t0 + seconds
    for _ in range(n_clients):
        submit()
    while True:
        left = t_end - time.monotonic()
        if left <= 0:
            break
        try:
            back.get(timeout=left)
        except queue.Empty:
            break
        if time.monotonic() < t_end:
            submit()
    t_close = time.monotonic()
    stats1 = dict(svc.stats)
    window_s = t_close - t0
    trace_out = trace_dev = None
    if trace:
        sampler.on = False
        if cuda:
            torch.cuda.synchronize()
        trace_dev = tr.stop(prof, marker, t0, t_close)
    _wait(lanes, t_close + grace_s)
    if trace and trace_dev is not None:
        trace_out = tr.summarize(trace_dev, spans.items)
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    if all(ln.future.done() for ln in lanes):
        svc.shutdown(wait=True)
    else:   # a wedged engine never returns: stop waiting for it
        stop = threading.Thread(target=svc.shutdown, kwargs=dict(wait=False),
                                daemon=True)
        stop.start()
        stop.join(10.0)

    # --- the check, once the service and its state are gone ---------------
    del svc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    window = [(ln.pick, seen(pool[ln.pick], ln.future.result())
               if ln.future.done() and ln.future.exception() is None
               else None) for ln in lanes]
    compared, ok = judge(pool, inps, records, warm + window)
    ok = ok[len(warm):]
    good = [ln for ln, g in zip(lanes, ok) if g]
    in_window = [ln for ln in good if ln.done <= t_close]
    e2e = dict(setup_s=setup_s, lanes_per_s=len(in_window) / window_s)
    metrics = {}
    if not trace:
        for m in c.end_to_end:
            metrics[m["name"]] = dict(value=e2e[m["name"]], unit=m["unit"])
    device_info = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
        count=c.chips, memory_peak_bytes=peak)
    breakdown = None
    if trace:
        ctx = dict(
            window_s=window_s, stats0=stats0, stats1=stats1,
            chunk=svc_conf["chunk"], lanes=lanes, good=good,
            in_window=in_window, t0=t0, t_close=t_close,
            device_name=device_info["kind"], trace=trace_out,
            launch_s=sampler.times_s() if cuda else [],
            samples=sampler.samples, spans=spans.items)
        from nexusbench.roofline import chunk_bytes
        ctx["sample_bytes"] = [chunk_bytes(a, b, c_) for a, b, c_, _ in
                               sampler.samples]
        ctx["sample_idx"] = [i for *_, i in sampler.samples]
        sampler.__exit__()
        del ctx["samples"]
        sampler.samples.clear()
        for m in c.per_layer:
            v = reader(m["name"], base)(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        busy = trace_out["busy_s"] if trace_out else None
        if not busy:   # no device events in the profile: the CUDA events
            busy = float(sum(ctx["launch_s"]))
        device_info.update(busy_s=busy, window_s=window_s)
        if trace_out:
            breakdown = dict(device_ops=trace_out["device_ops"][:10],
                             idle_gaps=trace_out["idle_gaps"][:10])
    correct = all(v <= lim for v, lim in compared.values())
    out = dict(correct=bool(correct), attempted=len(lanes),
               failed=int(len(ok) - sum(ok)), metrics=metrics,
               device=device_info)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {k: dict(value=v, limit=lim)
                       for k, (v, lim) in compared.items()}
    return out
