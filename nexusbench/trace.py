"""The traced run's device trace: ``torch.profiler`` over the window, read
back as device intervals on the host's clock.

The profiler's clock and ``time.monotonic_ns`` are lined up by a marker:
a short ``spin_kernel`` launched right after a synchronise at a known
host time.  The window is then cut into 2 us bins: a bin is busy when
any device operation covers it, and an idle bin is named by the host
span (:class:`nexusbench.harness.Spans`) that covers it, the most
specific winning.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time

import numpy as np

BIN_NS = 2000
#: the categories of a chrome trace's device operations
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host span names, least specific first: a later one wins a bin
#: (``pump`` is a scheduler round outside the calls it makes: the copies
#: of each slice's flags and cycles to the host, the telemetry)
PRECEDENCE = ("pump", "engine", "admit", "install", "retire", "client")
#: what the device idles under when no span covers the bin: the scheduler
#: waiting, with no lane pending or resident
OTHER = "waiting"


def start():
    """The profiler, started; None without a CUDA card."""
    import torch
    if not torch.cuda.is_available():
        return None
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def marker() -> int:
    """Launch the marker; returns the host time (ns) it was launched at."""
    import torch
    if not torch.cuda.is_available():
        return time.monotonic_ns()
    torch.cuda.synchronize()
    t = time.monotonic_ns()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return t


def _short(name: str) -> str:
    """A device operation's name without namespaces, template arguments,
    parameters or return type."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split("(")[0].strip()
    name = name.replace("(anonymous namespace)", "")
    name = re.sub(r"<.*>", "", name.split("(")[0]).strip()
    return name.split(" ")[-1].split("::")[-1][:64] or "op"


def stop(prof, marker_ns: int, t0: float, t_close: float) -> dict | None:
    """Stop the profiler; returns the device operations of the window as
    ``ops``: ``(name, start_ns, end_ns)`` on ``time.monotonic_ns``, or
    None when the trace holds no device operation."""
    if prof is None:
        return None
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS and "ts" in e and "dur" in e]
    marks = [e for e in dev if "spin_kernel" in e.get("name", "")]
    if not dev or not marks:
        return None
    off_ns = float(marks[0]["ts"]) * 1e3 - marker_ns
    lo, hi = int(t0 * 1e9), int(t_close * 1e9)
    ops = []
    for e in dev:
        if e is marks[0]:
            continue
        a = float(e["ts"]) * 1e3 - off_ns
        b = a + float(e["dur"]) * 1e3
        if b > lo and a < hi:
            ops.append((_short(e["name"]), max(int(a), lo), min(int(b), hi)))
    return dict(ops=ops, lo=lo, hi=hi)


def summarize(dev: dict, spans) -> dict:
    """Busy seconds, seconds per device operation, and idle seconds named
    by the host span that covered them, over the window."""
    lo, hi = dev["lo"], dev["hi"]
    n = max(1, (hi - lo) // BIN_NS)
    busy = np.zeros(n, bool)
    per_op: dict = {}
    for name, a, b in dev["ops"]:
        busy[(a - lo) // BIN_NS:-(-(b - lo) // BIN_NS)] = True
        per_op[name] = per_op.get(name, 0.0) + (b - a) / 1e9
    label = np.zeros(n, np.int8)
    for code, name in enumerate(PRECEDENCE, start=1):
        for s, a, b in spans:
            if s == name and b > lo and a < hi:
                label[max(0, (a - lo) // BIN_NS):(b - lo) // BIN_NS + 1] = code
    idle = np.bincount(label[~busy], minlength=len(PRECEDENCE) + 1)
    names = (OTHER,) + PRECEDENCE
    gaps = sorted(((names[i], float(idle[i]) * BIN_NS / 1e9)
                   for i in range(len(names)) if idle[i]),
                  key=lambda x: -x[1])
    ops = sorted(per_op.items(), key=lambda x: -x[1])
    return dict(busy_s=float(busy.sum()) * BIN_NS / 1e9,
                device_ops=[[k, v] for k, v in ops],
                idle_gaps=[[k, v] for k, v in gaps],
                op_s=per_op,
                op_n={k: sum(1 for o in dev["ops"] if o[0] == k)
                      for k in per_op})
