"""The chunk kernel's device time a tick: the device seconds of its
launches in the window (``cycle_kernel`` in the trace; the CUDA events
around each launch where the trace holds none) over their ticks, in us."""


def read(ctx):
    tr = ctx["trace"]
    if tr and tr["op_n"].get("cycle_kernel"):
        s, n = tr["op_s"]["cycle_kernel"], tr["op_n"]["cycle_kernel"]
    else:
        s, n = sum(ctx["launch_s"]), len(ctx["launch_s"])
    return s / (n * ctx["chunk"]) * 1e6 if n else None
