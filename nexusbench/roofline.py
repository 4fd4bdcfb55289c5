"""The chunk kernel's bytes floor and the card's peaks.

:func:`chunk_bytes` is a frozen copy of the arithmetic of the program's
``kernels/cycle.py::chunk_bytes``: the bytes a chunk of engine ticks must
move at least, counted from the states before and after the chunk.  It
takes the state as a mapping of leaf name to tensor and reads the queue
capacities from the leaves' shapes, so it imports nothing of the program.
``test_nexusbench_inputs.py`` holds it to the original.
"""
from __future__ import annotations

import json
import os

#: the leaves a tick touches a row or a word of, not the whole
QUEUES_AND_MEMORY = ("amq", "pend", "swq", "mem_val", "mem_meta")
#: the per-lane arguments of a chunk launch, in launch order
LANE_ARGS = ("prog", "modes", "geoms", "sub_ids", "local_ids", "cycle0",
             "budget")


def chunk_bytes(lane_args, before: dict, after: dict) -> int:
    """The bytes a chunk from ``before`` to ``after`` must move at least:
    the lane arguments and the per-PE leaves (``buf``, the queues' heads
    and counts, the stream's template, the counters) read once and
    written where they changed; the rows the queues popped read once and
    the rows they pushed written once; the memory words that changed
    written once."""
    def nbytes(t):
        return t.numel() * t.element_size()

    def changed(k):
        a, b = before[k], after[k]
        return int((a != b).sum()) * a.element_size()

    def ring(head, count, cap):
        h0, h1 = before[head].long(), after[head].long()
        pops = (h1 - h0).remainder(cap)
        pushes = pops + after[count].long() - before[count].long()
        return int(pops.sum()) + int(pushes.sum())

    msg_f = before["amq"].shape[-1]
    total = sum(nbytes(t) for t in lane_args)
    total += sum(nbytes(before[k]) + changed(k) for k in before
                 if k not in QUEUES_AND_MEMORY)
    rows = int((after["amq_head"] - before["amq_head"]).sum())
    rows += ring("pend_h", "pend_n", before["pend"].shape[2])
    rows += ring("swq_h", "swq_n", before["swq"].shape[2])
    return total + rows * msg_f * 4 + changed("mem_val")


def peaks(device_name: str) -> dict | None:
    """The published peaks of the card named ``device_name``
    (``peaks.json``), or None for a card the table does not hold."""
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        return json.load(f).get(device_name)
