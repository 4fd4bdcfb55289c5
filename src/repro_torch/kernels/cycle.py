"""The simulator's engine chunk: ``ticks`` engine ticks in one launch.

Replaces no Pallas kernel: the reference runs the simulator as XLA ops,
and this is the device counterpart of the ``lax.scan`` chunk of its
``_get_engine.engine_fn`` (``src/repro/core/machine.py:1314-1390``).  On
CUDA tensors :func:`cycle_chunk` launches the hand-written kernel
``csrc/cycle.cu`` (one CTA per lane, two threads a PE up to 128 PEs and
one past them, every tick of the chunk inside the launch); on CPU
tensors it runs :func:`cycle_chunk_plain`, the same ticks as the port's
torch ops
(``machine._step``, and on a compressed chunk the fast-forward after
each tick).  Both give the same bits in every int32 leaf.  The kernel's
bound and design are noted in the CUDA source's header.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import machine
from repro_torch.core.am import CFG_F, MSG_F
from repro_torch.kernels import _build

#: the largest PE axis the kernel takes (one thread a PE in one CTA past
#: 128 PEs); ``csrc/cycle.cu``'s ``MAX_PES``
MAX_PES = 1024
#: the leaves the cycle only reads (returned as they are)
READ_ONLY = ("amq", "amq_len", "mem_meta")


@functools.lru_cache(maxsize=None)
def _plain_fns(cfg: machine.MachineConfig, n: int):
    """The torch-op cycle of ``cfg`` over ``n`` PEs and its fast-forward,
    built once per (config, PE axis)."""
    from repro_torch.core.fastforward import make_fast_forward
    return machine._make_cycle(cfg, n), make_fast_forward(cfg, n)


def cycle_chunk_plain(cfg, prog, modes, geoms, sub_ids, local_ids, cycle0,
                      budget, st: machine.MachineState, *, ticks: int,
                      fast_forward: bool) -> machine.MachineState:
    """The plain PyTorch version: ``ticks`` calls of ``machine._step``,
    with the fast-forward after each tick when ``fast_forward``.  Updates
    ``pend``, ``swq`` and ``mem_val`` in place and returns new tensors for
    the other leaves, as the cycle does."""
    cyc, ffwd = _plain_fns(cfg, int(st.cycle.shape[1]))
    use = ffwd if fast_forward else None
    for _ in range(ticks):
        st = machine._step(cyc, cfg, prog, modes, geoms, sub_ids, local_ids,
                           cycle0, budget, st, use)
    return st


def _check(cfg, lane_args: dict, st: machine.MachineState) -> None:
    if not (cfg.traced_modes and cfg.traced_geometry):
        raise ValueError("cycle_chunk runs the traced engine; the static "
                         "golden engines run cycle_chunk_plain")
    b, n = st.cycle.shape
    if not 1 <= n <= MAX_PES:
        raise ValueError(f"cycle_chunk takes 1 to {MAX_PES} PEs a lane, "
                         f"not {n}")
    dev = st.cycle.device
    want = dict(
        prog=(b, *lane_args["prog"].shape[1:2], CFG_F), modes=(b,),
        geoms=(b, 2), sub_ids=(b, n),
        local_ids=(b, n), cycle0=(b, n), budget=(b, n),
        buf=(b, n, machine.PORTS, machine.DEPTH, MSG_F),
        buf_n=(b, n, machine.PORTS), amq=(b, n, st.amq.shape[2], MSG_F),
        pend=(b, n, machine.PEND_CAP, MSG_F),
        mem_val=(b, n, st.mem_val.shape[2]),
        mem_meta=(b, n, st.mem_val.shape[2], 2), stream_msg=(b, n, MSG_F),
        swq=(b, n, cfg.stream_wait_cap, MSG_F),
        st_stall=(b, n, machine.PORTS))
    tensors = dict(lane_args, **st._asdict())
    for name, t in tensors.items():
        dtype = torch.bool if name == "stream_on" else torch.int32
        shape = want.get(name, (b, n))
        if t.dtype != dtype or t.device != dev or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"cycle_chunk: {name} must be a contiguous {dtype} tensor "
                f"of shape {shape} on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def cycle_chunk(cfg, prog, modes, geoms, sub_ids, local_ids, cycle0, budget,
                st: machine.MachineState, *, ticks: int,
                fast_forward: bool) -> machine.MachineState:
    """``ticks`` engine ticks of every lane: exactly ``ticks`` calls of
    ``machine._step(cyc, cfg, prog, modes, geoms, sub_ids, local_ids,
    cycle0, budget, st, ffwd if fast_forward else None)``.

    Args:
      cfg: the traced engine's config (``max_cycles``, ``mem_words``,
        ``stream_wait_cap``).
      prog: (B, P, CFG_F) config memory; ``modes`` (B,), ``geoms`` (B, 2);
        ``sub_ids`` / ``local_ids`` / ``cycle0`` / ``budget`` (B, N), all
        int32 on the state's device.  ``sub_ids`` lie in [0, N).
      st: the state before the chunk.
      fast_forward: run the lone-flight teleport after each tick (the
        compressed chunk).
    Returns:
      The state after the chunk.  On CUDA tensors the kernel updates every
      leaf of ``st`` but :data:`READ_ONLY` in place and returns ``st``, so
      a caller that needs the state before keeps a copy; CPU tensors run
      :func:`cycle_chunk_plain`.
    """
    dev = st.cycle.device
    if dev.type == "cpu":
        return cycle_chunk_plain(cfg, prog, modes, geoms, sub_ids, local_ids,
                                 cycle0, budget, st, ticks=ticks,
                                 fast_forward=fast_forward)
    if dev.type != "cuda":
        raise ValueError(f"no cycle_chunk for device {dev}")
    lane_args = dict(prog=prog, modes=modes, geoms=geoms, sub_ids=sub_ids,
                     local_ids=local_ids, cycle0=cycle0, budget=budget)
    _check(cfg, lane_args, st)
    b, n = st.cycle.shape
    if ticks <= 0 or b == 0:
        return st
    with torch.cuda.device(dev):
        err = _launch(cfg, lane_args, st, ticks, fast_forward,
                      torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("cycle_chunk", err)
    cycle_chunk.launches += 1
    return st


def _launch(cfg, lane_args: dict, st: machine.MachineState, ticks: int,
            fast_forward: bool, stream: int, fn=None) -> int:
    """Call the C launcher (``fn``, by default the built ``cycle_chunk``)
    on checked tensors; returns its error code."""
    b, n = st.cycle.shape
    m_words = int(st.mem_val.shape[2])
    if fn is None:
        fn = _build.bind("cycle", "cycle_chunk", 32, 12)
    ptrs = [t.data_ptr() for t in lane_args.values()] + \
        [getattr(st, k).data_ptr() for k in machine.MachineState._fields]
    return fn(*ptrs, b, n, int(lane_args["prog"].shape[1]),
              int(st.amq.shape[2]), machine.PEND_CAP, cfg.stream_wait_cap,
              m_words, min(cfg.mem_words, m_words), cfg.max_cycles,
              int(ticks), int(bool(fast_forward)), machine.STREAM_THROTTLE,
              stream)


cycle_chunk.launches = 0


def lane_threads(n: int) -> int:
    """``csrc/cycle.cu``'s threads a lane of ``n`` PEs: a pair a PE, 16 PEs
    a warp, up to 128 PEs; a thread a PE, in whole warps, past them."""
    return 32 * -(-n // 16) if n <= 128 else 32 * -(-n // 32)


def barrier_floor(lanes: int, n: int, p_rows: int, ticks: int,
                  device) -> torch.Tensor:
    """Launch ``csrc/cycle.cu``'s ``cycle_floor``: the chunk kernel's launch
    shape for ``lanes`` lanes of ``n`` PEs and a program of ``p_rows``
    rows (its grid, block and shared memory) running ``ticks`` ticks of
    its barriers and nothing else: the latency floor of a chunk.  Returns
    the (lanes, :func:`lane_threads`) int32 words it wrote.  A
    measurement, not a step of the engine: it counts no launch."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"barrier_floor times the card, not {dev}")
    if not 1 <= n <= MAX_PES:
        raise ValueError(f"barrier_floor takes 1 to {MAX_PES} PEs, not {n}")
    out = torch.empty((lanes, lane_threads(n)), dtype=torch.int32,
                      device=dev)
    fn = _build.bind("cycle", "cycle_floor", 1, 4)
    with torch.cuda.device(dev):
        err = fn(out.data_ptr(), lanes, n, p_rows, int(ticks),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("cycle_floor", err)
    return out


def clone_state(st: machine.MachineState) -> machine.MachineState:
    """A copy of every leaf (the kernel updates its state in place)."""
    return st._replace(**{k: getattr(st, k).clone() for k in st._fields})


#: the leaves a tick touches a row or a word of, not the whole
QUEUES_AND_MEMORY = ("amq", "pend", "swq", "mem_val", "mem_meta")


def chunk_bytes(cfg, lane_args, before: machine.MachineState,
                after: machine.MachineState) -> int:
    """The bytes a chunk from ``before`` to ``after`` must move at least,
    counted from this chunk's data: the lane arguments and the per-PE
    leaves (``buf``, the queues' heads and counts, the stream's template,
    the counters) read once, and written where they changed; the rows the
    queues popped (their heads' advance) read once and the rows they
    pushed written once; the memory words that changed written once.
    Words a load or a head read without changing them are not counted, so
    this is a floor, not the bytes the kernel moves."""
    def nbytes(t):
        return t.numel() * t.element_size()

    def changed(k):
        a, b = getattr(before, k), getattr(after, k)
        return int((a != b).sum()) * a.element_size()

    def ring(head, count, cap):
        h0, h1 = getattr(before, head).long(), getattr(after, head).long()
        pops = torch.remainder(h1 - h0, cap)
        pushes = pops + getattr(after, count).long() \
            - getattr(before, count).long()
        return int(pops.sum()) + int(pushes.sum())

    total = sum(nbytes(t) for t in lane_args)
    total += sum(nbytes(getattr(before, k)) + changed(k)
                 for k in machine.MachineState._fields
                 if k not in QUEUES_AND_MEMORY)
    rows = int((after.amq_head - before.amq_head).sum())
    rows += ring("pend_h", "pend_n", machine.PEND_CAP)
    rows += ring("swq_h", "swq_n", cfg.stream_wait_cap)
    return total + rows * MSG_F * 4 + changed("mem_val")


def first_difference(want: machine.MachineState,
                     got: machine.MachineState) -> str | None:
    """Where two states first differ, as text naming the leaf, the lane
    and the PE (and the index inside the PE's row); None when every leaf
    is equal bit for bit (dtype and shape included)."""
    for k in machine.MachineState._fields:
        a, b = getattr(want, k), getattr(got, k)
        if a.dtype != b.dtype or a.shape != b.shape:
            return (f"leaf {k}: {a.dtype} {tuple(a.shape)} against "
                    f"{b.dtype} {tuple(b.shape)}")
        ne = (a != b.to(a.device)).cpu()
        if bool(ne.any()):
            at = ne.nonzero()[0].tolist()
            return (f"leaf {k}, lane {at[0]}, PE {at[1]}, at {at[2:]}: "
                    f"{a[tuple(at)].item()} against {b[tuple(at)].item()} "
                    f"({int(ne.sum())} elements differ)")
    return None
