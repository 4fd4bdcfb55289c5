"""Resident sweep service: continuous batching on the ONE cached engine —
a port of the reference's ``repro.serve.fabric``, bit-identical to it.

``machine.run_many`` keeps the fabric busy *within* a call — packing,
waves — but the engine sits idle *between* calls, and a retired
sub-lane's rectangle stays dead until its wave ends.  This module closes
both gaps with LLM-serving-style continuous batching applied to fabric
simulation:

* clients :meth:`SweepService.submit` compiled workloads at any time and
  get a :class:`concurrent.futures.Future` per lane;
* a scheduler thread owns the device: it runs the cached engine in
  *slices* (a per-PE cycle budget — the same engine ``run_many`` uses,
  see ``machine._get_engine``), retires sub-lanes the moment their
  rectangle goes idle, and immediately re-packs pending lanes into the
  freed rectangles (:class:`repro_torch.core.batch.RectPool`) — mid-wave
  refill;
* machine state lives on the service's device across slices; the engine
  updates its queues and memory in place, and an install writes only the
  rows it resets;
* :meth:`SweepService.drain` / :meth:`SweepService.shutdown` give the
  graceful endgame: every future is resolved, none orphaned.

Results are bit-identical to a solo (or one-shot ``run_many``) run of
the same lane: installs reset a rectangle's rows to the exact
``init_state`` image (cycle, round-robin pointer and statistics
included), placement reuses the sub-mesh rebasing of the batch packer,
and west-first routing confines a sub-mesh's traffic to its own
rectangle — so a lane cannot observe *when* it was installed or who its
co-tenants were.

Resilience layer (every piece leans on the engine's exact budget
slicing — running budget b then b' is bit-identical to b + b', so
"resume from the resident state" is a correctness-preserving move):

* **per-lane deadlines** — ``submit(deadline_cycles=, deadline_s=)``.
  The engine's budget argument is per-PE, so a lane that exhausts its
  cycle budget freezes *exactly* at the bound while co-tenant
  rectangles keep stepping; its future fails with
  :class:`DeadlineError` carrying the frozen per-PE diagnostics
  (``.result``) and the service's engine telemetry (``.telemetry``).
  Wall-clock deadlines are best-effort (checked at slice boundaries).
* **transient retry** — exceptions raised by the ``"pre_slice"`` fault
  hook, before any device dispatch, are classified by
  :class:`RetryPolicy`; transients re-run the slice from the untouched
  resident state with capped exponential backoff.  Fatal or
  retry-exhausted errors, and any failure inside the engine (which
  updates the state in place, so a half-run slice cannot be re-run),
  escalate to ``_fail_unresolved`` (the service stays addressable:
  later ``submit`` calls raise instead of hanging).
* **kill/restart** — a :class:`SchedulerKill` (chaos injection, see
  :mod:`repro_torch.serve.chaos`) terminates the scheduler thread
  WITHOUT failing futures; the next ``submit``/``drain``/``shutdown``
  respawns it and the resumed slices are bit-exact.
* **checkpoint/restore** — ``checkpoint_root=`` snapshots the packed
  super-lane state, RectPool bookkeeping and the ticket queue at slice
  boundaries (async, step-atomic —
  :class:`repro_torch.checkpoint.CheckpointManager`, in the reference's
  on-disk layout, so either package restores the other's checkpoint);
  :meth:`SweepService.restore` resumes the in-flight lanes of a dead
  process bit-for-bit.

Every tensor lives on the service's explicit ``device`` (default
``"cuda"``): the scheduler is its own thread, and torch's current CUDA
device is per thread.  With ``shard=True`` the super-lanes split into
contiguous groups over ``devices``, each group's state on its own device,
as the reference's ``shard_map`` splits them.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Callable

import numpy as np
import torch

from repro_torch.core.am import C_NEXT_PC
from repro_torch.core.batch import (RectPool, SubLane, _rebase_into_super,
                                    bucket)
from repro_torch.core.machine import (MachineConfig, MachineState, RunResult,
                                      _get_engine, _pe_slice_result,
                                      gather_host, init_state, mode_code,
                                      resolve_mode, shard_devices,
                                      split_lanes)


class ServiceError(RuntimeError):
    """The service failed (or was shut down) before this lane finished."""


class CapacityError(ValueError):
    """A submitted workload cannot ever fit the service's arena."""


class DeadlineError(ServiceError):
    """A lane exhausted its own deadline; co-tenants were unaffected.

    ``result`` is the lane's :class:`~repro_torch.core.machine.RunResult`
    frozen exactly at the deadline (``completed=False``; per-PE busy /
    stall / hop statistics included — the runaway-lane diagnostics), or
    None when the lane never reached the fabric (a wall-clock deadline
    expiring in the pending queue).  ``telemetry`` is the service's
    :class:`~repro_torch.core.sweep.EngineTelemetry` at failure time.
    """

    def __init__(self, msg: str, *, result: RunResult | None = None,
                 telemetry=None):
        super().__init__(msg)
        self.result = result
        self.telemetry = telemetry


class TransientFault(RuntimeError):
    """An injected (or classified) transient failure of the slice region.

    The default :class:`RetryPolicy` retries exactly this type: it is
    raised by fault hooks *before* any device dispatch, so the resident
    ``MachineState`` is untouched and re-running the slice is exact.
    """


class SchedulerKill(BaseException):
    """Raised by a fault hook to kill the scheduler thread mid-slice.

    Deliberately NOT an ``Exception``: it must escape the scheduler's
    fatal-error handling (which fails every future) — a kill leaves
    futures, tickets and device state intact, and the next client call
    restarts the thread.
    """


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Transient-failure classification + capped exponential backoff.

    ``is_transient`` (default: ``isinstance(e, TransientFault)``)
    decides whether an exception of the ``"pre_slice"`` fault hook is
    worth re-running the slice for.  The hook fires before the engine
    is called, where a retry is exact.  A failure inside the engine is
    never retried, whatever the predicate says: the port's engine
    updates its input state in place, so a slice that failed part-way
    has already changed the resident state.

    Retry ``attempt`` (1-based) sleeps
    ``min(backoff_s * 2**(attempt-1), max_backoff_s)`` first.
    """
    max_retries: int = 3
    backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    is_transient: Callable[[BaseException], bool] | None = None

    def transient(self, e: BaseException) -> bool:
        if self.is_transient is not None:
            return bool(self.is_transient(e))
        return isinstance(e, TransientFault)

    def delay(self, attempt: int) -> float:
        return min(self.backoff_s * (2.0 ** max(0, attempt - 1)),
                   self.max_backoff_s)


# the compiler-output arrays a lane needs to be (re)installed; meta_pe
# is optional (None when the workload carries no PE-indexed metadata)
_WL_FIELDS = ("prog", "static_ams", "amq_len", "mem_val", "mem_meta",
              "meta_pe")

# MachineState leaves an install overwrites with the new lane's arrays;
# every other leaf is zeroed on the installed rows (the init_state image)
_PUT_LEAVES = ("amq", "amq_len", "mem_val", "mem_meta")


@dataclasses.dataclass(eq=False)
class _RestoredWorkload:
    """Array-only stand-in for a CompiledWorkload after restore.

    Checkpoints persist the compiler-output arrays, not the workload
    object (``read_result`` is a closure); everything the install path
    touches — ``_check_fits``, ``_rebase_into_super`` — duck-types off
    these fields.
    """
    prog: np.ndarray
    static_ams: np.ndarray
    amq_len: np.ndarray
    mem_val: np.ndarray
    mem_meta: np.ndarray
    geom: tuple
    name: str | None = None
    meta_pe: np.ndarray | None = None


# eq=False: tickets/residents wrap numpy-backed workloads, and the queue
# bookkeeping (list.remove) needs identity, not elementwise comparison
@dataclasses.dataclass(eq=False)
class _Ticket:
    """One submitted lane waiting for placement."""
    workload: object
    mode: int
    load: float                # longest-first admission key
    seq: int
    future: Future
    deadline_cycles: int | None = None
    deadline_s: float | None = None
    t_submit: float = 0.0      # time.monotonic() at submission


@dataclasses.dataclass(eq=False)
class _Resident:
    """One lane currently occupying a rectangle of a super-lane."""
    ticket: _Ticket
    super_idx: int
    slot: int                  # sub-lane slot id AND program-arena slot
    origin: tuple
    geom: tuple
    ids: np.ndarray            # super-mesh PE ids, lane-row-major order


def _service_device(device) -> torch.device:
    """``device`` with its CUDA index made explicit: the scheduler thread
    must not depend on the current device of whichever thread it runs
    on."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class SweepService:
    """Continuous-batching sweep service over one cached engine.

    Args:
      cfg: the shared :class:`MachineConfig`.  ``mem_words`` is widened
        to the arena's memory capacity exactly like ``run_many`` widens
        it for a batch, so the service hits the same engine-cache entry
        a blocking verification run of the same lanes would.
      template: compiled workloads that size the arena — program-slot
        rows, AM-queue depth, memory words and (by default) the
        super-lane mesh are fixed at the maxima over the template, and
        every later submission must fit within them.  The template lanes
        are NOT run — pass the same objects to :meth:`submit` if you want
        them executed.  May be None: the first submission batch then
        serves as the template.
      super_geom: mesh of each resident super-lane (default: template
        maxima, i.e. the ``run_many(pack=True)`` default).
      n_supers: resident super-lane count — the engine's batch axis.
      slots_per_super: concurrent sub-lanes per super-lane (default
        ``min(n_super_pes, 16)``); bounds the program arena.
      chunk: cycles per engine chunk.  Results are bit-identical across
        chunk sizes, but chunk keys the engine cache — match the
        blocking calls' chunk to share their engine, or pick a finer one
        to retire and refill at a finer grain.
      slice_chunks: engine chunks per scheduler slice — the refill
        latency knob: retirement and refill happen between slices, every
        ``chunk * slice_chunks`` fabric cycles.
      shard: split the super-lane axis into contiguous groups over
        ``devices``, as many as the largest divisor of ``n_supers`` no
        larger than the device count: each group's state lives on its
        own device and its engine loop stops on its own (per-shard ticks
        and telemetry, as in the reference).  With one device that is
        one group: the plain engine and one cache entry.
      fault_hook: optional ``hook(phase, service)`` called at
        ``"install"`` (before the install update), ``"pre_slice"``
        (after admission, before the engine call — the retry/kill-safe
        point) and ``"post_slice"`` (after the slice state is committed,
        before retirement).  The chaos harness
        (:class:`repro_torch.serve.chaos.FaultSchedule`) plugs in here;
        exceptions it raises at ``"pre_slice"`` are classified by
        ``retry``.  Faults at ``"install"`` are always fatal (the
        placement bookkeeping is already committed).
      retry: :class:`RetryPolicy` for ``"pre_slice"`` exceptions
        (default: retry only :class:`TransientFault`, 3 attempts, 50 ms
        capped exponential backoff).
      checkpoint_root: optional directory; when set, the service
        snapshots its full in-flight state (packed super-lane
        ``MachineState``, program arena, RectPool bookkeeping, resident
        and pending ticket queue) every ``checkpoint_every`` slices —
        async and step-atomic.  :meth:`restore` resumes from it
        bit-for-bit.
      checkpoint_every: slices between snapshots (with
        ``checkpoint_root``).
      checkpoint_keep: newest checkpoints retained.
      device: where the resident state lives and the engine runs (without
        ``shard``), and the type whose visible cards ``devices`` defaults
        to.
      devices: the devices ``shard=True`` splits the super-lanes over, in
        shard order (default: every visible card of ``device``'s type);
        a device may repeat (``[cpu] * 4``, ``[cuda:0] * 2``).  A device
        that does not exist raises :class:`ValueError` here.

    Thread model: ``submit`` / ``drain`` / ``shutdown`` are safe from
    any thread; ALL device work happens on the single scheduler thread
    (and, with a template, in the constructor).
    """

    def __init__(self, cfg: MachineConfig, *, template=None,
                 super_geom=None, n_supers: int = 2,
                 slots_per_super: int | None = None, chunk: int = 512,
                 slice_chunks: int = 2, shard: bool = False,
                 fault_hook: Callable[[str, "SweepService"], None]
                 | None = None,
                 retry: RetryPolicy | None = None,
                 checkpoint_root: str | None = None,
                 checkpoint_every: int = 8, checkpoint_keep: int = 3,
                 device="cuda", devices=None):
        if not (cfg.traced_modes and cfg.traced_geometry):
            raise ValueError("SweepService needs the traced engine axes "
                             "(cfg.traced_modes and cfg.traced_geometry)")
        if n_supers < 1 or chunk < 1 or slice_chunks < 1:
            raise ValueError("n_supers, chunk and slice_chunks must be >= 1")
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        self._base_cfg = cfg
        self._device = _service_device(device)
        self._req_super_geom = super_geom
        self._n_supers = int(n_supers)
        self._req_slots = slots_per_super
        self._chunk = int(chunk)
        self._slice_chunks = int(slice_chunks)
        self._shard = bool(shard)
        self._shard_devs = (shard_devices(self._device, devices)
                            if self._shard else None)
        self._fault_hook = fault_hook
        self._retry = retry if retry is not None else RetryPolicy()

        self._cond = threading.Condition()
        self._pending: list[_Ticket] = []
        self._residents: dict[tuple[int, int], _Resident] = {}
        self._scrub: list[tuple[int, np.ndarray]] = []  # (super, pe ids)
        self._closing = False
        self._killed = False
        self._abort: Exception | None = None
        self._seq = 0
        self._built = False
        self.stats = dict(n_installs=0, n_refills=0, n_retired=0,
                          n_slices=0, occupancy_sum=0.0, engine_ticks=0,
                          n_retries=0, n_restarts=0, n_deadline_failures=0,
                          n_checkpoints=0, stepped_pe_ticks=0,
                          plain_pe_ticks=0)

        self._ckpt = None
        self._ckpt_every = int(checkpoint_every)
        self._ckpt_step = 0
        if checkpoint_root is not None:
            from repro_torch.checkpoint import CheckpointManager
            self._ckpt = CheckpointManager(checkpoint_root,
                                           keep=checkpoint_keep)

        if template is not None:
            self._build_arena(list(template))
        self._thread = threading.Thread(
            target=self._serve_loop, name="sweep-service", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    # client surface
    # ------------------------------------------------------------------
    def submit(self, workload, *, mode=None, cycle_hint=None,
               deadline_cycles: int | None = None,
               deadline_s: float | None = None) -> "Future[RunResult]":
        """Queue one compiled workload; returns a Future of its
        :class:`RunResult` (bit-identical to a solo run).

        ``mode`` is a :data:`repro_torch.core.machine.FABRIC_MODES` name
        or bitmask (default: ``cfg``'s flags).  Only same-mode lanes
        co-tenant a super-lane, exactly like ``run_many(pack=True)``.
        ``cycle_hint`` (measured cycles from a prior run) overrides the
        static cost model (:func:`repro_torch.analysis.estimate_cycles`)
        in the longest-first admission order.

        ``deadline_cycles`` bounds the lane's SIMULATED cycles: a lane
        still running at the bound makes no state transition past it
        (the per-PE engine budget freezes it exactly there, bit-identical
        to ``run_many(deadlines=[...])``) and its future fails with
        :class:`DeadlineError` carrying the frozen per-PE diagnostics
        and the service telemetry — co-tenant rectangles keep stepping.
        ``deadline_s`` bounds WALL-clock time since submission,
        best-effort at slice boundaries (pending lanes included).

        The workload is statically verified before it is queued
        (:func:`repro_torch.analysis.check_workload`): a lane with
        error-severity findings gets a Future already failed with
        :class:`~repro_torch.analysis.WorkloadValidationError` —
        co-tenants and the service itself are unaffected.
        """
        m = mode_code(self._base_cfg) if mode is None else resolve_mode(mode)
        geom = getattr(workload, "geom", None)
        if geom is None:
            raise ValueError("submit() needs a compiled workload "
                             "(repro_torch.core.compiler records wl.geom)")
        if deadline_cycles is not None:
            deadline_cycles = int(deadline_cycles)
            if deadline_cycles < 1:
                raise ValueError("deadline_cycles must be a positive cycle "
                                 f"count, got {deadline_cycles}")
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            if deadline_s <= 0:
                raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        fut: Future = Future()
        from repro_torch.analysis import (WorkloadValidationError,
                                          check_workload, error_findings,
                                          estimate_cycles)
        errs = error_findings(check_workload(
            workload, stream_wait_cap=self._base_cfg.stream_wait_cap))
        if errs:
            # The bad lane fails its OWN future; nothing is enqueued, so
            # the service and every co-tenant stay healthy.
            fut.set_exception(WorkloadValidationError(
                errs, context="submit() rejected the workload"))
            return fut
        if self._built:
            self._check_fits(workload, geom)
        w, h = int(geom[0]), int(geom[1])
        if cycle_hint is not None:
            load = float(cycle_hint)
        else:
            try:
                load = estimate_cycles(workload)
            except Exception:
                load = 1.0 / float(w * h)   # last-resort area proxy
        with self._cond:
            if self._closing:
                raise ServiceError(
                    "sweep service is shut down" if self._abort is None
                    else f"sweep service failed: {self._abort}")
            self._pending.append(_Ticket(
                workload=workload, mode=m, load=load, seq=self._seq,
                future=fut, deadline_cycles=deadline_cycles,
                deadline_s=deadline_s, t_submit=time.monotonic()))
            self._seq += 1
            self._ensure_scheduler_locked()
            self._cond.notify_all()
        return fut

    def map(self, workloads, *, modes=None) -> list["Future[RunResult]"]:
        """Submit a batch; returns futures in input order."""
        wls = list(workloads)
        ms = [None] * len(wls) if modes is None else list(modes)
        if len(ms) != len(wls):
            raise ValueError(f"{len(ms)} modes for {len(wls)} workloads")
        return [self.submit(w, mode=m) for w, m in zip(wls, ms)]

    def drain(self, timeout: float | None = None) -> None:
        """Block until every lane submitted so far is resolved.

        Restarts a chaos-killed scheduler thread if needed (the in-flight
        lanes resume bit-exactly).  On timeout the :class:`TimeoutError`
        carries diagnostics: pending/resident lane counts, the oldest
        ticket's age and the current :attr:`refill_occupancy`.
        """
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        with self._cond:
            while True:
                if self._abort is not None:
                    raise ServiceError(
                        f"sweep service failed: {self._abort}")
                if not self._pending and not self._residents:
                    return
                self._ensure_scheduler_locked()
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    raise TimeoutError(self._drain_diagnostics())
                # bounded waits so a dead scheduler is detected (and
                # restarted) even when nothing ever notifies again
                self._cond.wait(timeout=0.1 if left is None
                                else min(0.1, left))

    def shutdown(self, wait: bool = True) -> None:
        """Stop the service.  ``wait=True`` drains first; ``wait=False``
        fails every unresolved future with :class:`ServiceError`."""
        with self._cond:
            self._closing = True
            if not wait and self._abort is None:
                self._abort = ServiceError("service shut down before the "
                                           "lane completed")
            # a killed scheduler must be revived even for shutdown: the
            # restarted loop drains (wait=True) or fails the unresolved
            # futures (wait=False) — either way join() below terminates
            self._ensure_scheduler_locked()
            self._cond.notify_all()
        self._thread.join()
        if self._ckpt is not None:
            # flush the async writer: a checkpoint listed after shutdown
            # must be fully committed (and pruning finished)
            self._ckpt.wait()

    def __enter__(self) -> "SweepService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(wait=exc_type is None)

    @property
    def refill_occupancy(self) -> float:
        """Mean fraction of stepped PE rows carrying live work, over all
        engine slices so far — the mid-wave-refill figure of merit (a
        blocking packed wave's equivalent is its packing efficiency)."""
        n = self.stats["n_slices"]
        return self.stats["occupancy_sum"] / n if n else 0.0

    @property
    def telemetry(self):
        """Service-lifetime :class:`~repro_torch.core.sweep.EngineTelemetry`
        (dead-step accounting across every slice so far)."""
        from repro_torch.core.sweep import EngineTelemetry
        return EngineTelemetry(
            stepped_pe_ticks=int(self.stats["stepped_pe_ticks"]),
            plain_pe_ticks=int(self.stats["plain_pe_ticks"]),
            engine_calls=int(self.stats["n_slices"]))

    @property
    def futures(self) -> dict[int, Future]:
        """Unresolved lanes keyed by submission sequence number.

        The client-facing handle after :meth:`restore`: a restored
        service hands out FRESH futures here (the originals died with
        the old process); sequence numbers are stable across the
        checkpoint, in submission order.
        """
        with self._cond:
            out = {t.seq: t.future for t in self._pending}
            out.update({r.ticket.seq: r.ticket.future
                        for r in self._residents.values()})
        return out

    # ------------------------------------------------------------------
    # arena
    # ------------------------------------------------------------------
    def _check_fits(self, wl, geom) -> None:
        w, h = int(geom[0]), int(geom[1])
        sw, sh = self._super_geom
        if w > sw or h > sh:
            raise CapacityError(f"{w}x{h} lane exceeds the {sw}x{sh} "
                                f"service super-mesh")
        if wl.prog.shape[0] > self._p_slot:
            raise CapacityError(f"{wl.prog.shape[0]} program rows exceed "
                                f"the {self._p_slot}-row arena slot")
        if wl.static_ams.shape[1] > self._q_cap:
            raise CapacityError(f"AM-queue depth {wl.static_ams.shape[1]} "
                                f"exceeds the arena's {self._q_cap}")
        if wl.mem_val.shape[1] > self._m_cap:
            raise CapacityError(f"{wl.mem_val.shape[1]} memory words "
                                f"exceed the arena's {self._m_cap}")

    def _build_arena(self, wls) -> None:
        """Fix every engine shape from the template lanes and fetch the
        ONE cached engine; all later traffic reuses it."""
        if not wls:
            raise ValueError("empty template")
        geoms = [getattr(w, "geom", None) for w in wls]
        if any(g is None for g in geoms):
            raise ValueError("template needs compiled workloads "
                             "(with wl.geom)")
        sg = self._req_super_geom
        if sg is None:
            sg = (max(int(g[0]) for g in geoms),
                  max(int(g[1]) for g in geoms))
        self._setup_arena(
            (int(sg[0]), int(sg[1])),
            bucket(max(w.prog.shape[0] for w in wls)),
            (min(int(sg[0]) * int(sg[1]), 16) if self._req_slots is None
             else int(self._req_slots)),
            max(w.static_ams.shape[1] for w in wls),
            max(max(w.mem_val.shape[1] for w in wls),
                self._base_cfg.mem_words),
            wls[0].static_ams.shape[2],
            wls[0].prog.shape[1])

    def _setup_arena(self, super_geom: tuple, p_slot: int, n_slots: int,
                     q_cap: int, m_cap: int, msg_f: int, cfg_f: int
                     ) -> None:
        """Materialize the arena for explicit dimensions (the template
        path computes them from lane maxima; :meth:`restore` replays the
        checkpointed ones, so the engine runs identical shapes)."""
        self._super_geom = (int(super_geom[0]), int(super_geom[1]))
        sw, sh = self._super_geom
        n = sw * sh                                   # PE axis per super
        b = self._n_supers
        self._p_slot = int(p_slot)
        self._n_slots = int(n_slots)
        if not 1 <= self._n_slots <= n:
            raise ValueError(f"slots_per_super must be in [1, {n}]")
        self._q_cap = int(q_cap)
        self._m_cap = int(m_cap)
        cfg = self._base_cfg
        if self._m_cap > cfg.mem_words:
            cfg = dataclasses.replace(cfg, mem_words=self._m_cap)
        self._cfg = cfg

        n_dev = 1
        devs = [self._device]
        if self._shard:
            n_avail = min(len(self._shard_devs), b)
            n_dev = max(d for d in range(1, n_avail + 1) if b % d == 0)
            devs = self._shard_devs[:n_dev]
        self._n_dev = n_dev
        # shard s holds super-lanes groups[s] on devs[s]
        self._devs = devs
        per = b // n_dev
        self._groups = [slice(s * per, (s + 1) * per) for s in range(n_dev)]
        self._engine = _get_engine(cfg, self._chunk, n_max=n,
                                   n_devices=n_dev, devices=devs)

        # host arrays, as the reference keeps them; their device copies
        # are uploaded only after an install changes them
        self._prog = np.zeros((b, self._n_slots * self._p_slot, cfg_f),
                              np.int32)
        self._modes = np.zeros((b,), np.int32)
        self._geoms = np.tile(np.array([[sw, sh]], np.int32), (b, 1))
        self._sub_ids = np.zeros((b, n), np.int32)
        self._local_ids = np.tile(np.arange(n, dtype=np.int32), (b, 1))
        self._mirrors = None
        # one MachineState per shard, on the shard's device
        self._st = [init_state(
            cfg, np.zeros((per, n, self._q_cap, msg_f), np.int32),
            np.zeros((per, n), np.int32),
            np.zeros((per, n, self._m_cap), np.int32),
            np.zeros((per, n, self._m_cap, 2), np.int32),
            device=dev) for dev in devs]
        # host mirror of the per-PE cycle counters as of the last slice
        # boundary (installs zero their rows): the per-slice deadline
        # budgets and the dead-step telemetry read it without a sync
        self._cycle_host = np.zeros((b, n), np.int32)

        self._pools = [RectPool(self._super_geom) for _ in range(b)]
        self._free_slots = [set(range(self._n_slots)) for _ in range(b)]
        self._super_mode: list[int | None] = [None] * b
        self._built = True

    def _device_mirrors(self) -> list:
        """The engine's per-lane inputs, one list per argument with an
        entry per shard, uploaded only when an install has changed the
        host arrays since the last slice."""
        if self._mirrors is None:
            self._mirrors = [split_lanes(a, self._devs) for a in (
                self._prog, self._modes, self._geoms, self._sub_ids,
                self._local_ids)]
        return self._mirrors

    def _run_slice(self, budget: np.ndarray) -> tuple:
        """One engine call over every shard: ``(sts, overs, idles,
        ticks)``, each a list with an entry per shard."""
        args = self._device_mirrors() + [self._st,
                                         split_lanes(budget, self._devs)]
        if self._n_dev == 1:
            return tuple([r] for r in self._engine(*(a[0] for a in args)))
        return self._engine(*args)

    # ------------------------------------------------------------------
    # scheduler (single thread; owns all device work)
    # ------------------------------------------------------------------
    def _serve_loop(self) -> None:
        try:
            while True:
                with self._cond:
                    self._cond.wait_for(
                        lambda: self._pending or self._residents
                        or self._closing)
                    if self._abort is not None or (
                            self._closing and not self._pending
                            and not self._residents):
                        break
                self._pump()
        except SchedulerKill:
            # chaos injection: the scheduler thread "dies" mid-slice.
            # Futures, tickets and the resident device state stay
            # intact — submit()/drain()/shutdown() respawn the loop
            # (stats["n_restarts"]) and the resumed slices are
            # bit-exact (the engine's budget slicing carries the
            # machine state itself).
            with self._cond:
                self._killed = True
                self._cond.notify_all()
            return
        except Exception as e:
            # fatal scheduler failure — retry-exhausted transients,
            # poisoned installs, engine failures.  Record it, then fail
            # every unresolved future below: the service stays
            # addressable (submit() raises ServiceError rather than
            # hanging a client on a future nobody will resolve).
            with self._cond:
                self._abort = self._abort or e
                self._cond.notify_all()
        self._fail_unresolved()

    def _ensure_scheduler_locked(self) -> None:
        """Respawn a chaos-killed scheduler thread (caller holds the
        condition lock).  No-op while the thread is alive."""
        if not self._killed:
            return
        self._killed = False
        self.stats["n_restarts"] += 1
        self._thread = threading.Thread(
            target=self._serve_loop, name="sweep-service", daemon=True)
        self._thread.start()

    def _fail_unresolved(self) -> None:
        with self._cond:
            err = self._abort or ServiceError("sweep service stopped")
            tickets = ([r.ticket for r in self._residents.values()]
                       + list(self._pending))
            self._residents.clear()
            self._pending.clear()
            self._closing = True
            for t in tickets:
                if not t.future.done():
                    t.future.set_exception(
                        err if isinstance(err, ServiceError)
                        else ServiceError(str(err)))
            self._cond.notify_all()

    def _fire_hook(self, phase: str) -> None:
        if self._fault_hook is not None:
            self._fault_hook(phase, self)

    def _drain_diagnostics(self) -> str:
        """Timeout message with the state a stuck-drain postmortem needs
        (caller holds the condition lock)."""
        now = time.monotonic()
        tickets = ([r.ticket for r in self._residents.values()]
                   + list(self._pending))
        oldest = max((now - t.t_submit for t in tickets), default=0.0)
        return ("sweep service drain timed out: "
                f"{len(self._pending)} pending lane(s), "
                f"{len(self._residents)} resident lane(s), "
                f"oldest ticket age {oldest:.2f}s, "
                f"refill_occupancy {self.refill_occupancy:.3f}")

    def _slice_budget(self) -> np.ndarray:
        """Per-PE cycle budget for the next slice: the slice length
        everywhere, clamped on deadlined residents to their remaining
        allowance — so a lane freezes EXACTLY at its deadline (the
        cumulative budget it ever receives sums to ``deadline_cycles``,
        and sliced budgets are bit-identical to one unsliced budget)
        while co-tenant rectangles keep full slices."""
        slice_cycles = self._slice_chunks * self._chunk
        budget = np.full(self._sub_ids.shape, slice_cycles, np.int32)
        for r in self._residents.values():
            dl = r.ticket.deadline_cycles
            if dl is None:
                continue
            done = int(self._cycle_host[r.super_idx, r.ids].max())
            budget[r.super_idx, r.ids] = np.int32(
                max(0, min(slice_cycles, dl - done)))
        return budget

    def _pump(self) -> None:
        """One scheduler round: admit+install, run a slice (with
        transient retry), account telemetry, retire, checkpoint."""
        if not self._built:
            with self._cond:
                wls = [t.workload for t in self._pending]
            if not wls:
                return
            self._build_arena(wls)       # first batch sizes the arena
        self._admit()
        if not self._residents:
            return
        # the engine budget is denominated in CYCLES (not chunk
        # iterations): a fast-forwarded slice retires compressed cycles
        # against the same bound a plain slice would, so slicing at b
        # then b' stays bit-identical to one b + b' call either way.
        # Per-PE: deadlined lanes get their remaining allowance.
        budget = self._slice_budget()
        attempt = 0
        while True:
            try:
                self._fire_hook("pre_slice")
            except Exception as e:
                # transient (classified by the RetryPolicy): re-run the
                # slice from the untouched resident state — exact,
                # because nothing was dispatched.  Fatal or
                # retry-exhausted: escalate to _serve_loop, which fails
                # every unresolved future.
                if (not self._retry.transient(e)
                        or attempt >= self._retry.max_retries):
                    raise
                attempt += 1
                self.stats["n_retries"] += 1
                time.sleep(self._retry.delay(attempt))
                continue
            break
        # past this point a failure is fatal: the engine updates the
        # resident state's queues and memory in place
        sts, overs, idles, ticks = self._run_slice(budget)
        self._st = sts
        over = np.concatenate([o.cpu().numpy() for o in overs])
        idle = np.concatenate([i.cpu().numpy() for i in idles])
        cyc = np.concatenate([s.cycle.to("cpu", copy=True).numpy()
                              for s in sts])
        t_np = np.concatenate([t.cpu().numpy() for t in ticks])
        self.stats["n_slices"] += 1
        self.stats["engine_ticks"] += int(t_np.max(initial=0))
        b, n = self._sub_ids.shape
        self.stats["occupancy_sum"] += (
            sum(p.used_area() for p in self._pools) / float(b * n))
        # dead-step telemetry (the service-side mirror of run_many's):
        # wall PE-steps actually executed vs what the plain engine would
        # run to retire this slice's cycle deltas, per device shard.
        per_dev = b // self._n_dev
        stepped = plain = 0
        for g0 in range(0, b, per_dev):
            g = slice(g0, g0 + per_dev)
            want = int((cyc[g] - self._cycle_host[g]).max(initial=0))
            stepped += int(t_np[g0]) * per_dev * n
            plain += -(-want // self._chunk) * self._chunk * per_dev * n
        self.stats["stepped_pe_ticks"] += stepped
        self.stats["plain_pe_ticks"] += plain
        self._cycle_host = cyc
        self._fire_hook("post_slice")
        if over.any():
            bad = np.nonzero(over)[0].tolist()
            with self._cond:
                self._abort = ServiceError(
                    "pending-FIFO overflow: consumption guarantee violated "
                    f"(simulator invariant; super-lanes {bad})")
                self._cond.notify_all()
            return
        self._retire(idle, cyc)
        self._maybe_checkpoint()

    def _admit(self) -> None:
        """Place pending lanes into free rectangles, longest first, and
        install them (plus any scrub-pending rows) in ONE device update.
        Pending lanes whose wall-clock deadline already expired fail here
        without ever touching the fabric."""
        now = time.monotonic()
        with self._cond:
            pending = sorted(self._pending, key=lambda t: (-t.load, t.seq))
        placed: list[_Resident] = []
        for t in pending:
            if (t.deadline_s is not None
                    and now - t.t_submit >= t.deadline_s):
                t.future.set_exception(DeadlineError(
                    f"lane seq={t.seq} exceeded deadline_s={t.deadline_s} "
                    "while waiting for admission",
                    telemetry=self.telemetry))
                self.stats["n_deadline_failures"] += 1
                with self._cond:
                    self._pending.remove(t)
                    self._cond.notify_all()
                continue
            try:
                self._check_fits(t.workload, t.workload.geom)
            except CapacityError as e:
                # resolve before unqueueing, for the same drain()
                # ordering reason as _retire
                t.future.set_exception(e)
                with self._cond:
                    self._pending.remove(t)
                    self._cond.notify_all()
                continue
            # candidate supers: same mode, or empty (which adopts the
            # mode); least-loaded first so the supers stay balanced
            cands = sorted(
                (s for s in range(self._n_supers)
                 if self._free_slots[s]
                 and (self._super_mode[s] in (None, t.mode))),
                key=lambda s: (self._pools[s].used_area(), s))
            for s in cands:
                origin = self._pools[s].alloc(t.workload.geom)
                if origin is None:
                    continue
                slot = min(self._free_slots[s])
                self._free_slots[s].discard(slot)
                self._super_mode[s] = t.mode
                geom = (int(t.workload.geom[0]), int(t.workload.geom[1]))
                sub = SubLane(lane=0, super_lane=s, origin=origin,
                              geom=geom)
                placed.append(_Resident(
                    ticket=t, super_idx=s, slot=slot, origin=origin,
                    geom=geom, ids=sub.pe_ids(self._super_geom[0])))
                break
        if not placed and not self._scrub:
            return
        with self._cond:
            for r in placed:
                self._pending.remove(r.ticket)
                self._residents[(r.super_idx, r.slot)] = r
        self._install_lanes(placed)

    def _install_lanes(self, placed: list[_Resident]) -> None:
        # fault hook: a poisoned install is FATAL by design — placement
        # bookkeeping is already committed, so the escalation path
        # (_serve_loop -> _fail_unresolved) is the only consistent exit
        self._fire_hook("install")
        b = self._n_supers
        sw, _ = self._super_geom
        n = self._sub_ids.shape[1]
        mask = np.zeros((b, n), bool)
        new = dict(
            amq=np.zeros((b, n, self._q_cap, self._st[0].amq.shape[-1]),
                         np.int32),
            amq_len=np.zeros((b, n), np.int32),
            mem_val=np.zeros((b, n, self._m_cap), np.int32),
            mem_meta=np.zeros((b, n, self._m_cap, 2), np.int32))
        for s, ids in self._scrub:
            mask[s, ids] = True           # zero-reset a capped tenant's
        self._scrub.clear()               # rows before any slot reuse
        refill = self.stats["n_slices"] > 0
        for r in placed:
            wl = r.ticket.workload
            s, ids = r.super_idx, r.ids
            off = r.slot * self._p_slot
            sub = SubLane(lane=0, super_lane=s, origin=r.origin,
                          geom=r.geom)
            a, al, v, mt = _rebase_into_super(wl, sub, sw, n, off)
            mask[s, ids] = True
            new["amq"][s, ids, :a.shape[1]] = a[ids]
            new["amq_len"][s, ids] = al[ids]
            new["mem_val"][s, ids, :v.shape[1]] = v[ids]
            new["mem_meta"][s, ids, :mt.shape[1]] = mt[ids]
            p = np.array(wl.prog, np.int32, copy=True)
            p[:, C_NEXT_PC] += off
            self._prog[s, off:off + self._p_slot] = 0
            self._prog[s, off:off + p.shape[0]] = p
            self._sub_ids[s, ids] = r.slot
            self._local_ids[s, ids] = np.arange(len(ids), dtype=np.int32)
            self._modes[s] = r.ticket.mode
            self._cycle_host[s, ids] = 0    # fresh install: cycle == 0
            self.stats["n_installs"] += 1
            self.stats["n_refills"] += int(refill)
        self._mirrors = None
        # masked per-row reset to the exact init_state image plus the new
        # lane's compiler outputs; rows outside the mask keep their bits,
        # so co-tenants cannot observe an install.  The new arrays are
        # copied onto each shard's device (the engine later updates
        # mem_val in place, which must never reach a client's workload
        # arrays); a shard with no masked row keeps its state.
        for s, (g, dev) in enumerate(zip(self._groups, self._devs)):
            if not mask[g].any():
                continue
            m = torch.tensor(mask[g], device=dev)
            leaves = {}
            for name in MachineState._fields:
                old = getattr(self._st[s], name)
                mk = m.reshape(m.shape + (1,) * (old.ndim - 2))
                if name in _PUT_LEAVES:
                    put = torch.tensor(new[name][g], device=dev)
                    leaves[name] = torch.where(mk, put, old)
                else:
                    leaves[name] = old.masked_fill(mk, 0)
            self._st[s] = MachineState(**leaves)

    def _retire(self, idle: np.ndarray, cycle: np.ndarray) -> None:
        """Resolve every resident whose sub-lane went idle, hit the
        cycle cap, or exhausted its deadline, and free its rectangle
        for the next admission."""
        now = time.monotonic()
        done_now = []
        for key, r in self._residents.items():
            t = r.ticket
            cyc = int(cycle[r.super_idx][r.ids].max())
            if bool(idle[r.super_idx, r.ids[0]]):
                status = "done"
            elif cyc >= self._cfg.max_cycles:
                status = "capped"
            elif t.deadline_cycles is not None and cyc >= t.deadline_cycles:
                status = "deadline"
            elif (t.deadline_s is not None
                  and now - t.t_submit >= t.deadline_s):
                status = "wall"
            else:
                continue
            done_now.append((key, r, status))
        if not done_now:
            return
        # the result-bearing leaves (memory image included) only cross to
        # host when something actually retires, as copies that the next
        # slice cannot overwrite
        host = gather_host(self._st)
        # resolve the futures BEFORE removing the residents: drain()
        # unblocks on empty pending+residents, and must never observe an
        # "all drained" state while a result is still unset.
        for key, r, status in done_now:
            self._pools[r.super_idx].release(r.origin, r.geom)
            self._free_slots[r.super_idx].add(r.slot)
            if status != "done":
                # a capped/deadlined lane's rows still hold in-flight
                # garbage; zero them before the rectangle (or slot) is
                # reused
                self._scrub.append((r.super_idx, r.ids))
            self.stats["n_retired"] += 1
            res = _pe_slice_result(host, status == "done",
                                   r.super_idx, r.ids)
            if status in ("deadline", "wall"):
                t = r.ticket
                self.stats["n_deadline_failures"] += 1
                what = (f"deadline_cycles={t.deadline_cycles}"
                        if status == "deadline"
                        else f"deadline_s={t.deadline_s}")
                t.future.set_exception(DeadlineError(
                    f"lane seq={t.seq} exceeded its {what} "
                    f"(frozen at cycle {res.cycles}, "
                    f"executed={res.executed}, injected={res.injected}); "
                    "co-tenant lanes were unaffected",
                    result=res, telemetry=self.telemetry))
            else:
                r.ticket.future.set_result(res)
        with self._cond:
            for key, r, _ in done_now:
                del self._residents[key]
            for s in {r.super_idx for _, r, _ in done_now}:
                if not self._residents_in(s):
                    self._super_mode[s] = None
            self._cond.notify_all()

    def _residents_in(self, s: int) -> bool:
        return any(k[0] == s for k in self._residents)

    # ------------------------------------------------------------------
    # checkpoint / restore
    # ------------------------------------------------------------------
    def _maybe_checkpoint(self) -> None:
        if self._ckpt is None or not self._built:
            return
        if self.stats["n_slices"] % self._ckpt_every:
            return
        with self._cond:
            if not self._pending and not self._residents:
                return        # nothing in flight, nothing worth resuming
            tree, extra = self._snapshot_locked()
        # async write: the host snapshot (a copy of every leaf) happens
        # synchronously here on the scheduler thread — consistent with
        # the slice boundary — and the .npy I/O overlaps the next slice
        self._ckpt.save(self._ckpt_step, tree, extra=extra, blocking=False)
        self._ckpt_step += 1
        self.stats["n_checkpoints"] += 1

    def _whole_state(self) -> MachineState:
        """The resident state of every super-lane as one
        ``MachineState``: the one shard's own tensors, or the shards'
        concatenated on the host in shard order (a copy)."""
        if self._n_dev == 1:
            return self._st[0]
        return MachineState(*(
            torch.cat([getattr(st, f).cpu() for st in self._st])
            for f in MachineState._fields))

    def _wl_arrays(self, wl) -> dict:
        out = {}
        for f in _WL_FIELDS:
            v = getattr(wl, f, None)
            if v is not None:
                out[f] = np.asarray(v)
        return out

    def _snapshot_locked(self):
        """Full in-flight state as (tree of arrays, JSON extra) — caller
        holds the condition lock, at a slice boundary.  The tree's keys,
        structure and ``extra`` are the reference's."""
        tree = {
            "st": self._whole_state(),
            "prog": self._prog.copy(), "modes": self._modes.copy(),
            "geoms": self._geoms.copy(), "sub_ids": self._sub_ids.copy(),
            "local_ids": self._local_ids.copy(),
        }
        pending = list(self._pending)
        for i, t in enumerate(pending):
            for f, v in self._wl_arrays(t.workload).items():
                tree[f"pend_{i:04d}_{f}"] = v
        now = time.monotonic()

        def tmeta(t: _Ticket) -> dict:
            return dict(
                seq=int(t.seq), mode=int(t.mode), load=float(t.load),
                deadline_cycles=(None if t.deadline_cycles is None
                                 else int(t.deadline_cycles)),
                deadline_s_left=(None if t.deadline_s is None
                                 else max(1e-9, t.deadline_s
                                          - (now - t.t_submit))))

        extra = dict(
            format=1,
            arena=dict(super_geom=list(self._super_geom),
                       n_supers=self._n_supers, n_slots=self._n_slots,
                       p_slot=self._p_slot, q_cap=self._q_cap,
                       m_cap=self._m_cap,
                       msg_f=int(self._st[0].amq.shape[-1]),
                       cfg_f=int(self._prog.shape[-1]),
                       chunk=self._chunk,
                       slice_chunks=self._slice_chunks,
                       shard=self._shard),
            seq=int(self._seq),
            stats={k: (float(v) if isinstance(v, float) else int(v))
                   for k, v in self.stats.items()},
            pools=[dict(free=[list(map(int, r)) for r in p.free],
                        allocated=[[int(x), int(y), int(w), int(h)]
                                   for (x, y), (w, h)
                                   in p._allocated.items()])
                   for p in self._pools],
            free_slots=[sorted(int(x) for x in s)
                        for s in self._free_slots],
            super_mode=[None if m is None else int(m)
                        for m in self._super_mode],
            scrub=[[int(s), np.asarray(ids).tolist()]
                   for s, ids in self._scrub],
            residents=[dict(tmeta(r.ticket), super_idx=int(r.super_idx),
                            slot=int(r.slot),
                            origin=[int(r.origin[0]), int(r.origin[1])],
                            geom=[int(r.geom[0]), int(r.geom[1])])
                       for r in self._residents.values()],
            pending=[dict(tmeta(t),
                          geom=[int(t.workload.geom[0]),
                                int(t.workload.geom[1])],
                          name=getattr(t.workload, "name", None),
                          shapes={f: [list(v.shape), str(v.dtype)]
                                  for f, v
                                  in self._wl_arrays(t.workload).items()})
                     for t in pending],
        )
        return tree, extra

    @classmethod
    def restore(cls, cfg: MachineConfig, root: str, *,
                step: int | None = None,
                fault_hook=None, retry: RetryPolicy | None = None,
                checkpoint_root: str | None = None,
                checkpoint_every: int = 8, checkpoint_keep: int = 3,
                device="cuda", devices=None) -> "SweepService":
        """Resume a checkpointed service after a process death, on
        ``device`` (a sharded one over ``devices``, split as the
        constructor splits it, whatever split wrote the checkpoint).

        Rebuilds the arena for the exact checkpointed shapes, reloads
        the packed super-lane ``MachineState``, program arena, RectPool
        bookkeeping and the resident + pending ticket queue, and hands
        out FRESH futures (:attr:`futures`, keyed by submission seq).
        In-flight lanes continue bit-for-bit: the engine's budget
        slicing makes "resume from the saved state" exactly the run the
        dead process would have finished.  ``cfg`` must be the config
        the original service ran (it keys the engine).  The checkpoint
        may have been written by this package's service or by the
        reference's: the layout is the same.

        Pass ``checkpoint_root`` (usually the same ``root``) to keep
        checkpointing from the restored service onwards.
        """
        import json
        import os

        from repro_torch.checkpoint.store import latest_step
        if step is None:
            step = latest_step(root)
            if step is None:
                raise FileNotFoundError(
                    f"no complete checkpoint under {root}")
        with open(os.path.join(root, f"step_{step:08d}",
                               "tree.json")) as f:
            extra = json.load(f).get("extra", {})
        if extra.get("format") != 1:
            raise ValueError(f"checkpoint under {root} (step {step}) is "
                             "not a SweepService snapshot")
        ar = extra["arena"]
        svc = cls(cfg, super_geom=tuple(ar["super_geom"]),
                  n_supers=int(ar["n_supers"]),
                  slots_per_super=int(ar["n_slots"]),
                  chunk=int(ar["chunk"]),
                  slice_chunks=int(ar["slice_chunks"]),
                  shard=bool(ar["shard"]),
                  fault_hook=fault_hook, retry=retry,
                  checkpoint_root=checkpoint_root,
                  checkpoint_every=checkpoint_every,
                  checkpoint_keep=checkpoint_keep, device=device,
                  devices=devices)
        try:
            svc._restore_from(root, step, extra)
        except BaseException:
            svc.shutdown(wait=False)
            raise
        return svc

    def _restore_from(self, root: str, step: int, extra: dict) -> None:
        from repro_torch.checkpoint.store import restore_checkpoint
        ar = extra["arena"]
        self._setup_arena(tuple(ar["super_geom"]), int(ar["p_slot"]),
                          int(ar["n_slots"]), int(ar["q_cap"]),
                          int(ar["m_cap"]), int(ar["msg_f"]),
                          int(ar["cfg_f"]))
        tree_like = {
            "st": self._whole_state(),
            "prog": self._prog, "modes": self._modes,
            "geoms": self._geoms, "sub_ids": self._sub_ids,
            "local_ids": self._local_ids,
        }
        for i, p in enumerate(extra["pending"]):
            for f, (shape, _) in p["shapes"].items():
                tree_like[f"pend_{i:04d}_{f}"] = np.zeros(shape, np.int32)
        # one device: restored onto it; several: onto the host, then
        # each shard's rows copied onto its device
        tree, _, _ = restore_checkpoint(
            root, tree_like, step=step,
            device=self._devs[0] if self._n_dev == 1 else "cpu")

        def host(name) -> np.ndarray:
            return tree[name].cpu().numpy().astype(np.int32)

        now = time.monotonic()

        def ticket(meta: dict, wl) -> _Ticket:
            return _Ticket(
                workload=wl, mode=int(meta["mode"]),
                load=float(meta["load"]), seq=int(meta["seq"]),
                future=Future(),
                deadline_cycles=meta.get("deadline_cycles"),
                deadline_s=meta.get("deadline_s_left"),
                t_submit=now)

        with self._cond:
            if self._n_dev == 1:
                self._st = [tree["st"]]
            else:
                self._st = [MachineState(*(
                    getattr(tree["st"], f)[g].to(dev, copy=True)
                    for f in MachineState._fields))
                    for g, dev in zip(self._groups, self._devs)]
            # writable host copies: installs update these in place
            self._prog = host("prog")
            self._modes = host("modes")
            self._geoms = host("geoms")
            self._sub_ids = host("sub_ids")
            self._local_ids = host("local_ids")
            self._mirrors = None
            self._cycle_host = np.concatenate(
                [st.cycle.to("cpu", copy=True).numpy() for st in self._st])
            self._seq = int(extra["seq"])
            for k, v in extra.get("stats", {}).items():
                if k in self.stats:
                    self.stats[k] = v
            sw, _ = self._super_geom
            for s, rec in enumerate(extra["pools"]):
                pool = RectPool(self._super_geom)
                pool.free = [tuple(r) for r in rec["free"]]
                pool._allocated = {(x, y): (w, h)
                                   for x, y, w, h in rec["allocated"]}
                self._pools[s] = pool
            self._free_slots = [set(fs) for fs in extra["free_slots"]]
            self._super_mode = [None if m is None else int(m)
                                for m in extra["super_mode"]]
            self._scrub = [(int(s), np.asarray(ids, np.int64))
                           for s, ids in extra["scrub"]]
            for meta in extra["residents"]:
                origin = (int(meta["origin"][0]), int(meta["origin"][1]))
                geom = (int(meta["geom"][0]), int(meta["geom"][1]))
                sub = SubLane(lane=0, super_lane=int(meta["super_idx"]),
                              origin=origin, geom=geom)
                r = _Resident(ticket=ticket(meta, None),
                              super_idx=int(meta["super_idx"]),
                              slot=int(meta["slot"]), origin=origin,
                              geom=geom, ids=sub.pe_ids(sw))
                self._residents[(r.super_idx, r.slot)] = r
            for i, meta in enumerate(extra["pending"]):
                arrs = {f: host(f"pend_{i:04d}_{f}")
                        for f in meta["shapes"]}
                wl = _RestoredWorkload(
                    prog=arrs["prog"], static_ams=arrs["static_ams"],
                    amq_len=arrs["amq_len"], mem_val=arrs["mem_val"],
                    mem_meta=arrs["mem_meta"],
                    geom=(int(meta["geom"][0]), int(meta["geom"][1])),
                    name=meta.get("name"),
                    meta_pe=(None if "meta_pe" not in arrs else
                             tree[f"pend_{i:04d}_meta_pe"].cpu().numpy()))
                self._pending.append(ticket(meta, wl))
            self._cond.notify_all()
