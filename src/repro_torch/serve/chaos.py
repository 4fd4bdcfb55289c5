"""Deterministic chaos harness for the resident sweep service — a port of
the reference's ``repro.serve.chaos``.

Resilience claims are only claims until something actually kills the
scheduler mid-slice.  This module makes that reproducible:

* :class:`FaultSchedule` — a seeded, deterministic fault plan that plugs
  into ``SweepService(fault_hook=...)``.  It counts hook CALLS per phase
  (not slice indices), so a retried slice moves *past* a scheduled
  transient instead of re-hitting it forever, and injects:

  - ``"transient"`` — a :class:`~repro_torch.serve.fabric.TransientFault` at
    ``"pre_slice"`` (before any device dispatch: the retry is exact);
  - ``"kill"`` — a :class:`~repro_torch.serve.fabric.SchedulerKill` at
    ``"post_slice"`` (after the slice state is committed: the scheduler
    thread dies, device state and futures survive, the next
    ``drain``/``submit`` restarts it);
  - ``"fatal"`` — a plain :class:`RuntimeError` anywhere (never retried
    by the default policy; at ``"install"`` this is the poisoned-install
    scenario: every unresolved future fails with ``ServiceError``).

* :func:`run_soak` — the standard oversubscribed soak: submit a lane
  grid in seeded-permuted order (with optional duplicate submissions and
  inter-submit delays — the client-side chaos), optionally give one lane
  a cycle deadline, drain through every injected kill/restart, and
  return per-lane outcomes plus the service's stats and telemetry.

The soak's acceptance invariant (pinned by ``tests/test_torch_chaos.py``
against the reference, and gated on the card by
``repro_torch.bench.chaos_soak``): every surviving lane's
:class:`~repro_torch.core.machine.RunResult` is bit-identical to a
one-shot ``run_many`` of the same lanes, the deadline lane fails only its
own future, and a :meth:`SweepService.restore` from a mid-soak checkpoint
reproduces the same final results bit-for-bit.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch.serve.fabric import (DeadlineError, SchedulerKill,
                                      SweepService, TransientFault)

_KINDS = ("transient", "kill", "fatal")


class FaultSchedule:
    """Deterministic fault plan, usable as a ``SweepService`` fault hook.

    ``faults`` maps a hook phase (``"install"`` / ``"pre_slice"`` /
    ``"post_slice"``) to ``{call_index: kind}`` where kind is one of
    ``"transient"``, ``"kill"``, ``"fatal"``.  Call indices count how
    many times the service has fired that phase's hook (0-based) — a
    deterministic clock that advances through retries and restarts, so
    the same schedule replays the same faults run after run.

    ``fired`` logs every injected fault as ``(phase, call_index, kind)``;
    ``calls`` exposes the per-phase hook-call counters.  Instances are
    thread-compatible with the service's single scheduler thread (the
    only caller); construct a fresh schedule per service.
    """

    def __init__(self, faults: dict[str, dict[int, str]] | None = None):
        self.faults = {p: dict(m) for p, m in (faults or {}).items()}
        for p, m in self.faults.items():
            for i, kind in m.items():
                if kind not in _KINDS:
                    raise ValueError(f"fault {p}#{i}: unknown kind "
                                     f"{kind!r} (expected one of {_KINDS})")
        self.calls: dict[str, int] = {}
        self.fired: list[tuple[str, int, str]] = []

    def __call__(self, phase: str, service: SweepService) -> None:
        i = self.calls.get(phase, 0)
        self.calls[phase] = i + 1
        kind = self.faults.get(phase, {}).get(i)
        if kind is None:
            return
        self.fired.append((phase, i, kind))
        if kind == "transient":
            raise TransientFault(f"injected transient fault at {phase}#{i}")
        if kind == "kill":
            raise SchedulerKill(f"injected scheduler kill at {phase}#{i}")
        raise RuntimeError(f"injected fatal fault at {phase}#{i}")

    @classmethod
    def seeded(cls, seed: int, *, n_transients: int = 2, n_kills: int = 1,
               horizon: int = 24) -> "FaultSchedule":
        """A random-but-reproducible schedule over the first ``horizon``
        hook calls: ``n_transients`` pre-slice transients (retried and
        recovered) and ``n_kills`` post-slice scheduler kills (restarted
        by the next drain/submit).  Same seed, same schedule."""
        if n_transients + n_kills > horizon:
            raise ValueError("more faults than the horizon holds")
        rng = np.random.default_rng(seed)
        faults: dict[str, dict[int, str]] = {"pre_slice": {},
                                             "post_slice": {}}
        for i in rng.choice(horizon, size=n_transients, replace=False):
            faults["pre_slice"][int(i)] = "transient"
        for i in rng.choice(horizon, size=n_kills, replace=False):
            faults["post_slice"][int(i)] = "kill"
        return cls(faults)


@dataclasses.dataclass
class SoakReport:
    """Outcome of one :func:`run_soak`.

    ``results[i]`` is lane *i*'s :class:`RunResult`, or the exception
    that failed its future (``DeadlineError`` for the deadline lane).
    ``duplicate_results`` maps a lane index to its duplicate
    submission's outcome — bit-identity between the two is part of the
    determinism claim.  ``fired`` is the schedule's injected-fault log,
    ``stats`` / ``telemetry`` the service's counters at drain time.
    ``seq_lane`` maps the service's submission sequence numbers back to
    lane indices (submission order is seeded-permuted and duplicates
    interleave) — the key for checking a restored service's
    :attr:`SweepService.futures` against the reference.
    """
    results: list
    duplicate_results: dict[int, object]
    fired: list[tuple[str, int, str]]
    stats: dict
    telemetry: object
    seq_lane: dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def survivors(self) -> dict[int, object]:
        """Lanes that completed with a result (index -> RunResult)."""
        return {i: r for i, r in enumerate(self.results)
                if not isinstance(r, BaseException)}

    @property
    def deadline_failures(self) -> dict[int, DeadlineError]:
        return {i: r for i, r in enumerate(self.results)
                if isinstance(r, DeadlineError)}


def _outcome(future, timeout: float):
    try:
        return future.result(timeout=timeout)
    except BaseException as e:           # noqa: BLE001 — outcomes, not flow
        return e


def run_soak(cfg, workloads, *, modes=None, seed: int = 0,
             schedule: FaultSchedule | None = None,
             deadline_lane: int | None = None,
             deadline_cycles: int | None = None,
             duplicates: int = 0, submit_delay_s: float = 0.0,
             timeout: float = 600.0,
             service_kwargs: dict | None = None, device="cuda"
             ) -> tuple[SoakReport, SweepService]:
    """Run one seeded chaos soak and collect every lane's outcome.

    Submits ``workloads`` in a seeded-permuted order (client-side chaos:
    arrival order decorrelated from lane order, optional
    ``submit_delay_s`` jitter between submissions, ``duplicates``
    re-submissions of seeded-chosen lanes), with ``schedule`` (default:
    :meth:`FaultSchedule.seeded` from the same seed) injecting scheduler
    faults, and ``deadline_lane`` (if given) submitted with
    ``deadline_cycles``.  Drains through any injected kill — ``drain``
    restarts the scheduler — and returns the :class:`SoakReport` plus
    the still-running service (caller shuts it down; keeping it alive
    lets tests checkpoint-restore against it).  The service runs on
    ``device``.
    """
    wls = list(workloads)
    ms = [None] * len(wls) if modes is None else list(modes)
    if len(ms) != len(wls):
        raise ValueError(f"{len(ms)} modes for {len(wls)} workloads")
    rng = np.random.default_rng(seed)
    if schedule is None:
        schedule = FaultSchedule.seeded(seed)
    svc = SweepService(cfg, fault_hook=schedule, device=device,
                       **(service_kwargs or {}))
    order = rng.permutation(len(wls))
    dup_lanes = set(
        int(i) for i in rng.choice(len(wls),
                                   size=min(duplicates, len(wls)),
                                   replace=False)) if duplicates else set()
    futures: list = [None] * len(wls)
    dup_futures: dict[int, object] = {}
    seq_lane: dict[int, int] = {}
    try:
        for k, i in enumerate(int(x) for x in order):
            dl = (deadline_cycles if deadline_lane is not None
                  and i == deadline_lane else None)
            seq_lane[len(seq_lane)] = i
            futures[i] = svc.submit(wls[i], mode=ms[i], deadline_cycles=dl)
            if i in dup_lanes and i != deadline_lane:
                seq_lane[len(seq_lane)] = i
                dup_futures[i] = svc.submit(wls[i], mode=ms[i])
            if submit_delay_s and k + 1 < len(order):
                time.sleep(submit_delay_s)
        svc.drain(timeout=timeout)
    except BaseException:
        svc.shutdown(wait=False)
        raise
    report = SoakReport(
        results=[_outcome(f, timeout) for f in futures],
        duplicate_results={i: _outcome(f, timeout)
                           for i, f in dup_futures.items()},
        fired=list(schedule.fired),
        stats=dict(svc.stats),
        telemetry=svc.telemetry,
        seq_lane=seq_lane)
    return report, svc


def results_bit_identical(a, b) -> bool:
    """True iff two lane results are bit-identical: every ``to_json``
    metric equal AND the full result memory image equal (``to_json``
    omits ``mem_val`` by design)."""
    return (a.to_json() == b.to_json()
            and np.array_equal(np.asarray(a.mem_val),
                               np.asarray(b.mem_val)))


class BlockingHook:
    """A fault hook that parks the scheduler at a phase until released.

    For tests that need the service provably mid-flight (e.g. pinning
    ``drain(timeout=...)``'s diagnostic payload): the scheduler blocks
    at the first ``phase`` call until :meth:`release`.  Composes with
    nothing — use it alone.
    """

    def __init__(self, phase: str = "pre_slice"):
        self.phase = phase
        self.entered = threading.Event()
        self._release = threading.Event()

    def __call__(self, phase: str, service: SweepService) -> None:
        if phase == self.phase and not self._release.is_set():
            self.entered.set()
            self._release.wait()

    def release(self) -> None:
        self._release.set()
