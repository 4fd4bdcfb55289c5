"""Serving substrate.

* :mod:`repro_torch.serve.fabric` — the resident :class:`SweepService`:
  continuous-batching fabric simulation on the one cached engine
  (submit compiled workloads, get per-lane result futures, mid-wave
  refill of retired sub-lane rectangles).
* :mod:`repro_torch.serve.chaos` — deterministic fault injection for the
  service (seeded kill/restart + transient schedules, the soak driver).
* :mod:`repro_torch.serve.steps` — LLM prefill / decode steps (imported
  lazily: the fabric service must not pull the model stack in).
"""
from repro_torch.serve.chaos import FaultSchedule, run_soak  # noqa: F401
from repro_torch.serve.fabric import (  # noqa: F401
    CapacityError, DeadlineError, RetryPolicy, SchedulerKill, ServiceError,
    SweepService, TransientFault,
)

_STEP_NAMES = ("make_decode_step", "make_prefill_step")


def __getattr__(name):
    if name in _STEP_NAMES:
        from repro_torch.serve import steps
        return getattr(steps, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_STEP_NAMES))
